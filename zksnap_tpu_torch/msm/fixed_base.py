"""Fixed-base MSM with per-window shifted-point tables (PyTorch port of
zksnap_tpu/msm/fixed_base.py).

For a fixed point set (an SRS basis) precompute once, per window width c,

    T[w*n + i] = 2^(c*w) * P_i        for every window w,

so a commit needs no doubling ladder and all windows share one signed
bucket space of B = 2^(c-1) buckets: one segmented bucket accumulation
(kernel K4) over the W*n (point, digit) pairs and one weighted reduction.
"""

from __future__ import annotations

import torch

from ..curves.jacobian import CurveOps, JacPoint
from .pippenger import _segmented_bucket_sums, _weighted_bucket_reduce, signed_digits


class FixedBaseTable:
    """Precomputed shifted-point table for one fixed point set."""

    def __init__(self, x, y, z, n: int, c: int, n_windows: int):
        self.x, self.y, self.z = x, y, z   # [W*n, 16] affine-or-id rows
        self.n = n
        self.c = c
        self.n_windows = n_windows


def build_table(pts: JacPoint, n: int, c: int) -> FixedBaseTable:
    """pts: affine-or-identity rows (z in {0,1}), e.g. an SRS basis.

    One-time cost: (W-1)*c batched projective doublings (kernel K3) and
    one batch inversion.  Identity rows are the valid RCB identity
    (0, 1, 0): pmadd passes P through for them (z == 0), and a bucket
    segment that starts with one restarts from a valid point.  The JAX
    table encodes them (0, 0, 0), which the RCB formulas keep at
    (0 : 0 : 0) through every later add of the segment; an SRS basis
    holds no identity, so its commits agree."""
    from ..curves.proj import bn254_proj_ops

    ops = bn254_proj_ops()
    Fq = ops.F
    n_windows = -(-254 // c)
    assert n_windows * c > 254, "signed digits need top-window slack"
    cur = JacPoint(pts.x[:n], pts.y[:n], pts.z[:n])
    rows = []
    for w in range(n_windows):
        rows.append(cur)
        if w + 1 < n_windows:
            for _ in range(c):
                cur = ops.double(cur)
    X = torch.cat([r.x for r in rows])
    Y = torch.cat([r.y for r in rows])
    Z = torch.cat([r.z for r in rows])
    # projective normalise: (x/z, y/z, 1), identity (z == 0) -> (0, 1, 0)
    zero = (Z == 0).all(dim=-1, keepdim=True)
    one = Fq.one_t(Z.device).expand(Z.shape)
    zinv = Fq.batch_inv(torch.where(zero, one, Z))
    ax = torch.where(zero, 0, Fq.mul(X, zinv))
    ay = torch.where(zero, one, Fq.mul(Y, zinv))
    az = torch.where(zero, 0, one)
    return FixedBaseTable(ax, ay, az, n, c, n_windows)


# (point, digit) pairs per bucket accumulation: larger tables go through
# it in groups of windows, whose bucket tables are then added
PAIR_GROUP = 1 << 22


def msm_fixed_impl(ops: CurveOps, table: FixedBaseTable, scalars):
    """MSM over a precomputed table -> JacPoint (projective coordinates).

    scalars: [n, 16] canonical limbs.  All windows share one signed
    bucket space; per-group bucket tables are group-added, then one
    weighted reduction finishes."""
    n, c, W = table.n, table.c, table.n_windows
    B = 1 << (c - 1)
    digits = signed_digits(scalars, c, W)            # [W, n]
    ids = torch.where(digits == 0, B, digits.abs() - 1).reshape(-1)
    neg = (digits < 0).reshape(-1)
    py = torch.where(neg[:, None], ops.F.neg(table.y), table.y)

    if W * n <= PAIR_GROUP:
        buckets = _segmented_bucket_sums(
            ops, JacPoint(table.x, py, table.z), ids, B)
    else:
        wg = max(1, PAIR_GROUP // n)
        buckets = None
        for w0 in range(0, W, wg):
            w1 = min(w0 + wg, W)
            sl = slice(w0 * n, w1 * n)
            part = _segmented_bucket_sums(
                ops, JacPoint(table.x[sl], py[sl], table.z[sl]),
                ids[sl], B)
            buckets = part if buckets is None else ops.add(buckets, part)

    b3 = JacPoint(buckets.x[None], buckets.y[None], buckets.z[None])
    w = _weighted_bucket_reduce(ops, b3, c - 1, plus_one=True)  # [1, 16]
    return JacPoint(w.x[0], w.y[0], w.z[0])


def commit_fixed(table: FixedBaseTable, scalars) -> JacPoint:
    """KZG commit over a precomputed fixed-base table; returns Jacobian
    (X*Z, Y*Z^2, Z), the contract of poly_device.commit_evals."""
    from ..curves.proj import bn254_proj_ops

    ops = bn254_proj_ops()
    Fq = ops.F
    r = msm_fixed_impl(ops, table, scalars)
    return JacPoint(Fq.mul(r.x, r.z), Fq.mul(r.y, Fq.square(r.z)), r.z)

