"""Pippenger multi-scalar multiplication (PyTorch port of
zksnap_tpu/msm/pippenger.py).

Same algorithm as the JAX package: signed window digits, composite bucket
ids (window << c | digit) for all windows at once, a stable sort by
bucket, the segmented bucket scan over M lanes of K steps (kernel K4),
a log2(M) lane-carry scan for segments that cross lanes, a gather of the
segment tails, the split weighted bucket reduction, and a masked doubling
ladder that combines the windows.  Every group operation is a launch of
kernel K3 (curves/fused.py) on a CUDA tensor.

With ZKSNAP_TPU_FUSED_REDUCE=1 in the environment (the JAX package's own
switch, off by default), a projective MSM takes the fused post-scan
stage instead: one double-suffix kernel (K5) for the weighted bucket
reduction and one ladder-and-tree kernel (K6) for the window combine.
"""

from __future__ import annotations

import functools
import os

import torch

from ..curves.fused import bucket_scan, ladder_tree, weighted_suffix
from ..curves.jacobian import CurveOps, JacPoint
from ..fields.common import N_LIMBS

# Bucket-scan lane count on a CUDA device: one thread per lane, and
# 32768 lanes are ~250 blocks of 128 threads, about two per SM of an
# H100's 132.  On the CPU the plain scan is a Python loop over K steps of
# width-M ops, so a short loop over lanes of width ~sqrt(n) costs least.
CUDA_LANES = 1 << 15


def default_lanes(n: int, device) -> int:
    if torch.device(device).type == "cuda":
        return min(n, CUDA_LANES)
    return min(n, max(64, 1 << ((n.bit_length() + 1) // 2)))


def window_digits(scalars, c: int, w: int):
    """scalars: [n, 16] canonical limbs; returns [n] int64 digits of
    window w (bits [c*w, c*w+c))."""
    assert c <= 16
    start = c * w
    l0, off = start // 16, start % 16
    s = scalars.to(torch.int64)
    padded = torch.cat([s, torch.zeros_like(s[..., :1])], dim=-1)
    lo = padded[..., l0] >> off
    if off > 0:  # the digit spans the limb boundary
        lo = lo | (padded[..., l0 + 1] << (16 - off))
    return lo & ((1 << c) - 1)


def signed_digits(scalars, c: int, n_windows: int):
    """[W, n] balanced signed digits in [-(2^(c-1)-1), 2^(c-1)]: an
    unsigned window digit > 2^(c-1) becomes d - 2^c with a carry into the
    next window.  The top carry is zero when n_windows*c > scalar bits."""
    half, full = 1 << (c - 1), 1 << c
    carry = torch.zeros(scalars.shape[:-1], dtype=torch.int64,
                        device=scalars.device)
    out = []
    for w in range(n_windows):
        d = window_digits(scalars, c, w) + carry
        over = d > half
        carry = over.to(torch.int64)
        out.append(torch.where(over, d - full, d))
    return torch.stack(out)


def _take(p: JacPoint, axis: int, lo: int, hi: int) -> JacPoint:
    sl = [slice(None)] * p.x.ndim
    sl[axis] = slice(lo, hi)
    sl = tuple(sl)
    return JacPoint(p.x[sl], p.y[sl], p.z[sl])


def _where(cond, a: JacPoint, b: JacPoint) -> JacPoint:
    c = cond[..., None]
    return JacPoint(torch.where(c, a.x, b.x), torch.where(c, a.y, b.y),
                    torch.where(c, a.z, b.z))


def _segmented_bucket_sums(ops: CurveOps, pts: JacPoint, ids, n_buckets: int,
                           lanes: int | None = None):
    """Work-efficient sorted-segment bucket accumulation.

    pts/ids: [n] points (affine-or-identity) and their bucket ids.
    Returns JacPoint [n_buckets] with the group sum of each bucket.
    """
    dev = ids.device
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    ids_s = ids[order]
    px, py, pz = pts.x[order], pts.y[order], pts.z[order]

    M = min(n, lanes) if lanes else default_lanes(n, dev)
    K = -(-n // M)
    n_pad = M * K
    pad = n_pad - n
    if pad:
        ids_s = torch.cat([ids_s, torch.full((pad,), n_buckets,
                                             dtype=ids_s.dtype, device=dev)])
        zpad = torch.zeros((pad, N_LIMBS), dtype=torch.int32, device=dev)
        px = torch.cat([px, zpad])
        py = torch.cat([py, zpad])
        pz = torch.cat([pz, zpad])  # z=0 -> identity

    prev = torch.cat([torch.full((1,), -1, dtype=ids_s.dtype, device=dev),
                      ids_s[:-1]])
    flags = ids_s != prev  # segment-start marks
    flk = flags.reshape(M, K).T  # [K, M]: lane l owns positions l*K..

    parts_x, parts_y, parts_z = bucket_scan(
        (px, py, pz), flags, M, K, ops.F.p, ops.b3)  # [K, M, 16]

    # ---- lane-carry scan: resolve segments spanning lane boundaries ----
    last = JacPoint(parts_x[-1], parts_y[-1], parts_z[-1])  # [M, 16]
    has_flag = flk.any(dim=0)  # [M]
    first_flag = flk[0]        # [M]
    fid = ids_s.reshape(M, K)[:, 0]  # first id in each lane

    # exclusive scan with combiner ((s1,f1),(s2,f2)) -> (f2 ? s2 : s1+s2,
    # f1|f2): summaries shifted right by one, neutral (identity, False)
    ident1 = ops.identity((1,), dev)
    s = JacPoint(torch.cat([ident1.x, last.x[:-1]]),
                 torch.cat([ident1.y, last.y[:-1]]),
                 torch.cat([ident1.z, last.z[:-1]]))
    f = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev),
                   has_flag[:-1]])
    rows = torch.arange(M, device=dev)
    # masked lanes hold a VALID identity (0 : 1 : 0): the RCB formulas are
    # complete only for valid projective points
    ident_m = ops.identity((M,), dev)
    n_rounds = max((M - 1).bit_length(), 1) if M > 1 else 0
    for i in range(n_rounds):
        d = 1 << i
        valid = rows >= d
        sh = _where(valid, JacPoint(torch.roll(s.x, d, 0),
                                    torch.roll(s.y, d, 0),
                                    torch.roll(s.z, d, 0)), ident_m)
        shf = valid & torch.roll(f, d, 0)
        comb = ops.add(sh, s)
        s = _where(f, s, comb)  # own block already had a reset: keep it
        f = f | shf
    carry = s  # carry[l] = trailing run sum of lanes < l

    # lane l's first run takes its carry when the run crosses into the
    # lane and ends inside it (a later flag in the lane, the next lane
    # opening a new segment, or l is the last lane)
    next_first = torch.cat([first_flag[1:],
                            torch.ones((1,), dtype=torch.bool, device=dev)])
    apply = (~first_flag) & (has_flag | next_first)
    tgt_c = torch.where(apply, fid, torch.full_like(fid, n_buckets))
    ident_tab = ops.identity((n_buckets + 1,), dev)
    cx, cy, cz = (t.clone() for t in (ident_tab.x, ident_tab.y, ident_tab.z))
    cx[tgt_c] = carry.x
    cy[tgt_c] = carry.y
    cz[tgt_c] = carry.z

    # ---- tails: the last element of each run holds the lane-local sum;
    # bucket b's tail is at searchsorted(ids_s, b, right) - 1
    flat = [a.transpose(0, 1).reshape(n_pad, N_LIMBS)
            for a in (parts_x, parts_y, parts_z)]
    qid = torch.arange(n_buckets, dtype=ids_s.dtype, device=dev)
    pos = torch.searchsorted(ids_s, qid, right=True) - 1
    posc = pos.clamp(min=0)
    occupied = (pos >= 0) & (ids_s[posc] == qid)
    ident_b = _take(ident_tab, 0, 0, n_buckets)
    tails = _where(occupied, JacPoint(*(a[posc] for a in flat)), ident_b)
    return ops.add(tails, JacPoint(cx[:n_buckets], cy[:n_buckets],
                                   cz[:n_buckets]))


def _suffix_scan(ops: CurveOps, pts: JacPoint) -> JacPoint:
    """suffix[..., i] = sum_{j >= i} pts[..., j] along axis -2."""
    n = pts.x.shape[-2]
    dev = pts.x.device
    valid_rows = torch.arange(n, device=dev)
    ident = ops.identity(pts.x.shape[:-1], dev)
    s = pts
    for i in range(max(n.bit_length() - 1, 1)):
        d = 1 << i
        valid = torch.broadcast_to(valid_rows < n - d, pts.x.shape[:-1])
        sh = _where(valid, JacPoint(torch.roll(s.x, -d, -2),
                                    torch.roll(s.y, -d, -2),
                                    torch.roll(s.z, -d, -2)), ident)
        s = ops.add(s, sh)
    return s


def _weighted_small(ops: CurveOps, buckets: JacPoint,
                    offset: int = 1) -> JacPoint:
    """sum_b (b + 1 - offset) * S_b over axis -2 via two suffix scans."""
    s1 = _suffix_scan(ops, buckets)
    s2 = _suffix_scan(ops, s1)
    return JacPoint(s2.x[..., offset, :], s2.y[..., offset, :],
                    s2.z[..., offset, :])


def _tree_reduce(ops: CurveOps, pts: JacPoint, axis: int) -> JacPoint:
    """Group sum along `axis` (length a power of two) by halving adds.

    The JAX package reduces axes of up to 16 with a suffix scan instead,
    to keep one add body in its traced graph; eager PyTorch has no graph
    to shrink, so every length takes the work-optimal halving."""
    n = pts.x.shape[axis]
    while n > 1:
        half = n // 2
        pts = ops.add(_take(pts, axis, 0, half), _take(pts, axis, half, n))
        n = half
    sl = [slice(None)] * pts.x.ndim
    sl[axis] = 0
    sl = tuple(sl)
    return JacPoint(pts.x[sl], pts.y[sl], pts.z[sl])


def _weighted_bucket_reduce(ops: CurveOps, buckets: JacPoint, log_b: int,
                            plus_one: bool = False):
    """sum_b w(b) * S_b per window (leading axis), w(b) = b, or b + 1 for
    signed digits.  Small windows use the double-suffix scan; larger ones
    split b = hi * Blo + lo into two tree reductions and two small
    double-suffix scans."""
    off = 0 if plus_one else 1
    if log_b <= 6:
        return _weighted_small(ops, buckets, offset=off)
    W = buckets.x.shape[0]
    clo = log_b // 2
    blo, bhi = 1 << clo, 1 << (log_b - clo)
    t = JacPoint(*(a.reshape(W, bhi, blo, N_LIMBS)
                   for a in (buckets.x, buckets.y, buckets.z)))
    r1 = _tree_reduce(ops, t, 2)      # [W, bhi, 16]
    r2 = _tree_reduce(ops, t, 1)      # [W, blo, 16]
    w1 = _weighted_small(ops, r1)     # [W, 16]: sum_hi hi * R1
    w2 = _weighted_small(ops, r2, offset=off)
    for _ in range(clo):              # Blo * w1
        w1 = ops.double(w1)
    return ops.add(w1, w2)


def _group_windows(n: int, n_windows: int) -> int:
    """Windows per bucket-accumulation pass (tiled stream <= 2^22 points)."""
    return max(1, min(n_windows, (1 << 22) // max(n, 1)))


def msm_impl(ops: CurveOps, pts: JacPoint, scalars, c: int, n_windows: int,
             lanes: int | None = None, window_group: int | None = None,
             signed: bool = True):
    """Full Pippenger -> JacPoint [16] in the ops' coordinates.

    `pts` MUST be affine-or-identity (z in {0, 1}).  `signed` takes
    balanced digits (half the buckets) and needs n_windows*c > scalar
    bits."""
    n = scalars.shape[0]
    W = n_windows
    B = (1 << (c - 1)) if signed else (1 << c)
    wg = min(window_group or W, W)
    dev = scalars.device

    if signed:
        assert W * c > ops.F.bits, "signed digits need top-window slack"
        digits = signed_digits(scalars, c, W)         # [W, n]
        neg_y = ops.F.neg(pts.y)                      # [n, 16]
    else:
        digits = torch.stack([window_digits(scalars, c, w) for w in range(W)])

    parts = []
    for g0 in range(0, W, wg):
        dig = digits[g0 : g0 + wg]
        g = dig.shape[0]
        base = torch.arange(g, dtype=torch.int64, device=dev)[:, None] * B
        if signed:
            ids = torch.where(dig == 0, g * B, base + dig.abs() - 1).reshape(-1)
            neg = (dig < 0).reshape(-1)
            py = torch.where(neg[:, None], neg_y.repeat(g, 1),
                             pts.y.repeat(g, 1))
        else:
            ids = (base + dig).reshape(-1)
            py = pts.y.repeat(g, 1)
        stream = JacPoint(pts.x.repeat(g, 1), py, pts.z.repeat(g, 1))
        parts.append(_segmented_bucket_sums(ops, stream, ids, g * B,
                                            lanes=lanes))
    flat = JacPoint(*(torch.cat([getattr(p_, a) for p_ in parts])
                      for a in ("x", "y", "z")))
    if ops.b3 and os.environ.get("ZKSNAP_TPU_FUSED_REDUCE", "0") == "1":
        # fused post-scan stage: the double suffix (K5), then the ladder
        # and tree (K6) over each window's weighted sum
        s2 = weighted_suffix((flat.x, flat.y, flat.z), B, ops.F.p, ops.b3)
        sel = torch.arange(W, device=dev) * B + (0 if signed else 1)
        return JacPoint(*ladder_tree(tuple(a[sel] for a in s2), c, W,
                                     ops.F.p, ops.b3))
    buckets = JacPoint(*(a.reshape(W, B, N_LIMBS)
                         for a in (flat.x, flat.y, flat.z)))
    wsums = _weighted_bucket_reduce(
        ops, buckets, c - 1 if signed else c, plus_one=signed)  # [W, 16]

    # window combine T = sum_w 2^{c*w} S_w: masked doubling ladder over
    # the window axis (entry w doubles while i < c*w), then a tree sum
    Wp = 1 << max((W - 1).bit_length(), 0)
    idp = ops.identity((Wp - W,), dev)
    acc = JacPoint(*(torch.cat([a, b]) for a, b in
                     ((wsums.x, idp.x), (wsums.y, idp.y), (wsums.z, idp.z))))
    widx = torch.arange(Wp, device=dev)
    for i in range(c * (W - 1)):
        acc = _where((widx * c) > i, ops.double(acc), acc)
    return _tree_reduce(ops, acc, 0)


class MSM:
    """Pippenger MSM for one curve."""

    def __init__(self, ops: CurveOps, signed: bool = True):
        self.ops = ops
        self.signed = signed

    def _pick_c(self, n: int, signed: bool) -> int:
        # minimise the modelled group-add count: W*n accumulation plus
        # ~2*W*B reduction
        best, best_cost = 8, None
        for c in range(6, 17):
            w = -(-self.ops.F.bits // c)
            b = 1 << (c - 1 if signed else c)
            cost = w * n + 2 * w * b
            if best_cost is None or cost < best_cost:
                best, best_cost = c, cost
        return best

    def __call__(self, pts: JacPoint, scalars, c: int | None = None) -> JacPoint:
        """pts: JacPoint [n]; scalars: [n, 16] canonical limbs."""
        n = scalars.shape[0]
        c = c or self._pick_c(n, self.signed)
        n_windows = -(-self.ops.F.bits // c)
        signed = self.signed and n_windows * c > self.ops.F.bits
        return msm_impl(self.ops, pts, scalars, c, n_windows,
                        window_group=_group_windows(n, n_windows),
                        signed=signed)


@functools.cache
def bn254_msm() -> MSM:
    """Jacobian-coordinate MSM."""
    from ..curves.jacobian import bn254_ops

    return MSM(bn254_ops())


@functools.cache
def bn254_msm_proj() -> MSM:
    """RCB complete-projective MSM (the prover's); the result holds
    PROJECTIVE coordinates."""
    from ..curves.proj import bn254_proj_ops

    return MSM(bn254_proj_ops())
