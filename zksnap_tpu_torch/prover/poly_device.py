"""Device-side polynomial engine for the PLONK prover, single device
(PyTorch port of zksnap_tpu/prover/poly_device.py).

  * `commit_evals` / `commit_coeffs` -- KZG commitments: fixed-base MSM
    over precomputed shifted tables for 2^12 <= n <= 2^20, variable-base
    Pippenger otherwise, both in RCB projective coordinates;
  * `coset_evals`, `evals_to_coeffs`, `coeffs_to_evals` -- NTTs;
  * `coset_extended_evals` / `coset_interpolate` -- onto the extended
    coset g*H_ext and back (the reference's `coeff_to_extended`);
  * `eval_coeffs_list` -- coefficient-form polys evaluated at a point;
    `batch_eval` -- evaluation-form polys, barycentric;
  * `pow_series_traced` -- the powers of a device value;
  * `opening_witness_evals` -- (f - f(p)) / (X - p) pointwise on the
    domain with a batched inverse;
  * `rlc`, `rlc_list` -- random linear combinations.

Every tensor stays on the device of its inputs; `device` arguments name
it where a function creates tensors from host data.  Inside
`prover_mesh(mesh, axis)` the commits and NTTs of a domain that the mesh
splits (`_mesh_for`) run sharded over the mesh's devices (parallel/,
poly/ntt.py's four-step NTT) and bring their results back to the
device of their inputs; everything else stays where it was.

At rest (a proving key's fixed coefficients, a proof's witness
coefficients) a poly is kept in `pack_poly`'s form: the 16 limbs, each
below 2^16, as `torch.int16` bit patterns, half the bytes of the int32
compute form.  Torch has little arithmetic for uint16, so int16 holds
the bits and `_u32` widens them back (`& 0xFFFF` into int32) at each
point of use: every function here that reads a poly accepts either form.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import obs
from ..curves.jacobian import JacPoint
from ..fields.common import N_LIMBS, ints_to_limbs, ints_to_limbs_fast
from ..fields.field import bn254_fr
from ..msm.pippenger import _group_windows, msm_impl
from ..poly.domain import domain
from ..poly.ntt import _ntt_impl, _u32

FR = bn254_fr()


# -- mesh context -------------------------------------------------------------
#
# `prover_mesh` makes every commitment MSM and every NTT issued inside the
# context run mesh-sharded.  Elementwise work stays on the device of its
# inputs (the key's).  With no active context everything is single-device.

_MESH_TLS = threading.local()  # per-thread stack of (mesh, axis), as in
# the JAX package


def _mesh_stack() -> list:
    st = getattr(_MESH_TLS, "stack", None)
    if st is None:
        st = _MESH_TLS.stack = []
    return st


@contextlib.contextmanager
def prover_mesh(mesh, axis: str = "x"):
    """Run prover commits and NTTs mesh-sharded inside this context."""
    st = _mesh_stack()
    st.append((mesh, axis))
    try:
        yield
    finally:
        st.pop()


def _mesh_for(n: int):
    """(mesh, axis) if a mesh is active and a length-n axis splits evenly
    into >= ndev^2 elements (the four-step layout needs n2 % n1 == 0)."""
    st = _mesh_stack()
    if not st:
        return None
    mesh, axis = st[-1]
    ndev = mesh.shape[axis]
    if ndev <= 1 or n % ndev or n < ndev * ndev:
        return None
    return mesh, axis


def pow_series_uncached(base_int: int, n: int, device="cuda"):
    """[n,16] Montgomery table of base^i by log-depth doubling."""
    size = max(1, 1 << (n - 1).bit_length())
    arr = FR.one_t(device)[None, :]
    length = 1
    while length < size:
        step = FR.const_t(pow(base_int, length, FR.p), device)
        arr = torch.cat([arr, FR.mul(arr, step[None, :])])
        length *= 2
    return arr[:n]


@functools.lru_cache(maxsize=32)
def _pow_series_cached(base_int: int, n: int, device: str):
    return pow_series_uncached(base_int, n, device)


def pow_series(base_int: int, n: int, device="cuda"):
    """Cached `pow_series_uncached` (omega and generator powers)."""
    return _pow_series_cached(base_int, n, str(torch.device(device)))


# -- the at-rest form ---------------------------------------------------------

def pack_poly(x):
    """[n,16] int32 Montgomery -> the int16 at-rest form (lossless: every
    limb is below 2^16 and keeps its bit pattern)."""
    if x.dtype == torch.int16:
        return x
    return (x - ((x & 0x8000) << 1)).to(torch.int16)


def to_device_poly(values, device="cuda"):
    """Host evaluations -> Montgomery limb tensor [n, 16] on `device`.

    Accepts a list of python ints, an (n, 16) canonical limb-row array
    (the trace layout representation) or a 1-D array of small
    non-negative ints (< 2^64).  One multiply by R^2 (kernel K1) makes
    the Montgomery lift."""
    if isinstance(values, np.ndarray):
        if values.ndim == 2:
            assert values.shape[1] == N_LIMBS
            canon = values.astype(np.int32)
        else:
            v = values.astype(np.int64)
            canon = np.zeros((len(v), N_LIMBS), dtype=np.int32)
            for limb in range(4):
                canon[:, limb] = (v >> (16 * limb)) & 0xFFFF
    else:
        canon = ints_to_limbs_fast(values, FR.p)
    with obs.wait():
        t = torch.from_numpy(canon).to(device)
    return FR.mul(t, FR.const_t(FR.R, device)[None, :])


# -- KZG commitments ---------------------------------------------------------

# Fixed-base commit tables: the SRS bases never change per k, so shifted
# tables remove the doubling ladder and the per-window bucket sets.  Used
# for commits of min_n <= n <= max_n points (the JAX package's defaults:
# 2^12 to 2^20, c = 16; a 2^21 table takes 4.3 GB); a table lives as long
# as the point tensor it was built from, or until the window width changes.
_FB_STATE = {"enabled": True, "max_n": 1 << 20, "min_n": 1 << 12, "c": 16,
             "tables": WeakIdKeyDictionary()}


def configure_fixed_base(enabled: bool | None = None, max_n: int | None = None,
                         c: int | None = None):
    """Tune the fixed-base commit path (e.g. enable at 2^21 for the voter
    prover, disable under tight device memory)."""
    if enabled is not None:
        _FB_STATE["enabled"] = enabled
    if max_n is not None:
        _FB_STATE["max_n"] = max_n
    if c is not None:
        _FB_STATE["c"] = c
        _FB_STATE["tables"].clear()


def _fb_table(points: JacPoint, n: int):
    from ..msm.fixed_base import build_table

    per_n = _FB_STATE["tables"].setdefault(points.x, {})
    key = (n, _FB_STATE["c"])
    if key not in per_n:
        per_n[key] = build_table(points, n, _FB_STATE["c"])
    return per_n[key]


# A mesh commit's SRS shards, cached as `_fb_table`'s tables are: the
# points of a shard whose device is not the SRS's are copied there once.
# A shard on the SRS's own device is a slice of it, made anew each call
# (free, and a cached view would keep its weak key alive).
_SHARDS = WeakIdKeyDictionary()


def _srs_shards(points: JacPoint, n: int, devs) -> list:
    m = n // len(devs)
    src = points.x.device
    per_key = _SHARDS.setdefault(points.x, {})
    out = []
    for d, dev in enumerate(devs):
        sl = [getattr(points, a)[d * m:(d + 1) * m] for a in ("x", "y", "z")]
        if dev == src:
            out.append((dev, JacPoint(*sl)))
            continue
        key = (n, len(devs), d, str(dev))
        if key not in per_key:
            per_key[key] = JacPoint(*(t.to(dev) for t in sl))
        out.append((dev, per_key[key]))
    return out


def commit_evals(srs_lagrange: JacPoint, values) -> JacPoint:
    """Commit an evaluation-form poly: MSM(values, [L_i(tau)]G).

    values: [n, 16] CANONICAL scalar limbs.  The MSM runs in RCB
    projective coordinates; the result comes back as Jacobian
    (X*Z, Y*Z^2, Z), on the device of `values`.  Under a mesh that
    splits n, each shard runs Pippenger over its n/ndev points (window
    width from the full n, window groups from the shard's, as the JAX
    package's sharded commit) and a tree sums the partials; the
    fixed-base path is then bypassed."""
    n = values.shape[0]
    sh = _mesh_for(n)
    if (sh is None and _FB_STATE["enabled"]
            and _FB_STATE["min_n"] <= n <= _FB_STATE["max_n"]):
        from ..msm.fixed_base import commit_fixed

        return commit_fixed(_fb_table(srs_lagrange, n), values)
    from ..curves.proj import bn254_proj_ops

    ops = bn254_proj_ops()
    Fq = ops.F
    c = max(8, min(16, n.bit_length() - 4))
    n_windows = -(-254 // c)
    if sh is not None:
        from ..parallel.sharded import combine_partials, shard_partials

        devs = sh[0].axis_devices(sh[1])
        parts = shard_partials(
            ops, _srs_shards(srs_lagrange, n, devs), values, c, n_windows,
            window_group=_group_windows(n // len(devs), n_windows))
        r = combine_partials(ops, parts, values.device)
    else:
        r = msm_impl(ops, JacPoint(srs_lagrange.x[:n], srs_lagrange.y[:n],
                                   srs_lagrange.z[:n]), values, c, n_windows,
                     window_group=_group_windows(n, n_windows),
                     signed=n_windows * c > Fq.bits)
    return JacPoint(Fq.mul(r.x, r.z), Fq.mul(r.y, Fq.square(r.z)), r.z)


def mont_to_canonical(values):
    """[n,16] Montgomery -> canonical (for MSM scalars)."""
    return FR.mont_reduce_narrow(_u32(values))


def commit_coeffs(srs_monomial: JacPoint, coeffs) -> JacPoint:
    """Commit a coefficient-form poly over the monomial SRS (coeffs in
    Montgomery form)."""
    return commit_evals(srs_monomial, mont_to_canonical(coeffs))


# -- NTTs -------------------------------------------------------------------

def evals_to_coeffs(evals, k: int):
    """[n,16] evaluations on H (natural order) -> coefficient form."""
    dom = domain(k)
    n_inv = FR.const_t(dom.n_inv, evals.device)
    sh = _mesh_for(1 << k)
    if sh is not None:
        return FR.mul(_four_step_natural(evals, k, sh, True), n_inv[None, :])
    return _ntt_impl(evals, dom.twiddles_inv(evals.device), k, FR,
                     post=n_inv)


def coeffs_to_evals(coeffs, k: int):
    """[n,16] coefficient form -> evaluations on H (natural order)."""
    sh = _mesh_for(1 << k)
    if sh is not None:
        return _four_step_natural(coeffs, k, sh, False)
    return _ntt_impl(coeffs, domain(k).twiddles(coeffs.device), k, FR)


def coset_evals(coeffs, s_pows, k: int):
    """Evaluate a coefficient-form poly on the coset {s * w^i}: scale
    coefficient j by s^j (s_pows, [n,16] Montgomery), then forward NTT
    (sharded under a mesh, as coeffs_to_evals; on one device the scale
    is the NTT's own first step)."""
    sh = _mesh_for(1 << k)
    if sh is not None:
        return _four_step_natural(FR.mul(_u32(coeffs), s_pows), k, sh, False)
    return _ntt_impl(coeffs, domain(k).twiddles(coeffs.device), k, FR,
                     pre=s_pows)


# -- coset extended evaluation ----------------------------------------------

def coset_extended_evals(values, k: int, ext_factor_log: int):
    """values [n,16] (Montgomery, natural order on H) -> evaluations on
    the coset g*H_ext [2^(k+ext_factor_log), 16]: iNTT, times g^i,
    zero-padded, forward NTT (each NTT sharded under a mesh that splits
    its domain)."""
    n = 1 << k
    ke = k + ext_factor_log
    coeffs = FR.mul(evals_to_coeffs(values, k),
                    pow_series(FR.generator, n, values.device))
    padded = torch.cat([coeffs, coeffs.new_zeros(((1 << ke) - n, N_LIMBS))])
    return coeffs_to_evals(padded, ke)


def coset_interpolate(evals, k: int, ext_factor_log: int):
    """Inverse of `coset_extended_evals`: evaluations on g*H_ext ->
    coefficients [2^(k+ext_factor_log), 16]: iNTT (four-step under a mesh
    that splits the extended domain), times g^-i."""
    ke = k + ext_factor_log
    return FR.mul(evals_to_coeffs(evals, ke),
                  pow_series(pow(FR.generator, -1, FR.p), 1 << ke,
                             evals.device))


def pow_series_traced(base_mont, n: int):
    """[n,16] powers of a device value base_mont ([16] Montgomery) by
    log-depth doubling; for a host-known base `pow_series` is cheaper."""
    size = max(1, 1 << (n - 1).bit_length())
    arr = torch.stack([FR.one_t(base_mont.device), _u32(base_mont)])
    length = 2
    while length < size:
        step = FR.mul(arr[-1], arr[1])
        arr = torch.cat([arr, FR.mul(arr, step[None, :])])
        length *= 2
    return arr[:n]


# -- mesh-sharded NTT plumbing ------------------------------------------------

@functools.lru_cache(maxsize=32)
def _four_step_perms(k: int, ndev: int, device: str):
    from ..poly.ntt import four_step_input_perm, four_step_output_perm

    return (torch.from_numpy(four_step_input_perm(k, ndev)).to(device),
            torch.from_numpy(four_step_output_perm(k, ndev)).to(device))


def _four_step_natural(x, k: int, sh, inverse: bool):
    """natural-order in -> natural-order out through the four-step NTT
    (poly/ntt.py): the layout permutations are gathers on x's device."""
    from ..poly.ntt import four_step_ntt

    mesh, axis = sh
    inp, outp = _four_step_perms(k, mesh.shape[axis], str(x.device))
    return four_step_ntt(_u32(x)[inp], k, mesh, axis, inverse=inverse)[outp]


# -- batched evaluation at a point ------------------------------------------

def _sum_rows(acc):
    """[P, n, 16] -> [P, 16]: the sum over n (a power of two), a tree of
    adds."""
    m = acc.shape[1]
    while m > 1:
        acc = FR.add(acc[:, : m // 2], acc[:, m // 2 : m])
        m //= 2
    return acc[:, 0]


def eval_coeffs_list(polys: list, x_int: int, k: int) -> list[int]:
    """Coefficient-form polys -> values at x (host ints): a multiply by
    the power table of x and a tree sum, for the stacked list."""
    n = 1 << k
    dev = polys[0].device
    pw = pow_series_uncached(x_int, n, dev)
    return FR.from_mont(_sum_rows(
        FR.mul(torch.stack([_u32(p) for p in polys]), pw[None])))


def batch_eval(polys, x_int: int, k: int) -> list[int]:
    """polys [P, n, 16] Montgomery evaluations on H -> [P] ints at x, by
    the barycentric formula f(x) = (x^n - 1)/n * sum_i f_i w^i / (x - w^i)
    (one batched inverse, then a multiply and a tree sum)."""
    n = 1 << k
    dev = polys.device
    dom = domain(k)
    x = FR.const_t(x_int, dev)
    w = pow_series(dom.omega, n, dev)
    inv = FR.batch_inv(FR.sub(x.expand(n, N_LIMBS), w))
    zn = FR.sub(FR.pow_const(x, n), FR.one_t(dev))
    scale = FR.mul(zn, FR.const_t(dom.n_inv, dev))
    weights = FR.mul(FR.mul(w, inv), scale)
    return FR.from_mont(_sum_rows(FR.mul(_u32(polys), weights[None])))


# -- opening witness ---------------------------------------------------------

def opening_witness_evals(combined, eval_int: int, p_int: int, k: int):
    """Evaluation form of (f(X) - f(p)) / (X - p) on H."""
    n = 1 << k
    dev = combined.device
    w = pow_series(domain(k).omega, n, dev)
    denom = FR.sub(w, FR.const_t(p_int, dev)[None, :])
    inv = FR.batch_inv(denom)
    num = FR.sub(combined, FR.const_t(eval_int, dev)[None, :])
    return FR.mul(num, inv)


# -- random linear combination ------------------------------------------------

def rlc(polys, coef_ints: list[int], k: int):
    """sum_i coef_i * polys[i] over a [P, n, 16] stack -> [n, 16]: one
    stacked multiply, then a tree of adds."""
    coefs = torch.from_numpy(ints_to_limbs(
        [c % FR.p * FR.R % FR.p for c in coef_ints]))
    with obs.wait():
        coefs = coefs.to(polys.device)
    acc = FR.mul(_u32(polys), coefs[:, None, :])
    m = acc.shape[0]
    while m > 1:
        h = m // 2
        acc = torch.cat([FR.add(acc[:h], acc[m - h : m]), acc[h : m - h]])
        m = m - h
    return acc[0]


def rlc_list(polys: list, coef_ints: list[int], k: int):
    """`rlc` over a list of [n,16] polys."""
    return rlc(torch.stack([_u32(p) for p in polys]), coef_ints, k)
