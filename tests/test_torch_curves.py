"""The port's group law (zksnap_tpu_torch.curves) against the JAX package.

Kernel K3's six point kinds and kernel K4's bucket scan (their plain
versions, which CPU tensors run) are held to the JAX package's fused
bodies -- `point_add_fused` / `point_dbl_fused` / `bucket_scan_fused` on
its CPU direct path -- and to the host oracle (`curves.native`), with the
edge cases of tests/test_fused_point.py.  The JAX bodies run eagerly
under `jax.disable_jit()`: integer ops give the same bits either way, and
compiling the unrolled formula graphs costs minutes on the CPU.
Tolerance: none -- integers, compared mod p (the JAX projective kinds
are lazy, in [0, 2p)).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksnap_tpu.curves import fused as jfused
from zksnap_tpu.curves.native import BN254_G1 as J_BN254
from zksnap_tpu.curves.native import AffinePoint as JAffine
from zksnap_tpu_torch.curves import fused as tfused
from zksnap_tpu_torch.curves.jacobian import JacPoint, bn254_ops, secp_ops
from zksnap_tpu_torch.curves.native import BN254_G1, SECP256K1, AffinePoint
from zksnap_tpu_torch.curves.proj import bn254_proj_ops
from zksnap_tpu_torch.fields import bn254_fq, secp256k1_fp

torch.set_num_threads(1)
DEV = "cpu"

B3 = 3 * BN254_G1.b


def _j(t: torch.Tensor):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _ints(F, arrays):
    """Coordinate tensors (port or JAX) -> python ints mod p."""
    return [F.from_mont(np.asarray(a).astype(np.int64).reshape(-1, 16))
            for a in arrays]


def _encode(pts, F, rng, jacobian: bool, affine: bool = False,
            stream_identity: bool = False):
    """Points -> (x, y, z) Montgomery tensors.  Non-affine encodings scale
    by a random lambda (projective (lx : ly : l), Jacobian (l^2 x : l^3 y
    : l)); identities are (0 : l : 0) / (l^2 : l^3 : 0), or, affine,
    (0, 1, 0) -- (0, 0, 0) with `stream_identity`, the fixed-base table
    and stream encoding."""
    q = F.p
    rows = []
    for pt in pts:
        lam = 1 if affine else rng.randrange(1, q)
        if pt.is_identity():
            if affine:
                rows.append((0, 0 if stream_identity else 1, 0))
            elif jacobian:
                rows.append((lam * lam % q, lam ** 3 % q, 0))
            else:
                rows.append((0, lam, 0))
        elif jacobian:
            rows.append((lam * lam * pt.x % q, lam ** 3 * pt.y % q, lam))
        else:
            rows.append((lam * pt.x % q, lam * pt.y % q, lam))
    return [F.to_mont([r[i] for r in rows], DEV) for i in range(3)]


def _edge_points(curve, rng):
    """tests/test_fused_point.py's cases: identity operands, P == Q,
    P == -Q, plus general pairs."""
    g = AffinePoint.generator(curve)
    p = rng.randrange(1, curve.n) * g
    q = rng.randrange(1, curve.n) * g
    ident = AffinePoint.identity(curve)
    ps = [p, ident, p, p, p, ident, q]
    qs = [q, q, ident, p, -p, ident, q + q]
    return ps, qs


def _jax_point(kind, arrays, p, b3):
    n0 = (-pow(p, -1, 1 << 16)) % (1 << 16)
    ja = [_j(a) for a in arrays]
    with jax.disable_jit():
        if kind in ("dbl", "pdbl"):
            return jfused.point_dbl_fused(tuple(ja), p, n0, proj_b3=b3)
        return jfused.point_add_fused(
            tuple(ja[:3]), tuple(ja[3:]), p, n0,
            mixed=kind in ("madd", "pmadd"), proj_b3=b3)


def _to_affine(F, curve, coords, jacobian: bool):
    q = F.p
    out = []
    for x, y, z in zip(*_ints(F, coords)):
        if z == 0:
            out.append(AffinePoint.identity(curve))
            continue
        zi = pow(z, -1, q)
        if jacobian:
            out.append(AffinePoint(curve, x * zi * zi % q, y * zi ** 3 % q))
        else:
            out.append(AffinePoint(curve, x * zi % q, y * zi % q))
    return out


KINDS = [("padd", False), ("pmadd", False), ("pdbl", False),
         ("add", True), ("madd", True), ("dbl", True)]


@pytest.mark.parametrize("kind,jacobian", KINDS, ids=[k for k, _ in KINDS])
def test_point_kinds_match_jax(kind, jacobian):
    """Each kind on BN254 against the JAX fused body and the oracle; the
    mixed kinds take Q affine-or-identity and a non-trivial z1."""
    rng = random.Random(11)
    F = bn254_fq()
    b3 = 0 if jacobian else B3
    ps, qs = _edge_points(BN254_G1, rng)
    P = _encode(ps, F, rng, jacobian)
    mixed = kind in ("madd", "pmadd")
    if kind in ("dbl", "pdbl"):
        arrays, want = P, [a + a for a in ps]
    else:
        Q = _encode(qs, F, rng, jacobian, affine=mixed)
        arrays, want = P + Q, [a + b for a, b in zip(ps, qs)]
    got = tfused.point(kind, arrays, F.p, b3)
    assert _to_affine(F, BN254_G1, got, jacobian) == want
    ref = _jax_point(kind, arrays, F.p, b3)
    assert _ints(F, got) == _ints(F, ref)
    if kind == "pmadd":
        # identity rows of the fixed-base stream are (0, 0, 0): z == 0
        # passes P through
        Qs = _encode(qs, F, rng, False, affine=True, stream_identity=True)
        got = tfused.point(kind, P + Qs, F.p, b3)
        assert _to_affine(F, BN254_G1, got, False) == want
        assert _ints(F, got) == _ints(F, _jax_point(kind, P + Qs, F.p, b3))


@pytest.mark.parametrize("kind", ["add", "madd", "dbl"])
def test_jacobian_kinds_secp256k1(kind):
    """The Jacobian kinds over secp256k1 (the modulus near 2^256) against
    the oracle."""
    rng = random.Random(12)
    F = secp256k1_fp()
    ps, qs = _edge_points(SECP256K1, rng)
    P = _encode(ps, F, rng, True)
    if kind == "dbl":
        arrays, want = P, [a + a for a in ps]
    else:
        Q = _encode(qs, F, rng, True, affine=kind == "madd")
        arrays, want = P + Q, [a + b for a, b in zip(ps, qs)]
    got = tfused.point(kind, arrays, F.p)
    assert _to_affine(F, SECP256K1, got, True) == want


def _stream(rng, M, K, F, curve):
    """A bucket-sorted-like stream: affine points with identities encoded
    (0, 0, 0) and duplicates, and segment flags with every lane's first
    position set plus interior breaks and one lane that continues."""
    g = AffinePoint.generator(curve)
    pool = [rng.randrange(1, curve.n) * g for _ in range(5)]
    ident = AffinePoint.identity(curve)
    pts = []
    for i in range(M * K):
        r = rng.random()
        pts.append(ident if r < 0.15 else (pts[-1] if r < 0.3 and pts
                                           else rng.choice(pool)))
    flags = np.zeros(M * K, bool)
    flags[::K] = True
    flags[K] = False  # lane 1 continues lane 0's segment
    flags[[2, 6, 10]] = True
    xyz = _encode(pts, F, rng, False, affine=True, stream_identity=True)
    return pts, flags, xyz


def _running_sums(pts, flags, M, K):
    out = {}
    for lane in range(M):
        acc = None
        for k in range(K):
            i = lane * K + k
            acc = pts[i] if (flags[i] or acc is None) else acc + pts[i]
            out[(k, lane)] = acc
    return out


def test_bucket_scan_matches_jax():
    rng = random.Random(13)
    M, K = 3, 4
    F = bn254_fq()
    pts, flags, xyz = _stream(rng, M, K, F, BN254_G1)
    got = tfused.bucket_scan(xyz, torch.from_numpy(flags), M, K, F.p, B3)
    assert all(a.shape == (K, M, 16) for a in got)
    n0 = (-pow(F.p, -1, 1 << 16)) % (1 << 16)
    with jax.disable_jit():
        ref = jfused.bucket_scan_fused(tuple(_j(a) for a in xyz),
                                       jnp.asarray(flags), M, K, F.p, n0, B3)
    assert _ints(F, got) == _ints(F, ref)
    want = _running_sums(pts, flags, M, K)
    aff = _to_affine(F, BN254_G1, got, False)
    assert aff == [want[(k, lane)] for k in range(K) for lane in range(M)]


def test_bucket_scan_jacobian():
    """The madd variant (b3 = 0, Jacobian accumulator) against the
    oracle; the stream's z == 0 rows are identities here too."""
    rng = random.Random(14)
    M, K = 3, 4
    F = bn254_fq()
    pts, flags, xyz = _stream(rng, M, K, F, BN254_G1)
    got = tfused.bucket_scan(xyz, torch.from_numpy(flags), M, K, F.p, 0)
    want = _running_sums(pts, flags, M, K)
    aff = _to_affine(F, BN254_G1, got, True)
    assert aff == [want[(k, lane)] for k in range(K) for lane in range(M)]


@pytest.mark.parametrize("ops_fn", [bn254_ops, secp_ops, bn254_proj_ops],
                         ids=["bn254_jac", "secp_jac", "bn254_proj"])
def test_curve_ops_against_oracle(ops_fn):
    """CurveOps / ProjOps: identity encodings, scalar_mul, normalize and
    the host conversions, against the oracle and the JAX package's
    native arithmetic."""
    ops = ops_fn()
    curve = ops.params
    rng = random.Random(15)
    g = AffinePoint.generator(curve)
    pts = [rng.randrange(1, curve.n) * g for _ in range(3)]
    pts.append(AffinePoint.identity(curve))
    ks = [rng.randrange(1 << 12) for _ in pts]
    ks[1] = 0
    P = ops.from_affine_host(pts, DEV)
    bits = torch.tensor([[(k >> (11 - i)) & 1 for i in range(12)]
                         for k in ks])
    R = ops.scalar_mul(P, bits)
    want = [k * pt for k, pt in zip(ks, pts)]
    assert ops.to_affine_host(R) == want
    N = ops.normalize(R)
    assert ops.to_affine_host(N) == want
    one = ops.F.one_t("cpu")
    for w, z in zip(want, N.z):
        assert torch.equal(z, torch.zeros_like(one) if w.is_identity()
                           else one)
    ident = ops.identity((2,), DEV)
    assert ops.to_affine_host(ident) == [AffinePoint.identity(curve)] * 2
    assert bool(ops.is_identity(ident).all())
    S = ops.add(R, ops.neg(R))
    assert ops.to_affine_host(S) == [AffinePoint.identity(curve)] * 4
    if curve is BN254_G1:
        # the oracle is the JAX package's own host arithmetic
        jpts = [JAffine(J_BN254, pt.x, pt.y) for pt in pts[:3]]
        assert [(w.x, w.y) for w in want[:3]] == [
            ((k * jp).x, (k * jp).y) for k, jp in zip(ks, jpts)]


def test_point_wrapper_dispatch():
    """A CPU tensor launches nothing; operands on two devices raise."""
    F = bn254_fq()
    P = bn254_ops().from_affine_host([AffinePoint.generator(BN254_G1)], DEV)
    before = (tfused.point.launches, tfused.bucket_scan.launches)
    tfused.point("dbl", [P.x, P.y, P.z], F.p)
    assert (tfused.point.launches, tfused.bucket_scan.launches) == before
    meta = torch.empty((1, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tfused.point("dbl", [P.x, P.y, meta], F.p)
    assert isinstance(JacPoint(P.x, P.y, P.z).device, torch.device)
