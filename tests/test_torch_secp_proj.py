"""The port's `secp_proj_ops` (zksnap_tpu_torch.curves.proj): secp256k1's
RCB projective group law, kernel K3's padd, pmadd and pdbl kinds at
secp256k1's modulus (p = 2^256 - 2^32 - 977, b3 = 21), against the JAX
package's `secp_proj_ops` bodies on their non-fused branch (`_run_body`
over `_FieldAdapter`, op by op under `jax.disable_jit()`) and against the
python-int oracle on affine points.

The 16 pairs are edge-laden: identity operands, P == Q, P == -Q, points
whose coordinates lie near p, and general pairs, each in a random
projective scaling (the mixed add's second operand affine).  Tolerance:
none -- the same canonical integers.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksnap_tpu.curves import fused as jfused
from zksnap_tpu.curves import proj as jproj
from zksnap_tpu.fields.field import secp256k1_fp as jsecp256k1_fp
from zksnap_tpu_torch.curves.native import SECP256K1, AffinePoint
from zksnap_tpu_torch.curves.proj import secp_proj_ops

torch.set_num_threads(1)
DEV = "cpu"
N_PAIRS = 16


def _pairs(rng):
    """16 (P, Q) pairs over secp256k1: the edge cases first."""
    g = AffinePoint.generator(SECP256K1)
    ident = AffinePoint.identity(SECP256K1)
    pts = [rng.randrange(1, SECP256K1.n) * g for _ in range(6)]
    # a point with x near p: the smallest x >= p - 2^40 on the curve
    p = SECP256K1.p
    x = p - (1 << 40)
    while True:
        y2 = (x ** 3 + SECP256K1.b) % p
        y = pow(y2, (p + 1) // 4, p)
        if y * y % p == y2:
            break
        x += 1
    near = AffinePoint(SECP256K1, x, y)
    ps = [pts[0], ident, pts[1], pts[2], pts[3], ident, near, near,
          near, -near, pts[4], -pts[4], pts[5], pts[0], pts[1], pts[2]]
    qs = [ident, pts[0], pts[1], -pts[2], pts[3] + pts[3], ident, near,
          -near, pts[0], pts[5], -pts[4], pts[4], pts[5], pts[3], pts[4],
          pts[5] + pts[0]]
    assert len(ps) == len(qs) == N_PAIRS
    return ps, qs


def _encode(ops, pts, rng, affine: bool):
    """Points -> (x, y, z) Montgomery tensors: (l x : l y : l) for a
    random l, identities (0 : l : 0); affine (x, y, 1) and (0, 1, 0)."""
    q = ops.params.p
    rows = []
    for pt in pts:
        lam = 1 if affine else rng.randrange(1, q)
        rows.append((0, lam, 0) if pt.is_identity()
                    else (lam * pt.x % q, lam * pt.y % q, lam))
    return [ops.F.to_mont([r[i] for r in rows], DEV) for i in range(3)]


def _jax_body(kind: str, arrays, b3: int):
    A = jproj._FieldAdapter(jsecp256k1_fp())
    ins = [jnp.asarray(a.numpy().astype(np.uint32)) for a in arrays]
    with jax.disable_jit():
        out = jfused._run_body(kind, A, ins, b3)
    return [np.asarray(o).astype(np.int64) for o in out]


@pytest.fixture(scope="module")
def cases():
    rng = random.Random(20261018)
    ops = secp_proj_ops()
    ps, qs = _pairs(rng)
    P = _encode(ops, ps, rng, affine=False)
    Q = _encode(ops, qs, rng, affine=False)
    Qa = _encode(ops, qs, rng, affine=True)
    return ops, ps, qs, P, Q, Qa


@pytest.mark.parametrize("kind", ["padd", "pmadd", "pdbl"])
def test_secp_proj_ops_against_jax_and_oracle(cases, kind):
    """padd / pmadd / pdbl of the port (K3's plain version on the CPU)
    give the JAX bodies' integers, and the oracle's affine points."""
    from zksnap_tpu_torch.curves.jacobian import JacPoint

    ops, ps, qs, P, Q, Qa = cases
    assert ops.b3 == 21 and ops.kinds == ("padd", "pmadd", "pdbl")
    Pj = JacPoint(*P)
    if kind == "pdbl":
        got = ops.double(Pj)
        args, want_pts = P, [a + a for a in ps]
    elif kind == "padd":
        got = ops.add(Pj, JacPoint(*Q))
        args, want_pts = P + Q, [a + b for a, b in zip(ps, qs)]
    else:
        got = ops.madd(Pj, JacPoint(*Qa))
        args, want_pts = P + Qa, [a + b for a, b in zip(ps, qs)]
    want = _jax_body(kind, args, ops.b3)
    for g, w in zip((got.x, got.y, got.z), want):
        assert np.array_equal(g.numpy().astype(np.int64), w)
    assert ops.to_affine_host(got) == want_pts


def test_secp_proj_ops_identity():
    """The cached ops make their points on the card unless a call names
    another device; their identity, made on the CPU here, is (0 : 1 : 0):
    the python-int oracle's identity, neutral for padd and pmadd, and a
    fixed point of pdbl."""
    import inspect

    from zksnap_tpu_torch.curves.jacobian import JacPoint

    ops = secp_proj_ops()
    assert ops is secp_proj_ops() and ops.params is SECP256K1
    for fn in (ops.identity, ops.from_affine_host, ops.generator):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    ident = ops.identity((2,), device=DEV)
    assert ident.device == torch.device(DEV)
    assert ops.to_affine_host(ident) == [AffinePoint.identity(SECP256K1)] * 2
    g = AffinePoint.generator(SECP256K1)
    pts = [g, 7 * g]
    P = JacPoint(*_encode(ops, pts, random.Random(7), affine=False))
    Pa = JacPoint(*_encode(ops, pts, random.Random(7), affine=True))
    assert ops.to_affine_host(ops.add(P, ident)) == pts
    assert ops.to_affine_host(ops.madd(ident, Pa)) == pts
    assert ops.to_affine_host(ops.double(ident)) == [
        AffinePoint.identity(SECP256K1)] * 2
