"""The port's MSMs and NTT against the JAX package and the host oracle.

Variable-base Pippenger (`msm.pippenger`) and the fixed-base commit
(`msm.fixed_base`, the path every k=13 commit takes) are held to the
oracle sum over `curves.native` points, with zero scalars, duplicate
points and identities; their digit decompositions to the JAX package's
bit for bit, and the projective MSM to the JAX `bn254_msm_proj()`
result frozen in tests/vectors/torch_port_v1.json (compiling it costs
minutes on the CPU).  The NTT is bit-exact against the JAX `ntt(k)`.
Tolerance: none.
"""

import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksnap_tpu.fields import ints_to_limbs as j_ints_to_limbs
from zksnap_tpu.msm import pippenger as jpip
from zksnap_tpu.poly.domain import domain as jdomain
from zksnap_tpu.poly.ntt import ntt as jntt
from zksnap_tpu_torch.curves.native import BN254_G1, AffinePoint
from zksnap_tpu_torch.curves.proj import bn254_proj_ops
from zksnap_tpu_torch.fields import bn254_fr, ints_to_limbs
from zksnap_tpu_torch.msm import fixed_base, pippenger
from zksnap_tpu_torch.poly.domain import domain
from zksnap_tpu_torch.poly.ntt import ntt
from zksnap_tpu_torch.prover import poly_device

torch.set_num_threads(1)
DEV = "cpu"


def _points_and_scalars(rng, n):
    """n affine points (duplicates and identities among them) and
    scalars (zeros, ones, n - 1 and full-width values)."""
    g = AffinePoint.generator(BN254_G1)
    base = [rng.randrange(1, BN254_G1.n) * g for _ in range(n // 3)]
    pts = [rng.choice(base) for _ in range(n)]
    pts[1] = pts[0]
    pts[4] = AffinePoint.identity(BN254_G1)
    ks = [rng.randrange(BN254_G1.n) for _ in range(n)]
    ks[2] = ks[5] = 0
    ks[3] = 1
    ks[6] = BN254_G1.n - 1
    return pts, ks


def _oracle(pts, ks):
    acc = AffinePoint.identity(BN254_G1)
    for k, p in zip(ks, pts):
        acc = acc + k * p
    return acc


def test_digits_match_jax():
    rng = random.Random(21)
    ks = [0, 1, BN254_G1.n - 1] + [rng.randrange(BN254_G1.n)
                                   for _ in range(13)]
    t = torch.from_numpy(ints_to_limbs(ks))
    j = jnp.asarray(j_ints_to_limbs(ks))
    for c in (6, 8, 13, 16):
        w = -(-254 // c)
        for win in (0, 1, w - 1):
            assert np.array_equal(
                pippenger.window_digits(t, c, win).numpy(),
                np.asarray(jpip.window_digits(j, c, win)).astype(np.int64))
        assert np.array_equal(
            pippenger.signed_digits(t, c, w).numpy(),
            np.asarray(jpip.signed_digits(j, c, w)).astype(np.int64))


@pytest.mark.parametrize("signed", [True, False])
def test_variable_base_msm(signed):
    rng = random.Random(22)
    pts, ks = _points_and_scalars(rng, 40)
    ops = bn254_proj_ops()
    msm = pippenger.MSM(ops, signed=signed)
    got = msm(ops.from_affine_host(pts, DEV), torch.from_numpy(ints_to_limbs(ks)))
    assert ops.to_affine_host(
        type(got)(got.x[None], got.y[None], got.z[None]))[0] == _oracle(
            pts, ks)


def test_jacobian_msm_and_lanes():
    """The Jacobian MSM, and a lane count that leaves padded stream
    rows and segments crossing lanes."""
    rng = random.Random(23)
    pts, ks = _points_and_scalars(rng, 30)
    want = _oracle(pts, ks)
    scal = torch.from_numpy(ints_to_limbs(ks))
    jac = pippenger.bn254_msm()
    r = jac(jac.ops.from_affine_host(pts, DEV), scal)
    ops = bn254_proj_ops()
    q = pippenger.msm_impl(ops, ops.from_affine_host(pts, DEV), scal, 8, 32,
                           lanes=7)
    for o, got in ((jac.ops, r), (ops, q)):
        assert o.to_affine_host(
            type(got)(got.x[None], got.y[None], got.z[None]))[0] == want


@pytest.mark.parametrize("c", [8, 16])
def test_fixed_base_equals_variable_base(c):
    """commit_fixed over a shifted table (c = 16 is the k=13 commit's
    window) equals the variable-base commit and the oracle, with an
    identity among the fixed points."""
    rng = random.Random(24)
    n = 24
    pts, ks = _points_and_scalars(rng, n)
    ops = bn254_proj_ops()
    P = ops.from_affine_host(pts, DEV)
    scal = torch.from_numpy(ints_to_limbs(ks))
    table = fixed_base.build_table(P, n, c)
    assert table.x.shape == (table.n_windows * n, 16)
    # identity rows of the table are the RCB identity (0, 1, 0): the
    # stream point pts[4] has a non-zero scalar, so its bucket segment
    # may restart from it
    one = ops.F.one_t("cpu")
    for w in range(table.n_windows):
        row = w * n + 4
        assert int(table.x[row].abs().sum() + table.z[row].abs().sum()) == 0
        assert torch.equal(table.y[row], one)
    fixed = fixed_base.commit_fixed(table, scal)
    var = poly_device.commit_evals(P, scal)   # n < 2^12: variable base
    from zksnap_tpu_torch.curves.jacobian import bn254_ops

    jops = bn254_ops()
    as_batch = [type(r)(r.x[None], r.y[None], r.z[None]) for r in (fixed, var)]
    want = _oracle(pts, ks)
    assert [jops.to_affine_host(r)[0] for r in as_batch] == [want, want]


def test_msm_matches_frozen_jax_msm():
    """The port's projective MSM against the JAX package's compiled
    `bn254_msm_proj()` on the same seeded points and scalars, frozen by
    scripts/gen_torch_port_vectors.py (the compile takes minutes)."""
    path = os.path.join(os.path.dirname(__file__), "vectors",
                        "torch_port_v1.json")
    with open(path) as f:
        v = json.load(f)["msm_proj"]
    pts, ks = _points_and_scalars(random.Random(v["seed"]), v["n"])
    ops = bn254_proj_ops()
    r = pippenger.bn254_msm_proj()(ops.from_affine_host(pts, DEV),
                                   torch.from_numpy(ints_to_limbs(ks)))
    got = ops.to_affine_host(type(r)(r.x[None], r.y[None], r.z[None]))[0]
    assert (hex(got.x), hex(got.y)) == (v["x"], v["y"])
    assert got == _oracle(pts, ks)


@pytest.mark.parametrize("k", [3, 6])
def test_ntt_matches_jax(k):
    F = bn254_fr()
    rng = np.random.default_rng(26 + k)
    vals = [int(v) for v in rng.integers(0, 1 << 62, size=1 << k)]
    vals = [v * v % F.p for v in vals]
    x = F.to_mont(vals, DEV)
    jx = jnp.asarray(x.numpy().astype(np.uint32))
    fwd = ntt(k).forward(x)
    assert np.array_equal(
        fwd.numpy(), np.asarray(jntt(k).forward(jx)).astype(np.int32))
    inv = ntt(k).inverse(fwd)
    assert np.array_equal(inv.numpy(), x.numpy())
    assert np.array_equal(
        inv.numpy(), np.asarray(jntt(k).inverse(
            jnp.asarray(fwd.numpy().astype(np.uint32)))).astype(np.int32))
    # the prover's entry points are the same transform
    assert np.array_equal(poly_device.coeffs_to_evals(x, k).numpy(),
                          fwd.numpy())
    assert np.array_equal(poly_device.evals_to_coeffs(fwd, k).numpy(),
                          x.numpy())


def test_domain_and_powers_match_jax():
    F = bn254_fr()
    for k in (1, 5, 13):
        d, jd = domain(k), jdomain(k)
        assert (d.n, d.omega, d.omega_inv, d.n_inv) == (
            jd.n, jd.omega, jd.omega_inv, jd.n_inv)
    d = domain(5)
    assert F.from_mont(d.twiddles(DEV)) == jdomain(5).omega_powers_host(16)
    assert F.from_mont(d.twiddles_inv(DEV)) == [
        pow(d.omega_inv, i, F.p) for i in range(16)]
    assert F.from_mont(poly_device.pow_series(7, 11, DEV)) == [
        pow(7, i, F.p) for i in range(11)]
    s = poly_device.pow_series(d.omega, 32, DEV)
    assert F.from_mont(poly_device.coset_evals(
        poly_device.evals_to_coeffs(s, 5), F.one_t(DEV)[None].expand(32, 16),
        5)) == F.from_mont(s)
