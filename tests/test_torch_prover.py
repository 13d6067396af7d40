"""The port's prover (zksnap_tpu_torch.prover) against the JAX package.

On the frozen K=7 circuit of scripts/gen_protocol_vectors.py, on the CPU:
the port's dev SRS is the JAX package's (the frozen sha256 of the JAX
cache file's arrays, and `srs_from_numpy` of them); its keygen gives the
frozen vk digest; its verifier accepts the frozen JAX proof; a seeded
port proof is byte-identical to the frozen seeded JAX proof
(tests/vectors/torch_port_v1.json); the JAX verifier accepts the port's
proof and rejects tampered, truncated and wrong-instance ones.  One
keygen and one proof serve the module.  The voter circuit at k=13 and
a seeded proof on a virtual mesh are marked slow.  Tolerance: none --
bytes and integers.
"""

import dataclasses
import hashlib
import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from zksnap_tpu.curves.jacobian import JacPoint as JJacPoint
from zksnap_tpu.curves.native import BN254_G1 as J_BN254
from zksnap_tpu.curves.native import AffinePoint as JAffine
from zksnap_tpu.prover import pairing as jpairing
from zksnap_tpu.prover import plonk as jplonk
from zksnap_tpu.prover import srs as jsrs
from zksnap_tpu.prover.keygen import Layout as JLayout
from zksnap_tpu_torch.curves.jacobian import CurveOps
from zksnap_tpu_torch.curves.proj import ProjOps
from zksnap_tpu_torch.experiments import (exp_mul_mxu, exp_mul_variants,
                                          exp_vpu_rates)
from zksnap_tpu_torch.fields.field import PrimeField
from zksnap_tpu_torch.parallel import initialize, make_mesh, protocol_mesh
from zksnap_tpu_torch.poly.domain import Domain
from zksnap_tpu_torch.prover import device_rounds, plonk, poly_device, serialize
from zksnap_tpu_torch.prover.convert import pk_from_numpy, srs_from_numpy
from zksnap_tpu_torch.prover.srs import (gen_srs, load_srs, srs_cache_path,
                                         srs_from_arrays)
from zksnap_tpu_torch.prover.warmup import warm_prove

torch.set_num_threads(1)

VECTORS = os.path.join(os.path.dirname(__file__), "vectors")
ARRAYS = ("x", "y", "z", "lx", "ly", "lz")


def _vectors(name):
    with open(os.path.join(VECTORS, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's SRS (made here, in a fresh directory), keygen of the
    frozen circuit and one proof seeded as the frozen JAX proof."""
    cache = str(tmp_path_factory.mktemp("srs"))
    srs = gen_srs(7, cache_dir=cache, device="cpu")
    pk = plonk.keygen(chip_smoke.build_fixed_circuit(), 7, srs,
                      device="cpu")
    v = _vectors("torch_port_v1.json")["seeded_proof_k7"]
    inst = [int(x) for x in v["instances"]]
    proof = plonk.prove(pk, inst, random.Random(v["rng_seed"]))
    return dict(cache=cache, srs=srs, pk=pk, inst=inst, proof=proof,
                frozen=v)


def _jax_affine(pt):
    if pt.is_identity():
        return JAffine.identity(J_BN254)
    return JAffine(J_BN254, pt.x, pt.y)


@pytest.fixture(scope="module")
def jax_verifier(port):
    """The JAX verifier over the port's vk and SRS: the JAX `verify`
    looks its SRS up by k (for the instance commitment), so that lookup
    returns the port's points -- the same arrays, as test_srs_matches_jax
    shows -- instead of running the JAX SRS generation."""
    srs, vk = port["srs"], port["pk"].vk
    fields = {f.name: getattr(vk, f.name)
              for f in dataclasses.fields(jplonk.VerifyingKey)}
    fields["commitments"] = {k: _jax_affine(p)
                             for k, p in vk.commitments.items()}
    jvk = jplonk.VerifyingKey(**fields)
    tau = jsrs._tau_from_seed(b"dev")
    g2, tau_g2 = jpairing.G2_GEN, jpairing.g2_mul(jpairing.G2_GEN, tau)

    def pts(a):
        return jnp.asarray(a.numpy().astype(np.uint32))

    jsrs_obj = jsrs.SRS(7, JJacPoint(*(pts(t) for t in (srs.g1.x, srs.g1.y,
                                                          srs.g1.z))),
                        JJacPoint(*(pts(t) for t in (
                            srs.g1_lagrange.x, srs.g1_lagrange.y,
                            srs.g1_lagrange.z))), tau_g2, g2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jplonk, "gen_srs", lambda k, seed=b"dev": jsrs_obj)

        def verify(inst, proof):
            return jplonk.verify(jvk, g2, tau_g2, inst, proof)

        yield verify


def test_srs_matches_jax(port):
    """The six arrays the port caches are the JAX package's, bit for bit
    (sha256 of the JAX cache file, frozen), and `srs_from_numpy` of them
    is the port's SRS."""
    v = _vectors("torch_port_v1.json")["srs_k7"]
    d = np.load(srs_cache_path(7, b"dev", port["cache"]))
    h = hashlib.sha256()
    for name in ARRAYS:
        assert d[name].dtype == np.uint32 and d[name].shape == (128, 16)
        h.update(np.ascontiguousarray(d[name]).tobytes())
    assert h.hexdigest() == v["sha256"]
    srs = port["srs"]
    again = srs_from_numpy({k: d[k] for k in ARRAYS}, srs.tau_g2, srs.g2,
                           device="cpu")
    for a, b in ((again.g1, srs.g1), (again.g1_lagrange, srs.g1_lagrange)):
        for u, w in ((a.x, b.x), (a.y, b.y), (a.z, b.z)):
            assert torch.equal(u, w)
    assert (again.tau_g2, again.g2) == (srs.tau_g2, srs.g2)
    # G2 points of the JAX package's own type convert too
    tau = jsrs._tau_from_seed(b"dev")
    j_tau_g2 = jpairing.g2_mul(jpairing.G2_GEN, tau)
    from_jax = srs_from_numpy({k: d[k] for k in ARRAYS}, j_tau_g2,
                              jpairing.G2_GEN, device="cpu")
    assert (from_jax.tau_g2, from_jax.g2) == (srs.tau_g2, srs.g2)


def test_vk_digest_frozen(port):
    v = _vectors("transcript_v1.json")["proof_k7"]
    vk = port["pk"].vk
    for key, want in v["vk_shape"].items():
        assert getattr(vk, key) == want, key
    assert chip_smoke.vk_digest(vk) == v["vk_sha256"]
    assert port["frozen"]["vk_sha256"] == v["vk_sha256"]


def test_frozen_proof_verifies(port):
    v = _vectors("transcript_v1.json")["proof_k7"]
    srs, vk = port["srs"], port["pk"].vk
    proof = bytes.fromhex(v["proof_hex"])
    inst = [int(x) for x in v["instances"]]
    assert plonk.verify(vk, srs.g2, srs.tau_g2, inst, proof)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    assert not plonk.verify(vk, srs.g2, srs.tau_g2, inst, bytes(bad))


def test_seeded_proof_matches_frozen_jax_proof(port):
    assert port["proof"].hex() == port["frozen"]["proof_hex"]


@pytest.mark.slow
def test_mesh_seeded_proof_matches_frozen_jax_proof(port):
    """A seeded proof from the module's key on a virtual mesh of four CPU
    entries (every commit and NTT sharded) is the frozen seeded JAX
    proof, byte for byte: commitments are written as affine points.
    About two minutes on one CPU thread (slow); chip_smoke.py runs it on
    the card."""
    mesh = make_mesh((4,), ("x",), [torch.device("cpu")] * 4)
    proof = plonk.prove(port["pk"], port["inst"],
                        random.Random(port["frozen"]["rng_seed"]), mesh=mesh)
    assert proof.hex() == port["frozen"]["proof_hex"]


def test_jax_verifier_accepts_port_proof(port, jax_verifier):
    proof, inst = port["proof"], port["inst"]
    assert jax_verifier(inst, proof)
    srs, vk = port["srs"], port["pk"].vk
    assert plonk.verify(vk, srs.g2, srs.tau_g2, inst, proof)


@pytest.mark.parametrize("how", ["flipped", "truncated", "extended",
                                 "wrong_instance"])
def test_bad_proofs_rejected(port, jax_verifier, how):
    proof, inst = port["proof"], port["inst"]
    if how == "flipped":
        bad = bytearray(proof)
        bad[100] ^= 0x10
        proof = bytes(bad)
    elif how == "truncated":
        proof = proof[:-32]
    elif how == "extended":
        proof = proof + bytes(32)
    else:
        inst = [inst[0] + 1]
    srs, vk = port["srs"], port["pk"].vk
    assert not jax_verifier(inst, proof)
    assert not plonk.verify(vk, srs.g2, srs.tau_g2, inst, proof)


def test_verify_without_srs_in_memory(port, monkeypatch):
    """A verifier in a process that holds no SRS (a fresh host, no card)
    makes the instance commitment's few Lagrange points on the host: the
    same points as the SRS's, and the proof verifies."""
    from zksnap_tpu_torch.curves.jacobian import JacPoint, bn254_ops
    from zksnap_tpu_torch.prover import srs as srs_mod

    lag = port["srs"].g1_lagrange
    want = bn254_ops().to_affine_host(JacPoint(lag.x[:3], lag.y[:3],
                                               lag.z[:3]))
    monkeypatch.setattr(srs_mod, "_MEMO", {})
    assert srs_mod.lagrange_prefix(7, 3) == want
    plonk._instance_commitment_cache.cache_clear()
    try:
        srs, vk = port["srs"], port["pk"].vk
        assert plonk.verify(vk, srs.g2, srs.tau_g2, port["inst"],
                            port["proof"])
        bad = bytearray(port["proof"])
        bad[100] ^= 0x10
        assert not plonk.verify(vk, srs.g2, srs.tau_g2, port["inst"],
                                bytes(bad))
        assert srs_mod._MEMO == {}
    finally:
        plonk._instance_commitment_cache.cache_clear()


@pytest.mark.parametrize("n_inst", [1, 3, 8])
def test_instance_commitment_matches_jax(port, jax_verifier, monkeypatch,
                                         n_inst):
    """The port's instance commitment, its Lagrange points made on the
    host (no SRS in memory), equals the JAX verifier's, whose points come
    from its SRS, on seeded instances."""
    from zksnap_tpu_torch.prover import srs as srs_mod

    rng = random.Random(n_inst)
    inst = [rng.randrange(plonk.P) for _ in range(n_inst)]
    want = jplonk._instance_commitment(port["pk"].vk, inst)
    monkeypatch.setattr(srs_mod, "_MEMO", {})
    plonk._instance_commitment_cache.cache_clear()
    try:
        got = plonk._instance_commitment(port["pk"].vk, inst)
    finally:
        plonk._instance_commitment_cache.cache_clear()
    assert not want.is_identity()
    assert (got.x, got.y) == (want.x, want.y)


@pytest.mark.parametrize("fn", [
    gen_srs, srs_from_arrays, srs_from_numpy, plonk.keygen,
    PrimeField.to_mont, CurveOps.identity, CurveOps.from_affine_host,
    CurveOps.generator, ProjOps.identity, Domain.powers_of, Domain.twiddles,
    Domain.twiddles_inv, poly_device.pow_series_uncached,
    poly_device.pow_series, poly_device.to_device_poly,
    device_rounds._omega_pows_dev, load_srs, serialize.load_pk,
    plonk.LazyFixedCoeffs.__init__,
    exp_vpu_rates.make_chain, exp_vpu_rates.make_dot,
    exp_mul_variants.make_variant, exp_mul_mxu.make_kernel,
    make_mesh, protocol_mesh, initialize, warm_prove],
    ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    """The public entry points and tensor constructors run on the CUDA
    device unless the caller names another (the CPU tests name the
    CPU)."""
    import inspect

    assert inspect.signature(fn).parameters["device"].default == "cuda"


def _jax_key_parts(pk):
    """A port key's layout and vk as the JAX package's host objects."""
    jlayout = JLayout(**{f.name: getattr(pk.layout, f.name)
                         for f in dataclasses.fields(JLayout)})
    fields = {f.name: getattr(pk.vk, f.name)
              for f in dataclasses.fields(jplonk.VerifyingKey)}
    fields["commitments"] = {k: _jax_affine(p)
                             for k, p in pk.vk.commitments.items()}
    return jlayout, jplonk.VerifyingKey(**fields)


def test_pk_from_numpy_round_trip(port):
    """A key carried across as a JAX `ProvingKey` carries it: fixed
    coefficients as the JAX package keeps them at rest (uint16 limbs),
    its host `Layout` and its `VerifyingKey` with the JAX package's
    points.  The result equals the key it came from, its coefficients in
    the port's at-rest form (int16 bit patterns)."""
    pk = port["pk"]
    coeffs = {k: poly_device._u32(v).numpy().astype(np.uint16)
              for k, v in pk.fixed_coeffs.items()}
    jlayout, jvk = _jax_key_parts(pk)
    back = pk_from_numpy(coeffs, jlayout, jvk, port["srs"])
    assert back.vk == pk.vk
    assert chip_smoke.vk_digest(back.vk) == chip_smoke.vk_digest(pk.vk)
    assert sorted(back.fixed_coeffs) == sorted(pk.fixed_coeffs)
    for k, v in pk.fixed_coeffs.items():
        assert back.fixed_coeffs[k].dtype == torch.int16
        assert torch.equal(back.fixed_coeffs[k], v), k
    assert type(back.layout) is type(pk.layout)
    for f in dataclasses.fields(type(pk.layout)):
        assert getattr(back.layout, f.name) is getattr(pk.layout, f.name)
    assert back.srs is port["srs"]


def test_pk_from_numpy_lazy(port):
    """A JAX key whose fixed part is a `LazyFixedCoeffs` (built from the
    same layout) carries across as the port's: every fixed column's
    evaluations and coefficients equal the at-rest key's."""
    from zksnap_tpu.prover.plonk import LazyFixedCoeffs as JLazy

    pk = port["pk"]
    jlayout, jvk = _jax_key_parts(pk)
    back = pk_from_numpy(JLazy(jlayout, 7), jlayout, jvk, port["srs"])
    lazy = back.fixed_coeffs
    assert isinstance(lazy, plonk.LazyFixedCoeffs) and lazy.device == "cpu"
    assert sorted(lazy.keys()) == sorted(pk.fixed_coeffs)
    for nm, v in pk.fixed_coeffs.items():
        assert torch.equal(lazy[nm], poly_device._u32(v)), nm
        assert torch.equal(
            lazy.evals(nm), poly_device.coeffs_to_evals(v, 7)), nm
    assert back.vk == pk.vk


def test_pack_poly_round_trip():
    """The at-rest form keeps every limb's bits: int16 patterns that
    widen back to the int32 limbs, the JAX `pack_poly`'s uint16 bits."""
    import jax.numpy as jnp

    from zksnap_tpu.prover.poly_device import _u32 as jax_u32
    from zksnap_tpu.prover.poly_device import pack_poly as jax_pack

    gen = torch.Generator().manual_seed(7)
    x = torch.randint(0, 1 << 16, (64, 16), generator=gen, dtype=torch.int32)
    x[0] = 0xFFFF
    x[1] = 0x8000
    x[2] = 0x7FFF
    packed = poly_device.pack_poly(x)
    assert packed.dtype == torch.int16 and packed.shape == x.shape
    assert poly_device.pack_poly(packed) is packed
    assert torch.equal(poly_device._u32(packed), x)
    assert poly_device._u32(x) is x
    ref = np.asarray(jax_pack(jnp.asarray(x.numpy().astype(np.uint32))))
    assert ref.dtype == np.uint16
    assert np.array_equal(packed.numpy().view(np.uint16), ref)
    assert np.array_equal(np.asarray(jax_u32(jnp.asarray(ref))),
                          poly_device._u32(packed).numpy())


@pytest.fixture(scope="module")
def lazy_port(port, tmp_path_factory):
    """The K=7 keygen with its fixed columns lazy (the threshold forced
    to 0), and that key saved with save_pk and loaded back."""
    saved = plonk.LAZY_FIXED_BYTES
    plonk.LAZY_FIXED_BYTES = 0
    try:
        pk = plonk.keygen(chip_smoke.build_fixed_circuit(), 7, port["srs"],
                          device="cpu")
    finally:
        plonk.LAZY_FIXED_BYTES = saved
    path = str(tmp_path_factory.mktemp("lazy") / "k7.pk")
    serialize.save_pk(pk, path)
    return pk, serialize.load_pk(path, device="cpu")


def test_lazy_keygen_frozen_digest(port, lazy_port):
    """Lazy keygen gives the frozen vk digest, and its key survives
    save_pk / load_pk: the same host sources, on the loader's device."""
    pk, again = lazy_port
    assert isinstance(pk.fixed_coeffs, plonk.LazyFixedCoeffs)
    assert chip_smoke.vk_digest(pk.vk) == port["frozen"]["vk_sha256"]
    assert pk.vk == port["pk"].vk
    lazy, back = pk.fixed_coeffs, again.fixed_coeffs
    assert isinstance(back, plonk.LazyFixedCoeffs) and back.device == "cpu"
    assert back.keys() == lazy.keys()
    assert sorted(lazy.keys()) == sorted(port["pk"].fixed_coeffs)
    assert np.array_equal(back.sigma, lazy.sigma)
    for a, b in zip(back.q_cols + [back.const_col],
                    lazy.q_cols + [lazy.const_col]):
        assert np.array_equal(a, b)
    assert (back.table_col, back.active_col, back.deltas) == (
        lazy.table_col, lazy.active_col, lazy.deltas)
    assert again.vk == pk.vk


@pytest.mark.slow
def test_lazy_proof_matches_frozen_jax_proof(port, lazy_port):
    """A seeded proof from the reloaded lazy key is the frozen JAX proof,
    byte for byte, and verifies (about a minute on one CPU thread)."""
    _, again = lazy_port
    v = port["frozen"]
    proof = plonk.prove(again, port["inst"], random.Random(v["rng_seed"]))
    assert proof.hex() == v["proof_hex"]
    srs = port["srs"]
    assert plonk.verify(again.vk, srs.g2, srs.tau_g2, port["inst"], proof)


@pytest.mark.parametrize("n", [
    256, pytest.param(4096, marks=pytest.mark.slow)])
def test_fixed_base_switch(n, monkeypatch):
    """configure_fixed_base on and off gives the same commit
    (tests/test_curves_msm.py:95-123 for the JAX package): at n = 4096,
    the policy's lower edge (about 100 s on one CPU thread, slow), and at n = 256 with
    that edge moved down."""
    from zksnap_tpu_torch.curves.jacobian import bn254_ops
    from zksnap_tpu_torch.curves.native import AffinePoint, BN254_G1
    from zksnap_tpu_torch.fields.common import ints_to_limbs

    rng = random.Random(n)
    ops = bn254_ops()
    g = AffinePoint.generator(BN254_G1)
    pts = ops.from_affine_host(
        [rng.randrange(1, BN254_G1.n) * g for _ in range(64)] * (n // 64),
        device="cpu")
    scalars = [rng.randrange(BN254_G1.n) for _ in range(n)]
    scalars[0] = 0  # zero-digit bucket path
    sc = torch.from_numpy(ints_to_limbs(scalars))
    monkeypatch.setitem(poly_device._FB_STATE, "min_n", min(n, 1 << 12))
    try:
        poly_device.configure_fixed_base(enabled=True)
        fb = ops.to_affine_host(poly_device.commit_evals(pts, sc))[0]
        assert poly_device._FB_STATE["tables"].get(pts.x) is not None
        poly_device.configure_fixed_base(enabled=False)
        vb = ops.to_affine_host(poly_device.commit_evals(pts, sc))[0]
    finally:
        poly_device.configure_fixed_base(enabled=True)
    assert fb == vb
    assert (poly_device._FB_STATE["max_n"], poly_device._FB_STATE["c"]) == (
        1 << 20, 16)


@pytest.mark.slow
def test_voter_k13_proof():
    """The main path at the slice's shape on the CPU: voter circuit,
    k=13, PLUME off; the vk digest is the frozen JAX digest, the proof
    verifies and a flipped byte does not."""
    from zksnap_tpu_torch.circuits.voter import VoterFlags, voter_circuit
    from zksnap_tpu_torch.natives import generate_random_voter_circuit_inputs
    from zksnap_tpu_torch.trace import Context, check

    v = _vectors("torch_port_v1.json")["voter_k13"]
    inp = generate_random_voter_circuit_inputs(random.Random(v["inputs_seed"]))
    ctx = Context(lookup_bits=v["lookup_bits"])
    pub = []
    voter_circuit(ctx, inp, pub, VoterFlags(check_plume=False))
    inst = [c.value for c in pub]
    check(ctx, inst)
    assert [str(x) for x in inst] == v["instances"]
    srs = gen_srs(v["k"], device="cpu")
    pk = plonk.keygen(ctx, v["k"], srs, device="cpu")
    assert {k: getattr(pk.vk, k) for k in v["vk_shape"]} == v["vk_shape"]
    assert chip_smoke.vk_digest(pk.vk) == v["vk_sha256"]
    proof = plonk.prove(pk, inst, random.Random(1))
    assert plonk.verify(pk.vk, srs.g2, srs.tau_g2, inst, proof)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    assert not plonk.verify(pk.vk, srs.g2, srs.tau_g2, inst, bytes(bad))
