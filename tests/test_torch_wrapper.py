"""The wrapper (recursion) circuit in the port (zksnap_tpu_torch.circuits
.wrapper, a copy of the JAX module run on the port's prover, verifier
and curves) against the JAX package, on the CPU, at the toy shape of
scripts/prove_wrapper_tpu.py --toy (K=7 children, truncated in-circuit
MSMs) at k_wrap=18: the script's k_wrap=16 no longer fits the logUp
budget in either package (ROADMAP §C).

The JAX package's toy children (their vks and two rounds of seeded
proofs), the shape its fixed-point solve reaches with the layout digest
of its last dummy synthesis, and each round's wrapper instances and
advice digest are frozen in tests/vectors/torch_port_v1.json
(`wrapper_toy`, scripts/gen_torch_port_vectors.py): the JAX keygens and
proofs cost minutes of XLA compile on the CPU.  The port rebuilds the same
traces from the same child proofs and self-commitments and must match
them cell for cell; the JAX package's host functions (dummy proofs,
shape accounting, digests, the default accumulator) run live beside the
port's.  A live JAX trace of a round and the port's child keygens are
marked slow, with the second round and the shape solve (each about
40 s on one CPU thread; chip_smoke.py drives both on the card).  Tolerance: none --
bytes and integers.
"""

import dataclasses
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from zksnap_tpu.circuits import wrapper as jwrapper
from zksnap_tpu.curves.jacobian import JacPoint as JJacPoint
from zksnap_tpu.curves.native import BN254_G1 as J_BN254
from zksnap_tpu.curves.native import AffinePoint as JAffine
from zksnap_tpu.prover import plonk as jplonk
from zksnap_tpu.prover import srs as jsrs
from zksnap_tpu.prover.keygen import layout_circuit as jlayout_circuit
from zksnap_tpu.prover.recursion import Snark as JSnark
from zksnap_tpu_torch.circuits import wrapper
from zksnap_tpu_torch.curves.native import BN254_G1, AffinePoint
from zksnap_tpu_torch.prover import plonk
from zksnap_tpu_torch.prover.keygen import layout_circuit
from zksnap_tpu_torch.prover.recursion import Snark
from zksnap_tpu_torch.prover.srs import gen_srs
from zksnap_tpu_torch.trace import Context, check

torch.set_num_threads(1)
DEV = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import prove_wrapper_torch as wrapper_script  # noqa: E402

sys.path.pop(0)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_wrapper as jtoy  # noqa: E402

sys.path.pop(0)


@pytest.fixture(scope="module")
def frozen():
    with open(os.path.join(ROOT, "tests", "vectors",
                           "torch_port_v1.json")) as f:
        return json.load(f)["wrapper_toy"]


def _vk(d: dict, vk_cls, affine, curve):
    """A VerifyingKey of either package from its frozen JSON form."""
    fields = {k: d[k] for k in ("k", "ext_log", "n_advice", "n_lookup",
                                "lookup_bits", "n_perm", "n_z", "usable",
                                "num_instance")}
    fields["deltas"] = [int(x) for x in d["deltas"]]
    fields["omega"] = int(d["omega"])
    fields["commitments"] = {
        nm: (affine.identity(curve) if xy == ["0", "0"]
             else affine(curve, int(xy[0]), int(xy[1])))
        for nm, xy in d["commitments"].items()}
    return vk_cls(**fields)


@pytest.fixture(scope="module")
def toy(frozen):
    """Both packages' toy configurations at the frozen solved shape, with
    the frozen child vks and the JAX package's default accumulator
    (G, [tau]G) as host points of each package."""
    out = {}
    srs = gen_srs(frozen["k_child"], device=DEV)
    acc = wrapper.default_accumulator(srs)
    for name, mod, vk_cls, affine, curve, pkg_acc in (
            ("port", wrapper, plonk.VerifyingKey, AffinePoint, BN254_G1,
             acc),
            ("jax", jwrapper, jplonk.VerifyingKey, JAffine, J_BN254, None)):
        vvk = _vk(frozen["voter_vk"], vk_cls, affine, curve)
        svk = _vk(frozen["state_vk"], vk_cls, affine, curve)
        if pkg_acc is None:
            pkg_acc = jwrapper.KzgAccumulator(
                lhs=JAffine(J_BN254, acc.lhs.x, acc.lhs.y),
                rhs=JAffine(J_BN254, acc.rhs.x, acc.rhs.y))
        cfg = mod.WrapperConfig(
            k=frozen["k_wrap"], lookup_bits=frozen["lookup_bits"],
            voter_vk=vvk, state_vk=svk,
            shape=mod.WrapperShape(**frozen["shape"]), default_acc=pkg_acc,
            linkage=mod.toy_linkage, n_payload=1,
            msm_window=frozen["msm_window"],
            msm_unsound_truncate=frozen["msm_unsound_truncate"])
        out[name] = cfg
    out["srs"] = srs
    return out


def _jsrs(srs):
    """A JAX SRS object over the port's point arrays (the same arrays,
    test_torch_prover.py's test_srs_matches_jax)."""
    import jax.numpy as jnp

    def pts(t):
        return jnp.asarray(t.numpy().astype(np.uint32))

    g1 = JJacPoint(pts(srs.g1.x), pts(srs.g1.y), pts(srs.g1.z))
    lag = JJacPoint(pts(srs.g1_lagrange.x), pts(srs.g1_lagrange.y),
                    pts(srs.g1_lagrange.z))
    return jsrs.SRS(srs.k, g1, lag, None, None)


def test_child_vks_frozen(frozen, toy):
    """The frozen child vks give their frozen digests in both packages'
    classes, and the port's toy children (scripts/prove_wrapper_torch.py)
    lay out as the JAX test's do."""
    for cfg in (toy["port"], toy["jax"]):
        assert chip_smoke.vk_digest(cfg.voter_vk) == frozen["voter_vk_sha256"]
        assert chip_smoke.vk_digest(cfg.state_vk) == frozen["state_vk_sha256"]
    outs = [tuple(o) for o in frozen["outs"]]
    assert wrapper_script.toy_chain(1) == outs[:1]   # the keygen's witnesses
    k = frozen["k_child"]
    for mine, ref in ((wrapper_script.toy_voter_ctx(outs[0][0]),
                       jtoy._toy_voter_ctx(outs[0][0])),
                      (wrapper_script.toy_state_ctx(*outs[0]),
                       jtoy._toy_state_ctx(*outs[0]))):
        a, b = layout_circuit(mine, k), jlayout_circuit(ref, k)
        assert chip_smoke.layout_digest(a) == chip_smoke.layout_digest(b)
        assert np.array_equal(mine.advice.limbs(), ref.advice.limbs())


@pytest.mark.parametrize("child", ["voter", "state"])
def test_dummy_proof_parses(toy, child):
    """gen_dummy_snark parity (wrapper.rs:254-273): a protocol-shaped
    random transcript runs the port's succinct verifier to the end, and
    its bytes are the JAX package's."""
    vk = getattr(toy["port"], f"{child}_vk")
    proof = wrapper.gen_dummy_proof(vk, seed=9)
    shape = wrapper.proof_shape(vk)
    assert len(proof) == sum(64 if s == "point" else 32 for s in shape)
    assert plonk.verify_succinct(vk, [0] * vk.num_instance, proof) is not None
    jvk = getattr(toy["jax"], f"{child}_vk")
    assert jwrapper.proof_shape(jvk) == shape
    assert jwrapper.gen_dummy_proof(jvk, seed=9) == proof


def test_shape_accounting_matches_layout():
    """The port's _shape_from_counts agrees with its layout_circuit and
    with the JAX package's accounting."""
    ctx = wrapper_script.toy_voter_ctx(23)
    layout = layout_circuit(ctx, 7)
    shape = wrapper._shape_from_counts(7, len(ctx.advice), ctx.gate_offsets,
                                       len(ctx.lookups))
    assert shape.n_advice == layout.n_advice
    assert shape.n_lookup == layout.n_lookup
    assert shape.n_perm == len(layout.perm_columns)
    ref = jwrapper._shape_from_counts(7, len(ctx.advice), ctx.gate_offsets,
                                      len(ctx.lookups))
    assert dataclasses.asdict(shape) == dataclasses.asdict(ref)


def test_default_accumulator_matches_jax(toy):
    """(G, [tau]G) from the port's SRS equals the JAX function's over the
    same points, and the pair decides."""
    from zksnap_tpu_torch.prover.accumulator import decide

    srs = toy["srs"]
    mine = wrapper.default_accumulator(srs)
    ref = jwrapper.default_accumulator(_jsrs(srs))
    for a, b in ((mine.lhs, ref.lhs), (mine.rhs, ref.rhs)):
        assert (a.x, a.y) == (b.x, b.y)
    assert mine.lhs == AffinePoint.generator(BN254_G1)
    assert decide(mine, srs.g2, srs.tau_g2)


def test_protocol_digest_and_initial_snark_match_jax(toy):
    cfg, jcfg = toy["port"], toy["jax"]
    comms = cfg.self_vk(None).commitments
    jcomms = jcfg.self_vk(None).commitments
    assert sorted(comms) == sorted(jcomms)
    for nm, pt in comms.items():
        assert (pt.x, pt.y) == (jcomms[nm].x, jcomms[nm].y)
    d = wrapper.protocol_digest(comms, cfg.k, cfg.num_instance)
    assert d == jwrapper.protocol_digest(jcomms, cfg.k, cfg.num_instance)
    mine = wrapper.initial_snark(cfg, comms)
    ref = jwrapper.initial_snark(jcfg, jcomms)
    assert mine.instances == ref.instances and mine.proof == ref.proof
    assert mine.instances[wrapper.DIGEST_ROW] == d
    assert wrapper._cfg_fingerprint(cfg) == jwrapper._cfg_fingerprint(jcfg)


def _round_inputs(frozen, cfg, mod, snark_cls, r: int, prev_inst=None):
    """Round r's WrapperRoundInput from the frozen child proofs, with the
    placeholder self-commitments; round 1's previous snark is a dummy
    proof over round 0's instances."""
    comms = cfg.self_vk(None).commitments
    vi, vo = frozen["outs"][r]
    vp, sp = (bytes.fromhex(h) for h in frozen["child_proofs"][r])
    voter = snark_cls(cfg.voter_vk, [vi], vp)
    state = snark_cls(cfg.state_vk, [vi, vo], sp)
    if r == 0:
        prev = mod.initial_snark(cfg, comms)
    else:
        prev = snark_cls(cfg.self_vk(comms), prev_inst,
                         mod.gen_dummy_proof(cfg.self_vk(comms), seed=11))
    return mod.WrapperRoundInput(round=r, voter=voter, state=state,
                                 prev=prev, self_commitments=comms)


def _advice_sha(ctx) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        ctx.advice.limbs()).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def port_rounds(frozen, toy):
    """The port's wrapper trace of a round from the frozen inputs (round
    1's previous instances the frozen round 0's), built on first use."""
    cfg, built = toy["port"], {}

    def get(r: int):
        if r not in built:
            prev = ([int(v) for v in frozen["rounds"][r - 1]["instances"]]
                    if r else None)
            win = _round_inputs(frozen, cfg, wrapper, Snark, r, prev)
            ctx = Context(lookup_bits=cfg.lookup_bits)
            inst = [c.value for c in wrapper.build_wrapper(ctx, cfg, win)]
            built[r] = (win, ctx, inst)
        return built[r]

    return get


@pytest.mark.parametrize("r", [0, pytest.param(1, marks=pytest.mark.slow)])
def test_wrapper_round_matches_jax(frozen, toy, port_rounds, r):
    """build_wrapper in the port gives the JAX package's instances and
    advice cells (frozen) from the same child proofs; the trace checks,
    and its rows outside the accumulator limbs equal wrapper_native's
    (tests/test_wrapper.py::test_two_round_ivc_checker's comparison).
    Round 0 takes about 40 s on one CPU thread; round 1, the same again,
    is slow."""
    win, ctx, inst = port_rounds(r)
    want = frozen["rounds"][r]
    assert [str(v) for v in inst] == want["instances"]
    assert (len(ctx.advice), len(ctx.lookups)) == (want["cells"],
                                                   want["lookups"])
    assert _advice_sha(ctx) == want["advice_sha256"]
    check(ctx, inst)
    native, _ = wrapper.wrapper_native(toy["port"], win)
    assert inst[12:] == native[12:]
    assert inst[-1] == r and inst[13] == frozen["outs"][r][1]


@pytest.mark.slow
def test_solved_shape_matches_frozen(frozen, toy):
    """The port's fixed-point solve, started at the JAX package's solved
    shape, confirms it in one dummy synthesis whose layout is the JAX
    one (digest frozen); about 40 s on one CPU thread.  On the card
    every run of scripts/prove_wrapper_torch.py makes this solve."""
    cfg, ctx = wrapper.solve_wrapper_shape(toy["port"])
    assert dataclasses.asdict(cfg.shape) == frozen["shape"]
    assert (len(ctx.advice), len(ctx.lookups)) == (frozen["dummy_cells"],
                                                   frozen["dummy_lookups"])
    lay = layout_circuit(ctx, cfg.k)
    assert chip_smoke.layout_digest(lay) == frozen["layout_sha256"]


@pytest.mark.slow
def test_wrapper_round_live_jax(frozen, toy, port_rounds):
    """Round 0 traced live by the JAX package: the same advice, lookups
    and instances as the port's."""
    jcfg = toy["jax"]
    win = _round_inputs(frozen, jcfg, jwrapper, JSnark, 0)
    from zksnap_tpu.trace import Context as JContext

    jctx = JContext(lookup_bits=jcfg.lookup_bits)
    jinst = [c.value for c in jwrapper.build_wrapper(jctx, jcfg, win)]
    _, ctx, inst = port_rounds(0)
    assert jinst == inst
    assert np.array_equal(jctx.advice.limbs(), ctx.advice.limbs())
    assert np.array_equal(jctx.lookups.array(), ctx.lookups.array())


@pytest.mark.slow
def test_child_keygen_frozen_digests(frozen):
    """The port's keygen of the toy children on the CPU gives the frozen
    JAX vk digests."""
    srs = gen_srs(frozen["k_child"], device=DEV)
    vi, vo = frozen["outs"][0]
    vpk = plonk.keygen(wrapper_script.toy_voter_ctx(vi), 7, srs, device=DEV)
    spk = plonk.keygen(wrapper_script.toy_state_ctx(vi, vo), 7, srs, device=DEV)
    assert chip_smoke.vk_digest(vpk.vk) == frozen["voter_vk_sha256"]
    assert chip_smoke.vk_digest(spk.vk) == frozen["state_vk_sha256"]
