"""The fused Pippenger reduction of the port (K5 `weighted_suffix`, K6
`ladder_tree`) against the JAX package and the host oracle.

The JAX `weighted_suffix_fused` and `ladder_tree_fused`, chained as the
JAX `msm_impl` chains them, are frozen in tests/vectors/torch_port_v1.json
(`fused_reduce`, by scripts/gen_torch_port_vectors.py: eager JAX takes
about 40 s a case on the CPU) for c=3, W=3 with signed digits and c=3,
W=2 unsigned, on seeded bucket sums with identity buckets, a window of
identities, P beside -P and equal buckets, and `ladder_tree_fused`
alone at W = 1 and W = 2 (`ladder_small`).  The port's plain K6 must
give the same projective integers mod p (the JAX CPU path keeps values
lazy in [0, 2p)) from the frozen JAX double suffix and window sums;
the port's plain K5 adds in another order than the JAX kernel's rounds
(a chunked, work-efficient suffix), so its double suffix is compared
with the JAX one as affine points, and with the python-int oracle's at
small shapes in both coordinate systems.  The port's
`msm_impl` at n=128 (c=8, W=32) gives the oracle's point with the fused
reduction on and off.  The PLUME voter's synthesis at k=21 is held to the
frozen JAX stats, instances and layout shape (slow: about 80 s).
Tolerance: none -- integers.
"""

import json
import os
import random

import pytest
import torch

from zksnap_tpu_torch.curves import fused
from zksnap_tpu_torch.curves.native import BN254_G1, AffinePoint
from zksnap_tpu_torch.curves.proj import bn254_proj_ops
from zksnap_tpu_torch.fields import bn254_fq, ints_to_limbs
from zksnap_tpu_torch.msm import pippenger

torch.set_num_threads(1)
DEV = "cpu"

VECTORS = os.path.join(os.path.dirname(__file__), "vectors",
                       "torch_port_v1.json")
B3 = 3 * BN254_G1.b


def _vectors(name):
    with open(VECTORS) as f:
        return json.load(f)[name]


CASES = _vectors("fused_reduce")
IDS = [f"c{v['c']}_W{v['W']}_{'signed' if v['signed'] else 'unsigned'}"
       for v in CASES]


def _flat(v):
    F = bn254_fq()
    rows = [[int(x) for x in r] for r in v["inputs"]]
    return tuple(F.to_mont([r[i] for r in rows], DEV) for i in range(3))


def _sel(v):
    return torch.arange(v["W"]) * v["B"] + (0 if v["signed"] else 1)


def _affine(xyz) -> AffinePoint:
    """Canonical projective integers (X : Y : Z) -> affine point."""
    x, y, z = (int(a) for a in xyz)
    q = BN254_G1.p
    if z % q == 0:
        return AffinePoint.identity(BN254_G1)
    zi = pow(z, -1, q)
    return AffinePoint(BN254_G1, x * zi % q, y * zi % q)


def _ints(coords):
    F = bn254_fq()
    cols = [F.from_mont(a) for a in coords]
    return ([[str(c[j]) for c in cols] for j in range(len(cols[0]))]
            if isinstance(cols[0], list) else [str(c) for c in cols])


@pytest.mark.parametrize("v", CASES, ids=IDS)
def test_plain_versions_match_frozen_jax(v):
    """K5's plain version gives the frozen JAX double suffix's points (its
    order of additions is not the JAX kernel's, so its projective
    integers differ); K6's, fed the frozen JAX double suffix, gives the
    frozen JAX integers."""
    F = bn254_fq()
    s2 = fused.weighted_suffix(_flat(v), v["B"], F.p, B3)
    assert ([_affine(r) for r in _ints(s2)]
            == [_affine(r) for r in v["s2"]])
    frozen = _flat(dict(v, inputs=v["s2"]))
    sel = _sel(v)
    t = fused.ladder_tree(tuple(a[sel] for a in frozen), v["c"], v["W"],
                          F.p, B3)
    assert _ints(t) == v["ladder"]


LADDER = _vectors("ladder_small")


@pytest.mark.parametrize("v", LADDER, ids=[f"c{v['c']}_W{v['W']}"
                                          for v in LADDER])
def test_ladder_tree_plain_matches_jax(v):
    """K6's plain version at W = 1 and W = 2 gives the JAX
    `ladder_tree_fused`'s integers (frozen: its eager CPU call takes
    about 25 s), which are the oracle's sum_w 2^(c*w) S_w."""
    F = bn254_fq()
    t = fused.ladder_tree(_flat(v), v["c"], v["W"], F.p, B3)
    assert _ints(t) == v["ladder"]
    want = AffinePoint.identity(BN254_G1)
    for w, r in enumerate(v["inputs"]):
        want = want + (1 << (v["c"] * w)) * _affine(r)
    assert _affine(v["ladder"]) == want


@pytest.mark.parametrize("v", CASES, ids=IDS)
def test_frozen_reduction_against_oracle(v):
    """The frozen points are the oracle's: s2[w*B + b] is
    sum_{b' >= b} (b' - b + 1) S[w, b'], and the ladder's point is
    sum_w 2^(c*w) s2[w*B + (0 if signed else 1)]."""
    W, B, c = v["W"], v["B"], v["c"]
    S = [_affine(r) for r in v["inputs"]]
    s2 = [_affine(r) for r in v["s2"]]
    total = AffinePoint.identity(BN254_G1)
    for w in range(W):
        for b in range(B):
            want = AffinePoint.identity(BN254_G1)
            for b2 in range(b, B):
                want = want + (b2 - b + 1) * S[w * B + b2]
            assert s2[w * B + b] == want, (w, b)
        total = total + (1 << (c * w)) * s2[w * B + (0 if v["signed"]
                                                     else 1)]
    assert _affine(v["ladder"]) == total


def _jac_affine(xyz) -> AffinePoint:
    """Canonical Jacobian integers (X : Y : Z) -> affine point."""
    x, y, z = (int(a) for a in xyz)
    q = BN254_G1.p
    if z % q == 0:
        return AffinePoint.identity(BN254_G1)
    zi = pow(z, -1, q)
    return AffinePoint(BN254_G1, x * zi * zi % q, y * zi * zi * zi % q)


@pytest.mark.parametrize("v", LADDER, ids=[f"c{v['c']}_W{v['W']}"
                                          for v in LADDER])
def test_ladder_tree_plain_jacobian_against_oracle(v):
    """K6's plain version in Jacobian coordinates (b3 == 0) on the same
    window sums as a general (X : Y : Z) = (x l^2 : y l^3 : l) gives the
    oracle's sum_w 2^(c*w) S_w."""
    q = BN254_G1.p
    rng = random.Random(v["c"] * 100 + v["W"])
    rows = []
    for r in v["inputs"]:
        pt, lam = _affine(r), rng.randrange(1, q)
        rows.append((0, lam, 0) if pt.is_identity() else
                    (lam * lam * pt.x % q, lam ** 3 * pt.y % q, lam))
    F = bn254_fq()
    flat = tuple(F.to_mont([r[i] for r in rows], DEV) for i in range(3))
    got = _jac_affine(_ints(fused.ladder_tree(flat, v["c"], v["W"], F.p, 0)))
    want = AffinePoint.identity(BN254_G1)
    for w, r in enumerate(v["inputs"]):
        want = want + (1 << (v["c"] * w)) * _affine(r)
    assert got == want


# (W, B, SUFFIX_LANES, CARRY_GROUP, CARRY_THREADS) of the small K5
# cases: B = 1; a window narrower than the chunk the lanes ask for (C
# clamped to B); a window of eight chunks of two, in one carry group of
# four threads of two totals (two Hillis-Steele rounds); the same in two
# groups of four totals, two threads each, whose sums take a second carry
# pass
SUFFIX_CASES = {"B1": (3, 1, 1 << 15, 64, 32), "B_below_C": (2, 4, 1, 64, 32),
                "chunks": (2, 16, 16, 64, 4),
                "groups": (2, 16, 16, 4, 2)}


@pytest.mark.parametrize("b3", [B3, 0], ids=["rcb", "jacobian"])
@pytest.mark.parametrize("case", sorted(SUFFIX_CASES))
def test_weighted_suffix_plain_against_oracle(case, b3, monkeypatch):
    """The plain K5 in the kernel's order of additions gives the oracle's
    double suffix s2[w*B + b] = sum_{b' >= b} (b' - b + 1) S[w, b'], in
    RCB projective (b3 != 0) and Jacobian (b3 == 0) coordinates, on
    bucket sums with identities, a window of identities (window 1), P
    beside -P and equal buckets."""
    W, B, lanes, group, threads = SUFFIX_CASES[case]
    monkeypatch.setattr(fused, "SUFFIX_LANES", lanes)
    monkeypatch.setattr(fused, "CARRY_GROUP", group)
    monkeypatch.setattr(fused, "CARRY_THREADS", threads)
    q = BN254_G1.p
    rng = random.Random(W * 1000 + B)
    g = AffinePoint.generator(BN254_G1)
    pool = [rng.randrange(1, BN254_G1.n) * g for _ in range(6)]
    ident = AffinePoint.identity(BN254_G1)
    S = [rng.choice(pool) for _ in range(W * B)]
    S[0] = ident
    if W * B > 4:
        S[2], S[3], S[4] = pool[0], -pool[0], pool[0]
    if W > 1 and B > 1:
        S[B:2 * B] = [ident] * B
    rows = []
    for pt in S:
        lam = rng.randrange(1, q)
        if pt.is_identity():
            rows.append((0, lam, 0))
        elif b3:
            rows.append((lam * pt.x % q, lam * pt.y % q, lam))
        else:
            rows.append((lam * lam * pt.x % q, lam ** 3 * pt.y % q, lam))
    F = bn254_fq()
    flat = tuple(F.to_mont([r[i] for r in rows], DEV) for i in range(3))
    got = fused.weighted_suffix(flat, B, F.p, b3)
    to_affine = _affine if b3 else _jac_affine
    got = [to_affine(r) for r in _ints(got)]
    for w in range(W):
        run = acc = ident
        for b in range(B - 1, -1, -1):
            run = run + S[w * B + b]
            acc = acc + run
            assert got[w * B + b] == acc, (w, b)


@pytest.mark.parametrize("fused_reduce", ["0", "1"])
def test_msm_fused_and_unfused(fused_reduce, monkeypatch):
    """The port's msm_impl at the K=7 commit's shape (n=128, c=8, W=32,
    signed digits): the oracle's point with ZKSNAP_TPU_FUSED_REDUCE off
    and on; on, it reaches the plain K5 and K6."""
    monkeypatch.setenv("ZKSNAP_TPU_FUSED_REDUCE", fused_reduce)
    rng = random.Random(27)
    g = AffinePoint.generator(BN254_G1)
    base = [rng.randrange(1, BN254_G1.n) * g for _ in range(40)]
    pts = [rng.choice(base) for _ in range(128)]
    pts[4] = AffinePoint.identity(BN254_G1)
    ks = [rng.randrange(BN254_G1.n) for _ in range(128)]
    ks[2] = 0
    ks[3] = 1
    ks[6] = BN254_G1.n - 1
    want = AffinePoint.identity(BN254_G1)
    for k, p in zip(ks, pts):
        want = want + k * p
    ops = bn254_proj_ops()
    calls = []
    monkeypatch.setattr(pippenger, "weighted_suffix",
                        lambda *a: calls.append(1) or
                        fused.weighted_suffix(*a))
    r = pippenger.msm_impl(ops, ops.from_affine_host(pts, DEV),
                           torch.from_numpy(ints_to_limbs(ks)), 8, 32)
    got = ops.to_affine_host(type(r)(r.x[None], r.y[None], r.z[None]))[0]
    assert got == want
    assert len(calls) == int(fused_reduce)


def test_wrappers_dispatch_on_device():
    """A CPU tensor launches nothing; other devices and shapes raise."""
    F = bn254_fq()
    v = CASES[0]
    flat = _flat(v)
    before = (fused.weighted_suffix.launches, fused.ladder_tree.launches)
    s2 = fused.weighted_suffix(flat, v["B"], F.p, B3)
    fused.ladder_tree(tuple(a[:2] for a in s2), 3, 2, F.p, B3)
    assert (fused.weighted_suffix.launches,
            fused.ladder_tree.launches) == before
    meta = torch.empty((12, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        fused.weighted_suffix((flat[0], flat[1], meta), 4, F.p, B3)
    with pytest.raises(ValueError):
        fused.ladder_tree((meta[:3],) * 3, 3, 3, F.p, B3)
    big = torch.zeros((129, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        fused.ladder_tree((big, big, big), 3, 129, F.p, B3)


@pytest.mark.slow
def test_plume_synthesis_matches_frozen_jax():
    """The PLUME voter at k=21 (VoterFlags(), lookup_bits=14): the port's
    copied host layer synthesises, checks and lays it out with the frozen
    JAX stats, instances and vk shape."""
    from zksnap_tpu_torch.circuits.voter import VoterFlags, voter_circuit
    from zksnap_tpu_torch.natives import generate_random_voter_circuit_inputs
    from zksnap_tpu_torch.prover.keygen import (PERM_CHUNK, layout_circuit,
                                                quotient_ext_log)
    from zksnap_tpu_torch.trace import Context, check

    v = _vectors("voter_plume_k21")
    inp = generate_random_voter_circuit_inputs(random.Random(v["inputs_seed"]))
    ctx = Context(lookup_bits=v["lookup_bits"])
    pub = []
    voter_circuit(ctx, inp, pub, VoterFlags())
    inst = [c.value for c in pub]
    check(ctx, inst)
    assert [str(x) for x in inst] == v["instances"]
    assert {k: int(x) for k, x in ctx.stats().items()
            if isinstance(x, int)} == v["stats"]
    assert v["stats"]["advice_cells"] == 15_537_091
    lay = layout_circuit(ctx, v["k"])
    n_perm = len(lay.perm_columns)
    assert {"n_advice": lay.n_advice, "n_lookup": lay.n_lookup,
            "n_perm": n_perm, "n_z": -(-n_perm // PERM_CHUNK),
            "usable": lay.usable,
            "ext_log": quotient_ext_log(lay.n_lookup)} == v["vk_shape"]


# -- what chip_smoke.py reads of K3's to K6's kernels ------------------------

def test_formula_bound_takes_the_slowest_pipe():
    """The point formulas' bound: products on the IMAD pipe, adds and the
    products' conditional subtracts on the ALU pipe, 64 lanes an SM a
    clock each, the issue at 128, and HBM; the slowest decides, never
    above the single-pipe count it replaced."""
    import chip_smoke as cs

    n = 1 << 20
    muls, adds = cs.PADD
    imad = muls * cs.MUL_OPS
    got = cs.formula_bound([(n, cs.PADD)], 0)
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(
        n * imad / 64 / cs.SM_CLOCKS_PER_S * 1e3)
    single = n * (imad + adds * cs.ADD_OPS) / cs.INT32_OPS_PER_S * 1e3
    assert got["bound_ms"] < single
    # an adds-only formula is bound by the ALU pipe, a tiny one by bytes
    alu = cs.formula_bound([(n, (0, 64))], 0)
    assert alu["bound_ms"] == pytest.approx(
        n * 64 * cs.ADD_OPS / 64 / cs.SM_CLOCKS_PER_S * 1e3)
    assert cs.formula_bound([(1, cs.PADD)], 1 << 30)["bound_by"] == "bytes"
    # work adds up over formulas
    both = cs.formula_bound([(n, cs.PDBL), (n, cs.PADD)], 0)["bound_ms"]
    assert both == pytest.approx(
        cs.formula_bound([(n, cs.PDBL)], 0)["bound_ms"] + got["bound_ms"])


def test_ptxas_entries_reads_each_kernel():
    """Registers and the stack frame of each entry function, not of the
    functions it calls."""
    import chip_smoke as cs

    log = """ptxas info    : Compiling entry function '_Z3fooILb1EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z3fooILb1EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 252 registers, used 0 barriers
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    520 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers, 520 bytes cumulative stack size
ptxas info    : Function properties for _Z6fe_mulv
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""
    assert cs.ptxas_entries(log) == {
        "_Z3fooILb1EEvv": {"stack_bytes": 0, "spill_stores": 0,
                           "spill_loads": 0, "registers": 252},
        "_Z3barv": {"stack_bytes": 520, "spill_stores": 8,
                    "spill_loads": 4, "registers": 128}}


def test_kernel_sass_reads_loop_and_subroutines(monkeypatch):
    """A kernel's main loop, and the subroutines of its listing (a
    non-inlined call's body after EXIT) with their call sites."""
    import types

    import chip_smoke as cs

    ops = ["IMAD.WIDE.U32 R2, R4, R5, R2", "IADD3 R6, P0, R2, R7, RZ",
           "LDG.E.128 R8, desc[UR4][R10.64]", "CALL.REL.NOINC 0x100",
           "STL.64 [R1], R2", "@!P0 BRA 0x10", "EXIT",
           "IMAD.X R3, RZ, RZ, R3, P0", "LDL R4, [R1]", "RET.REL.NODEC R20 0x0"]
    lines = ["\t\tFunction : _Z18bucket_scan_kernelILb1EEvv"]
    addrs = [0x10, 0x20, 0x30, 0x40, 0x50, 0x60, 0x70, 0x100, 0x110, 0x120]
    lines += [f"        /*{a:04x}*/{' ' * 19}{op} ;" for a, op in
              zip(addrs, ops)]
    sass = "\n".join(lines) + "\n"
    monkeypatch.setattr(cs.os.path, "exists", lambda path: True)
    monkeypatch.setattr(cs.subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=sass))
    (got,) = cs.kernel_sass("lib.so", ("bucket_scan_kernel",)).values()
    loop = got["loop"]
    assert (loop["IMAD*"], loop["IADD3/LOP3/SHF/SEL"], loop["LDG/STG"],
            loop["LDL/STL"], loop["CALL"], loop["all"]) == (1, 1, 1, 1, 1, 5)
    subs = got["subroutines"]
    assert set(subs) == {"0x10", "0x100"}
    assert subs["0x100"]["call_sites"] == 1
    assert subs["0x100"]["IMAD*"] == 1 and subs["0x100"]["LDL/STL"] == 1
    assert subs["0x10"]["all"] == 7


def test_inlined_reads_frame_and_calls(monkeypatch):
    """The report of the kernels that must run inlined: each one's
    registers and stack frame from its ptxas lines, its CALLs and local
    memory accesses from every part of its SASS listing; one with a frame,
    a CALL or a local access fails the run."""
    import types

    import chip_smoke as cs

    log = """ptxas info    : Compiling entry function '_Z12point_kernelILi3ELi2EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z12point_kernelILi3ELi2EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 0 barriers
ptxas info    : Compiling entry function '_Z18ladder_tree_kernelILb1EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z18ladder_tree_kernelILb1EEvv
    648 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 648 bytes cumulative stack size
"""
    listing = {"_Z12point_kernelILi3ELi2EEvv": ["IMAD.WIDE.U32 R2, R4, R5, R2",
                                               "EXIT"],
               "_Z18ladder_tree_kernelILb1EEvv": ["CALL.REL.NOINC 0x100",
                                                  "EXIT", "CALL.REL.NOINC 0x100",
                                                  "STL [R1], R2",
                                                  "RET.REL.NODEC R20 0x0"]}
    lines = []
    for name, ops in listing.items():
        lines.append(f"\t\tFunction : {name}")
        addrs = [0x10, 0x20, 0x100, 0x110, 0x120][:len(ops)]
        lines += [f"        /*{a:04x}*/{' ' * 19}{op} ;"
                  for a, op in zip(addrs, ops)]
    sass = "\n".join(lines) + "\n"
    monkeypatch.setattr(cs.os.path, "exists", lambda path: True)
    monkeypatch.setattr(cs.subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=sass))
    frags = ("point_kernelILi3E", "ladder_tree_kernelILb1E")
    got = cs.inlined(cs.ptxas_entries(log), cs.kernel_sass("lib.so", frags),
                     frags)
    assert got == {
        "point_kernelILi3E": {"kernel": "_Z12point_kernelILi3ELi2EEvv",
                              "registers": 122, "stack_bytes": 0,
                              "calls": 0, "local": 0},
        "ladder_tree_kernelILb1E": {"kernel": "_Z18ladder_tree_kernelILb1EEvv",
                                    "registers": 128, "stack_bytes": 648,
                                    "calls": 2, "local": 1}}
    cs.require_inlined({"point_kernelILi3E": got["point_kernelILi3E"]})
    with pytest.raises(RuntimeError, match="not inlined"):
        cs.require_inlined(got)
    with pytest.raises(RuntimeError, match="not inlined"):
        cs.require_inlined({"point_kernelILi3E": dict(
            got["point_kernelILi3E"], local=1)})
    with pytest.raises(RuntimeError, match="one kernel"):
        cs.inlined(cs.ptxas_entries(log), {}, frags)
