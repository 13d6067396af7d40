"""The fused Pippenger reduction of the port (K5 `weighted_suffix`, K6
`ladder_tree`) against the JAX package and the host oracle.

The JAX `weighted_suffix_fused` and `ladder_tree_fused`, chained as the
JAX `msm_impl` chains them, are frozen in tests/vectors/torch_port_v1.json
(`fused_reduce`, by scripts/gen_torch_port_vectors.py: eager JAX takes
about 40 s a case on the CPU) for c=3, W=3 with signed digits and c=3,
W=2 unsigned, on seeded bucket sums with identity buckets, a window of
identities, P beside -P and equal buckets.  The port's plain versions
must give the same projective integers mod p (the JAX CPU path keeps
values lazy in [0, 2p)), and the python-int oracle's points.  The port's
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
    """K5's and K6's plain versions give the frozen JAX integers."""
    F = bn254_fq()
    s2 = fused.weighted_suffix(_flat(v), v["B"], F.p, B3)
    assert _ints(s2) == v["s2"]
    sel = _sel(v)
    t = fused.ladder_tree(tuple(a[sel] for a in s2), v["c"], v["W"], F.p,
                          B3)
    assert _ints(t) == v["ladder"]


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
