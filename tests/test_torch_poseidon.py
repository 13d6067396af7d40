"""Poseidon's batched path and the device Merkle tree of the port
(zksnap_tpu_torch.hash.poseidon, natives.merkle) against the JAX package,
on the CPU.

The JAX batched hash compiles its 65-round chain once per input shape
(5-9 s each on the CPU), so its outputs on seeded inputs (widths 1 to 5, two
permutation states, an 8-leaf tree) are frozen in
tests/vectors/torch_port_v1.json (`poseidon`, written by
scripts/gen_torch_port_vectors.py) and one shape, a tree level's [4, 2],
runs live.  The JAX package's native sponge and `MerkleTree` run live on
every input.  Tolerance: none -- canonical integers.
"""

import json
import os
import random

import pytest
import torch

from zksnap_tpu.hash import hash_fixed_batched as jax_hash_fixed_batched
from zksnap_tpu.hash import hash_fixed_native as jax_hash_fixed_native
from zksnap_tpu.hash.poseidon import default_spec as jax_default_spec
from zksnap_tpu.natives.merkle import MerkleTree as JaxMerkleTree
from zksnap_tpu_torch.fields.field import bn254_fr
from zksnap_tpu_torch.hash import default_spec, hash_fixed_batched
from zksnap_tpu_torch.hash.poseidon import PoseidonNative
from zksnap_tpu_torch.natives.merkle import MerkleTree, build_tree_device

torch.set_num_threads(1)
DEV = "cpu"
F = bn254_fr()
VECTORS = os.path.join(os.path.dirname(__file__), "vectors")


def _vectors(name):
    with open(os.path.join(VECTORS, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def frozen():
    """The frozen JAX outputs and the seeded inputs they were made from
    (scripts/gen_torch_port_vectors.py `poseidon_inputs`)."""
    v = _vectors("torch_port_v1.json")["poseidon"]
    rng = random.Random(v["seed"])
    inp = {
        "widths": {str(n): [[rng.randrange(F.p) for _ in range(n)]
                            for _ in range(3)] for n in range(1, 6)},
        "states": [[rng.randrange(F.p) for _ in range(3)] for _ in range(2)],
        "leaves": [rng.randrange(F.p) for _ in range(8)]}
    return v, inp


def _mont(rows):
    return F.to_mont([x for r in rows for x in r], device=DEV).reshape(
        len(rows), len(rows[0]), 16)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_hash_fixed_batched_matches_jax(frozen, n):
    v, inp = frozen
    rows = inp["widths"][str(n)]
    got = F.from_mont(hash_fixed_batched(_mont(rows)))
    assert [str(x) for x in got] == v["hashes"][str(n)]
    assert got == [jax_hash_fixed_native(r) for r in rows]


def test_hash_fixed_batched_live_jax():
    """One shape against the JAX batched hash run live: [4, 2], the first
    level of an 8-leaf tree; leading batch dims of the port's call are
    kept ([2, 2, 2] in, [2, 2] out)."""
    import numpy as np

    from zksnap_tpu.fields import bn254_fr as jax_bn254_fr

    jf = jax_bn254_fr()
    rng = random.Random(2)
    rows = [[rng.randrange(F.p) for _ in range(2)] for _ in range(4)]
    want = jf.from_mont(jax_hash_fixed_batched(
        jf.to_mont([x for r in rows for x in r]).reshape(4, 2, 16)))
    mine = hash_fixed_batched(_mont(rows).reshape(2, 2, 2, 16))
    assert mine.shape == (2, 2, 16) and mine.dtype == torch.int32
    assert F.from_mont(mine.reshape(4, 16)) == want
    # the same limbs as the JAX package keeps (uint32 there)
    assert np.array_equal(
        mine.reshape(4, 16).numpy(),
        np.asarray(jf.to_mont(want)).astype(np.int32))


def test_permute_matches_jax(frozen):
    v, inp = frozen
    st = _mont(inp["states"])
    out = default_spec().permute(st)
    assert out.shape == st.shape
    got = [F.from_mont(out[i]) for i in range(2)]
    assert [[str(x) for x in g] for g in got] == v["permute"]
    spec = jax_default_spec()
    assert got == [spec.permute_native(s) for s in inp["states"]]


def test_round_constants_match_jax():
    """rc_mont and mds_mont hold the JAX package's Montgomery limbs."""
    import numpy as np

    mine, ref = default_spec(), jax_default_spec()
    for a, b in ((mine.rc_mont, ref.rc_mont), (mine.mds_mont, ref.mds_mont)):
        assert a.dtype == np.int32 and a.shape == b.shape
        assert np.array_equal(a, np.asarray(b).astype(np.int32))


def test_build_tree_device_matches_jax(frozen):
    v, inp = frozen
    leaves = inp["leaves"]
    levels = build_tree_device(F.to_mont(leaves, device=DEV))
    assert [lv.shape[0] for lv in levels] == [8, 4, 2, 1]
    got = [F.from_mont(lv.reshape(-1, 16)) for lv in levels]
    got = [g if isinstance(g, list) else [g] for g in got]
    assert [[str(x) for x in g] for g in got] == v["tree"]
    ref = JaxMerkleTree(leaves)
    assert got == ref.tree and got == MerkleTree(leaves).tree
    assert got[-1] == [ref.get_root()]


def test_frozen_sponge_vectors():
    """The frozen `poseidon_permute` and `poseidon_sponge` vectors of
    tests/vectors/transcript_v1.json: one permutation, and two fixed-
    length hashes (update, squeeze_and_reset) through the batched path
    and the native sponge."""
    v = _vectors("transcript_v1.json")
    perm = v["poseidon_permute"]
    st = F.to_mont([int(x) for x in perm["in"]], device=DEV)
    got = F.from_mont(default_spec().permute(st[None])[0])
    assert [str(x) for x in got] == perm["out"]
    sp = v["poseidon_sponge"]
    for upd, want in zip(sp["updates"], sp["squeezes"]):
        x = F.to_mont([int(u) for u in upd], device=DEV)[None]
        assert str(F.from_mont(hash_fixed_batched(x)[0])) == want
        h = PoseidonNative()
        h.update([int(u) for u in upd])
        assert str(h.squeeze_and_reset()) == want
