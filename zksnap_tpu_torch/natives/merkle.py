# Copy of zksnap_tpu/natives/merkle.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""Native Poseidon Merkle trees (host oracle + batched device builder).

Mirrors voter/src/merkletree/native.rs (`MerkleTree::{new,get_root,get_proof,
verify_proof,get_leaf_proof}`): a binary Poseidon tree whose node hash is
`sponge.update([left, right]); sponge.squeeze_and_reset()`.

`build_tree_device` is the TPU-first path: one batched fixed-length Poseidon
hash per level (the whole level is a single vmapped permutation chain).
"""

from __future__ import annotations


from ..hash.poseidon import PoseidonNative, PoseidonSpec, default_spec, hash_fixed_batched


class MerkleTree:
    """Host-side oracle over python ints; reference native.rs:5-114."""

    def __init__(self, leaves: list[int], spec: PoseidonSpec | None = None):
        if not leaves:
            raise ValueError("Cannot create Merkle Tree with no leaves")
        if len(leaves) > 1 and len(leaves) % 2 == 1:
            raise ValueError("Leaves must be even")
        self.spec = spec or default_spec()
        self._h = PoseidonNative(self.spec)
        self.tree = [list(leaves)]
        level = list(leaves)
        while len(level) > 1:
            nxt = []
            for i in range(0, len(level), 2):
                self._h.update([level[i], level[i + 1]])
                nxt.append(self._h.squeeze_and_reset())
            self.tree.append(nxt)
            level = nxt
        self.root = level[0]

    def get_root(self) -> int:
        return self.root

    def get_proof(self, index: int) -> tuple[list[int], list[int]]:
        """-> (sibling values, helper bits: 1 if current node is a left child)."""
        proof, helper = [], []
        cur = index
        for level in self.tree[:-1]:
            is_left = cur % 2 == 0
            sibling = level[cur + 1] if is_left else level[cur - 1]
            proof.append(sibling)
            helper.append(1 if is_left else 0)
            cur //= 2
        return proof, helper

    def verify_proof(self, leaf: int, index: int, root: int, proof: list[int]) -> bool:
        computed = leaf
        cur = index
        for sibling in proof:
            pair = [computed, sibling] if cur % 2 == 0 else [sibling, computed]
            self._h.update(pair)
            computed = self._h.squeeze_and_reset()
            cur //= 2
        return computed == root

    def get_leaf_proof(self, leaf: int) -> tuple[list[int], list[int]]:
        idx = self.tree[0].index(leaf)
        return self.get_proof(idx)


def build_tree_device(leaves, spec: PoseidonSpec | None = None):
    """Batched device tree build.

    leaves: [n, 16] Montgomery limb tensor, n a power of two.
    Returns list of levels [n,16], [n/2,16], ..., [1,16] (device tensors).
    Each level is ONE batched Poseidon call (n/2 sponges in parallel).
    """
    spec = spec or default_spec()
    n = leaves.shape[0]
    assert n & (n - 1) == 0, "power-of-two leaves"
    levels = [leaves]
    cur = leaves
    while cur.shape[0] > 1:
        pairs = cur.reshape(cur.shape[0] // 2, 2, cur.shape[-1])
        cur = hash_fixed_batched(pairs, spec)
        levels.append(cur)
    return levels


# --- Indexed Merkle tree (nullifier set) -----------------------------------
# Reference: indexed-merkle-tree-halo2 `utils::{IndexedMerkleTree, IndexedMerkleTreeLeaf}`
# used by aggregator/src/utils.rs:14,117-162.  Leaves are linked-list nodes
# {val, next_val, next_idx}; the tree itself hashes leaf digests
# Poseidon(val, next_val, next_idx) exactly like the plain Merkle tree.


class IMTLeaf:
    __slots__ = ("val", "next_val", "next_idx")

    def __init__(self, val: int = 0, next_val: int = 0, next_idx: int = 0):
        self.val, self.next_val, self.next_idx = val, next_val, next_idx

    def clone(self) -> "IMTLeaf":
        return IMTLeaf(self.val, self.next_val, self.next_idx)

    def __repr__(self):
        return f"IMTLeaf(val={self.val}, next_val={self.next_val}, next_idx={self.next_idx})"

    def __eq__(self, other):
        return (self.val, self.next_val, self.next_idx) == (
            other.val, other.next_val, other.next_idx)


def hash_imt_leaf(leaf: IMTLeaf, spec: PoseidonSpec | None = None) -> int:
    h = PoseidonNative(spec or default_spec())
    h.update([leaf.val, leaf.next_val, leaf.next_idx])
    return h.squeeze_and_reset()


class IndexedMerkleTree(MerkleTree):
    """Same tree as MerkleTree (built from pre-hashed leaf digests)."""
    pass
