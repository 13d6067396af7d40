# Frozen copy of the host tree of zksnap_tpu_torch/natives/merkle.py for the benchmark.
"""Binary Poseidon Merkle tree over python ints (the reference's
voter/src/merkletree/native.rs): a node is `update([left, right]);
squeeze_and_reset()`."""

from __future__ import annotations

from .poseidon import PoseidonNative


class MerkleTree:
    def __init__(self, leaves: list[int]):
        if not leaves or (len(leaves) > 1 and len(leaves) % 2):
            raise ValueError("a tree needs a positive, even number of leaves")
        self._h = PoseidonNative()
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
        """(sibling values, helper bits: 1 where the node is a left child)."""
        proof, helper = [], []
        cur = index
        for level in self.tree[:-1]:
            is_left = cur % 2 == 0
            proof.append(level[cur + 1] if is_left else level[cur - 1])
            helper.append(1 if is_left else 0)
            cur //= 2
        return proof, helper

    def verify_proof(self, leaf: int, index: int, root: int,
                     proof: list[int]) -> bool:
        computed, cur = leaf, index
        for sibling in proof:
            pair = [computed, sibling] if cur % 2 == 0 else [sibling, computed]
            self._h.update(pair)
            computed = self._h.squeeze_and_reset()
            cur //= 2
        return computed == root
