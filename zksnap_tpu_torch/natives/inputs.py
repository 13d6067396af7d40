# Copy of zksnap_tpu/natives/inputs.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""Protocol input generation — the native mirror of every circuit computation.

Reference parity:
  * `generate_random_voter_circuit_inputs`  -> voter_tests/src/lib.rs:121-211
  * `generate_wrapper_circuit_input`        -> aggregator/src/utils.rs:199-345
  * `update_idx_leaf`                       -> aggregator/src/utils.rs:71-99
  * `generate_state_transition_circuit_inputs` -> aggregator/src/utils.rs:101-197
  * `compress_native_nullifier`             -> aggregator/src/utils.rs:355-371

All math is host-side python ints (the oracle); the circuits consume these
inputs on device.  RNG is injected for determinism.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field as dfield

from ..curves.native import SECP256K1, AffinePoint, secp_generator
from ..fields.field import bn254_fr
from ..hash.poseidon import PoseidonNative
from .merkle import IMTLeaf, IndexedMerkleTree, MerkleTree, hash_imt_leaf
from .paillier import paillier_add, paillier_enc
from .plume import gen_nullifier, verify_nullifier

ENC_BIT_LEN = 176
LIMB_BIT_LEN = 88
NUM_LIMBS = 3
FR = bn254_fr()


# ---------------------------------------------------------------------------
# DTOs (mirror voter/src/lib.rs:45-105, aggregator/src/state_transition.rs:30-96)
# ---------------------------------------------------------------------------

@dataclass
class EncryptionPublicKey:
    n: int
    g: int


@dataclass
class VoterCircuitInput:
    membership_root: int
    pk_enc: EncryptionPublicKey
    nullifier: AffinePoint
    proposal_id: int
    vote_enc: list[int]
    s_nullifier: int
    vote: list[int]
    r_enc: list[int]
    pk_voter: AffinePoint
    c_nullifier: int
    membership_proof: list[int]
    membership_proof_helper: list[int]


@dataclass
class IndexedMerkleTreeInput:
    old_root: int
    low_leaf: IMTLeaf
    low_leaf_proof: list[int]
    low_leaf_proof_helper: list[int]
    new_root: int
    new_leaf: IMTLeaf
    new_leaf_index: int
    new_leaf_proof: list[int]
    new_leaf_proof_helper: list[int]
    is_new_leaf_largest: int


@dataclass
class StateTransitionInput:
    pk_enc: EncryptionPublicKey
    incoming_vote: list[int]
    prev_vote: list[int]
    nullifier_tree: IndexedMerkleTreeInput
    nullifier: AffinePoint


# ---------------------------------------------------------------------------
# Field-element packing helpers (halo2-base `fe_to_biguint` / `from_bytes_le`)
# ---------------------------------------------------------------------------

def bytes_le_chunks_to_fr(value: int, chunk: int = 11, total: int = 32) -> list[int]:
    """32-byte LE encoding split into 11-byte chunks -> Fr elements.

    Matches `x.to_bytes().chunks(11).map(Fr::from_bytes_le)`
    (voter_tests/src/lib.rs:153-166): 32 bytes -> chunks of 11/11/10.
    """
    raw = value.to_bytes(total, "little")
    return [
        int.from_bytes(raw[i : i + chunk], "little") % FR.p
        for i in range(0, total, chunk)
    ]


def compress_native_nullifier(point: AffinePoint) -> list[int]:
    """[tag, x_limb0, x_limb1, x_limb2] — aggregator/src/utils.rs:355-371."""
    tag = 2 if point.y % 2 == 0 else 3
    return [tag] + bytes_le_chunks_to_fr(point.x)


def leaf_from_pk(pk: AffinePoint, hasher: PoseidonNative) -> int:
    """Member leaf = Poseidon(x limbs || y limbs) — voter_tests lib.rs:168-176."""
    hasher.update(bytes_le_chunks_to_fr(pk.x))
    hasher.update(bytes_le_chunks_to_fr(pk.y))
    return hasher.squeeze_and_reset()


# ---------------------------------------------------------------------------
# Voter inputs
# ---------------------------------------------------------------------------

def generate_random_voter_circuit_inputs(rng: random.Random | None = None) -> VoterCircuitInput:
    """voter_tests/src/lib.rs:121-211 (tree of 8, one-hot 5-way vote,
    proposal id 1)."""
    rng = rng or random.Random()
    treesize = 8

    vote = [1, 0, 0, 0, 0]
    n = rng.getrandbits(ENC_BIT_LEN)
    g = rng.getrandbits(ENC_BIT_LEN)

    r_enc, vote_enc = [], []
    for i in range(5):
        r_enc.append(rng.getrandbits(ENC_BIT_LEN))
        vote_enc.append(paillier_enc(n, g, vote[i], r_enc[i]))

    hasher = PoseidonNative()
    sk = rng.randrange(1, SECP256K1.n)
    pk_voter = sk * secp_generator()

    leaves = []
    for i in range(treesize):
        if i == 0:
            leaves.append(leaf_from_pk(pk_voter, hasher))
        else:
            hasher.update([0])
            leaves.append(hasher.squeeze_and_reset())

    tree = MerkleTree(leaves)
    membership_root = tree.get_root()
    membership_proof, membership_proof_helper = tree.get_proof(0)
    assert tree.verify_proof(leaves[0], 0, membership_root, membership_proof)

    message = bytes([1, 0])  # proposal id 1 as 2 LE bytes
    r = rng.randrange(1, SECP256K1.n)
    nullifier, s, c = gen_nullifier(sk, message, r)
    assert verify_nullifier(message, nullifier, pk_voter, s, c)

    return VoterCircuitInput(
        membership_root=membership_root,
        pk_enc=EncryptionPublicKey(n, g),
        nullifier=nullifier,
        proposal_id=1,
        vote_enc=vote_enc,
        s_nullifier=s,
        vote=vote,
        r_enc=r_enc,
        pk_voter=pk_voter,
        c_nullifier=c,
        membership_proof=membership_proof,
        membership_proof_helper=membership_proof_helper,
    )


# ---------------------------------------------------------------------------
# State-transition / wrapper inputs
# ---------------------------------------------------------------------------

def update_idx_leaf(leaves: list[IMTLeaf], new_val: int, new_val_idx: int
                    ) -> tuple[list[IMTLeaf], int]:
    """aggregator/src/utils.rs:71-99 — link the new value into the sorted list."""
    pre = [l.clone() for l in leaves]
    low_leaf_idx = 0
    for i, node in enumerate(leaves):
        if node.next_val == 0 and i == 0:
            pre[i + 1].val = new_val
            pre[i].next_val = new_val
            pre[i].next_idx = i + 1
            low_leaf_idx = i
            break
        if node.val < new_val and (node.next_val > new_val or node.next_val == 0):
            pre[new_val_idx].val = new_val
            pre[new_val_idx].next_val = pre[i].next_val
            pre[new_val_idx].next_idx = pre[i].next_idx
            pre[i].next_val = new_val
            pre[i].next_idx = new_val_idx
            low_leaf_idx = i
            break
    return pre, low_leaf_idx


def generate_state_transition_circuit_inputs(
    pk_enc: EncryptionPublicKey,
    nullifier_affine: AffinePoint,
    incoming_vote: list[int],
    prev_vote: list[int],
    nullifier_tree_preimages: list[IMTLeaf],
    round_idx: int,
    nullifier_tree_leaves: list[int],
) -> tuple[StateTransitionInput, list[int], list[IMTLeaf]]:
    """aggregator/src/utils.rs:101-197."""
    leaves = list(nullifier_tree_leaves)
    hasher = PoseidonNative()

    hasher.update(compress_native_nullifier(nullifier_affine))
    new_val = hasher.squeeze_and_reset()

    tree = IndexedMerkleTree(leaves)
    old_root = tree.get_root()

    updated, low_leaf_idx = update_idx_leaf(nullifier_tree_preimages, new_val, round_idx)
    low_leaf = nullifier_tree_preimages[low_leaf_idx].clone()
    low_leaf_proof, low_leaf_proof_helper = tree.get_proof(low_leaf_idx)
    assert tree.verify_proof(leaves[low_leaf_idx], low_leaf_idx, old_root, low_leaf_proof)

    leaves[low_leaf_idx] = hash_imt_leaf(updated[low_leaf_idx])
    leaves[round_idx] = hash_imt_leaf(updated[round_idx])
    tree = IndexedMerkleTree(leaves)
    new_leaf_proof, new_leaf_proof_helper = tree.get_proof(round_idx)
    assert tree.verify_proof(leaves[round_idx], round_idx, tree.get_root(), new_leaf_proof)

    new_root = tree.get_root()
    new_leaf = updated[round_idx].clone()
    is_new_leaf_largest = 1 if new_leaf.next_val == 0 else 0

    idx_input = IndexedMerkleTreeInput(
        old_root=old_root,
        low_leaf=low_leaf,
        low_leaf_proof=low_leaf_proof,
        low_leaf_proof_helper=low_leaf_proof_helper,
        new_root=new_root,
        new_leaf=new_leaf,
        new_leaf_index=round_idx,
        new_leaf_proof=new_leaf_proof,
        new_leaf_proof_helper=new_leaf_proof_helper,
        is_new_leaf_largest=is_new_leaf_largest,
    )
    st_input = StateTransitionInput(
        pk_enc=pk_enc,
        incoming_vote=incoming_vote,
        prev_vote=prev_vote,
        nullifier_tree=idx_input,
        nullifier=nullifier_affine,
    )
    return st_input, leaves, updated


def generate_wrapper_circuit_input(
    num_round: int, rng: random.Random | None = None
) -> tuple[list[VoterCircuitInput], list[StateTransitionInput]]:
    """aggregator/src/utils.rs:199-345 — the full multi-round protocol mirror."""
    rng = rng or random.Random()
    hasher = PoseidonNative()

    n = rng.getrandbits(ENC_BIT_LEN)
    g = rng.getrandbits(ENC_BIT_LEN)
    pk_enc = EncryptionPublicKey(n, g)

    sks = [rng.randrange(1, SECP256K1.n) for _ in range(num_round)]
    pk_voters = [sk * secp_generator() for sk in sks]

    members_tree_leaves = [leaf_from_pk(pk, hasher) for pk in pk_voters]
    for _ in range(num_round, 8):
        hasher.update([0])
        members_tree_leaves.append(hasher.squeeze_and_reset())
    members_tree = MerkleTree(members_tree_leaves)

    nullifier_tree_preimages = [IMTLeaf(0, 0, 0) for _ in range(8)]
    nullifier_tree_leaves = [hash_imt_leaf(l) for l in nullifier_tree_preimages]

    prev_vote: list[int] = []
    voter_inputs: list[VoterCircuitInput] = []
    state_inputs: list[StateTransitionInput] = []

    for i in range(num_round):
        vote = [0, 0, 0, 0, 0]
        vote[rng.randrange(5)] = 1
        message = bytes([1, 0])
        r_plume = rng.randrange(1, SECP256K1.n)
        nullifier, s, c = gen_nullifier(sks[i], message, r_plume)
        assert verify_nullifier(message, nullifier, pk_voters[i], s, c)

        r_enc = [rng.getrandbits(ENC_BIT_LEN) for _ in range(5)]
        if i == 0:
            prev_vote = [paillier_enc(n, g, 0, r_enc[i]) for _ in range(5)]

        membership_root = members_tree.get_root()
        membership_proof, membership_proof_helper = members_tree.get_proof(i)
        vote_enc = [paillier_enc(n, g, vote[j], r_enc[j]) for j in range(5)]

        voter_inputs.append(VoterCircuitInput(
            membership_root=membership_root,
            pk_enc=pk_enc,
            nullifier=nullifier,
            proposal_id=1,
            vote_enc=vote_enc,
            s_nullifier=s,
            vote=vote,
            r_enc=r_enc,
            pk_voter=pk_voters[i],
            c_nullifier=c,
            membership_proof=membership_proof,
            membership_proof_helper=membership_proof_helper,
        ))

        st_input, nullifier_tree_leaves, nullifier_tree_preimages = (
            generate_state_transition_circuit_inputs(
                pk_enc, nullifier, vote_enc, prev_vote,
                nullifier_tree_preimages, i + 1, nullifier_tree_leaves,
            )
        )
        state_inputs.append(st_input)

        prev_vote = [paillier_add(n, x, y) for x, y in zip(prev_vote, vote_enc)]

    return voter_inputs, state_inputs
