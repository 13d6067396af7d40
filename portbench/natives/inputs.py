# Frozen copy of the voter part of zksnap_tpu_torch/natives/inputs.py for the benchmark.
"""The voter's inputs from a seed: the native mirror of the reference's
voter_tests/src/lib.rs:121-211 (a tree of 8 members, a one-hot 5-way
vote, proposal id 1, Paillier encryptions and a PLUME nullifier).  All
math is on python ints; the random source is passed in."""

from __future__ import annotations

import random
from dataclasses import dataclass

from .curve import SECP256K1, AffinePoint, secp_generator
from .merkle import MerkleTree
from .paillier import paillier_enc
from .plume import gen_nullifier, verify_nullifier
from .poseidon import FR_P, PoseidonNative

ENC_BIT_LEN = 176


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


def bytes_le_chunks_to_fr(value: int, chunk: int = 11,
                          total: int = 32) -> list[int]:
    """32-byte little-endian encoding split into 11-byte chunks (11, 11,
    10), each read as an Fr element (voter_tests/src/lib.rs:153-166)."""
    raw = value.to_bytes(total, "little")
    return [int.from_bytes(raw[i : i + chunk], "little") % FR_P
            for i in range(0, total, chunk)]


def compress_native_nullifier(point: AffinePoint) -> list[int]:
    """[tag, x_limb0, x_limb1, x_limb2] (aggregator/src/utils.rs:355-371)."""
    tag = 2 if point.y % 2 == 0 else 3
    return [tag] + bytes_le_chunks_to_fr(point.x)


def leaf_from_pk(pk: AffinePoint, hasher: PoseidonNative) -> int:
    """Member leaf = Poseidon(x limbs || y limbs) (voter_tests lib.rs:168-176)."""
    hasher.update(bytes_le_chunks_to_fr(pk.x))
    hasher.update(bytes_le_chunks_to_fr(pk.y))
    return hasher.squeeze_and_reset()


def generate_random_voter_circuit_inputs(rng: random.Random) -> VoterCircuitInput:
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
    if not tree.verify_proof(leaves[0], 0, membership_root, membership_proof):
        raise ValueError("membership proof does not verify")

    message = bytes([1, 0])  # proposal id 1 as 2 LE bytes
    r = rng.randrange(1, SECP256K1.n)
    nullifier, s, c = gen_nullifier(sk, message, r)
    if not verify_nullifier(message, nullifier, pk_voter, s, c):
        raise ValueError("nullifier does not verify")

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
