# Copy of zksnap_tpu/prover/recursion.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""Recursion / IVC layer -- native accumulation chain.

Reference parity: aggregator/src/wrapper.rs `recursion` module.  The
reference folds, per round, the voter snark + state-transition snark +
previous wrapper snark into one KZG accumulator (native pre-pass
wrapper.rs:445-480), re-verifies the same statement in-circuit
(wrapper.rs:538-738) and exposes the folded accumulator limbs as public
instances.

This module provides the NATIVE side end-to-end: succinct verification of
each snark into an accumulator, cross-proof consistency checks (the
equality constraints of wrapper.rs:617-711 executed natively), chained
folding across rounds, and the final pairing decide.  The in-circuit
verifier trace (the k=22 wrapper circuit) is the planned L5 completion;
its instance layout constants are defined here already
(wrapper.rs:423-431, :813-815).
"""

from __future__ import annotations

from dataclasses import dataclass

from .accumulator import (
    KzgAccumulator,
    accumulator_from_proof,
    decide,
    fold_accumulators,
)
from .plonk import VerifyingKey

# wrapper instance layout (wrapper.rs:423-431): 4*LIMBS accumulator limbs,
# then digest, pk_enc, aggr_vote, roots, membership root, proposal id, round
LIMBS = 3
BITS = 88
PREPROCESSED_DIGEST_ROW = 4 * LIMBS
PK_ENC_N_ROW = 4 * LIMBS + 1
PK_ENC_G_ROW = 4 * LIMBS + 3
VOTE_ROW = 4 * LIMBS + 5
NULLIFIER_OLD_ROOT_ROW = 4 * LIMBS + 25
NULLIFIER_NEW_ROOT_ROW = 4 * LIMBS + 26
MEMBERSHIP_ROOT_ROW = 4 * LIMBS + 27
PROPOSAL_ID_ROW = 4 * LIMBS + 28
ROUND_ROW = 4 * LIMBS + 29
NUM_WRAPPER_INSTANCE = 4 * LIMBS + 30  # = 42, wrapper.rs:813-815


@dataclass
class Snark:
    """Proof container (wrapper.rs:81-104 `Snark`)."""

    vk: VerifyingKey
    instances: list[int]
    proof: bytes


class RecursionChain:
    """Native IVC driver: per-round fold of (voter, state, carry)."""

    def __init__(self, srs_g2, srs_tau_g2):
        self.srs_g2 = srs_g2
        self.srs_tau_g2 = srs_tau_g2
        self.acc: KzgAccumulator | None = None
        self.round = 0
        self.prev_state_instances: list[int] | None = None

    def add_round(self, voter: Snark, state: Snark):
        """Verify both snarks succinctly, check cross-proof consistency
        (wrapper.rs:617-711 natively), fold into the carried accumulator."""
        acc_v = accumulator_from_proof(voter.vk, voter.instances, voter.proof)
        acc_s = accumulator_from_proof(state.vk, state.instances, state.proof)
        if acc_v is None or acc_s is None:
            raise ValueError("snark failed succinct verification")

        vi, si = voter.instances, state.instances
        # voter and state agree on pk_enc (n, g: 4 limbs)
        assert vi[0:4] == si[0:4], "pk_enc mismatch"
        # voter's encrypted votes are the state's incoming votes
        assert vi[4:24] == si[24:44], "incoming vote mismatch"
        # same nullifier (compressed, 4 cells)
        assert vi[24:28] == si[64:68], "nullifier mismatch"
        if self.prev_state_instances is not None:
            # roots chain and the tally carries over
            assert (si[68] == self.prev_state_instances[69]), "root chain broken"
            assert (si[4:24] == self.prev_state_instances[44:64]), \
                "prev_vote != previous aggr_vote"
        self.prev_state_instances = si

        to_fold = [acc_v, acc_s]
        if self.acc is not None:
            to_fold.append(self.acc)
        self.acc, _ = fold_accumulators(to_fold)
        self.round += 1

    def finalize(self) -> bool:
        """The single pairing for the whole chain (wrapper.rs:1140-1158)."""
        assert self.acc is not None, "no rounds added"
        return decide(self.acc, self.srs_g2, self.srs_tau_g2)


def accumulator_limbs(acc: KzgAccumulator) -> list[int]:
    """fe_to_limbs encoding of the accumulator for the wrapper instance
    rows 0..4*LIMBS (LimbsEncoding<3,88>, wrapper.rs:56,516)."""
    out = []
    for pt in (acc.lhs, acc.rhs):
        for coord in (pt.x, pt.y):
            for i in range(LIMBS):
                out.append((coord >> (BITS * i)) & ((1 << BITS) - 1))
    return out
