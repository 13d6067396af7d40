# Copy of zksnap_tpu/prover/accumulator.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""KZG accumulation scheme (snark-verifier `KzgAs<Bn256, Gwc19>` parity).

Reference: wrapper.rs:54-57 type aliases, the native pre-pass at
wrapper.rs:445-480 (`succinct_verify` x3 -> `As::create_proof`) and the
final `decide` pairing at wrapper.rs:1140-1158.

An accumulator (lhs, rhs) asserts e(lhs, [tau]G2) == e(rhs, G2).  PLONK
verification minus its pairing yields one (plonk.verify_succinct);
`fold` combines many into one with a transcript-derived challenge (the
IVC step); `decide` pays the single pairing at the end of the chain.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.native import AffinePoint
from . import pairing as pr
from .plonk import VerifyingKey, verify_succinct
from .transcript import Transcript


@dataclass
class KzgAccumulator:
    lhs: AffinePoint  # pairs with [tau]G2
    rhs: AffinePoint  # pairs with G2


def accumulator_from_proof(vk: VerifyingKey, instances: list[int],
                           proof: bytes) -> KzgAccumulator | None:
    """PlonkSuccinctVerifier::verify equivalent: algebraic checks now,
    pairing deferred into the accumulator."""
    res = verify_succinct(vk, instances, proof)
    if res is None:
        return None
    g2_side, tau_side = res  # e(g2_side, G2) == e(tau_side, [tau]G2)
    return KzgAccumulator(lhs=tau_side, rhs=g2_side)


def fold_accumulators(accs: list[KzgAccumulator]) -> tuple[KzgAccumulator, bytes]:
    """As::create_proof: absorb all accumulators, squeeze r, RLC-combine.

    Returns (folded, as_proof); for Gwc19 the As proof carries no extra
    commitments -- the fold challenge is pure Fiat-Shamir over the input
    accumulators (absorbed as limb encodings, which is exactly what the
    in-circuit fold replays), so as_proof is empty."""
    tr = Transcript()
    for acc in accs:
        tr.absorb_point(acc.lhs)
        tr.absorb_point(acc.rhs)
    r = tr.challenge()
    from ..fields.field import bn254_fr

    p = bn254_fr().p
    lhs = AffinePoint.identity(accs[0].lhs.curve)
    rhs = AffinePoint.identity(accs[0].rhs.curve)
    coef = 1
    for acc in accs:
        lhs = lhs + coef * acc.lhs
        rhs = rhs + coef * acc.rhs
        coef = coef * r % p
    return KzgAccumulator(lhs, rhs), tr.proof()


def decide(acc: KzgAccumulator, srs_g2, srs_tau_g2) -> bool:
    """The final pairing: e(lhs, [tau]G2) == e(rhs, G2)."""
    return pr.pairing_check([
        (acc.rhs, srs_g2),
        (-acc.lhs, srs_tau_g2),
    ])
