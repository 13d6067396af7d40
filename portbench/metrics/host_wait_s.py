"""Seconds a proof that the host spends blocked on the card (the
program's `obs.wait_ns`: `Field.from_mont`'s copy to the host, which
every commitment and evaluation goes through, round 2's two closure
checks, and the prover's copies from the host to the card, each of
which PyTorch makes wait on the stream), from the deltas that the
window's `prove` spans carry."""

from portbench.program_spans import total


def read(run):
    ns = total(run, "wait_ns")
    return None if ns is None else ns / 1e9 / run.proofs
