"""Seconds of the program's keygen (prover/keygen.py layout, plonk.keygen's
commitments): the benchmark's span around `keygen`.  Host clock, the
device synchronised at both ends."""


def read(run):
    return run.spans.get("keygen")
