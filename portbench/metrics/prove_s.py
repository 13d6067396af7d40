"""Seconds a proof: the window's wall time (first proof's start to the
last proof's end, each ending in a device synchronise) over the proofs it
completed.  Host clock."""


def read(run):
    return run.window_s / run.proofs if run.proofs else None
