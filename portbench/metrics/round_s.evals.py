"""Seconds a proof in the prover's `prove.evals` span (round 4: the evaluations, through v and u): the
program's own span (zksnap_tpu_torch/obs.py), host clock; the round ends
in a device-to-host read, so the span holds its device work."""

from portbench.program_spans import round_s


def read(run):
    return round_s(run, "prove.evals")
