"""Seconds a proof in the prover's `prove.witness` span (round 1: the advice, lookup and multiplicity commits, through the challenges beta_lk, beta, gamma): the
program's own span (zksnap_tpu_torch/obs.py), host clock; the round ends
in a device-to-host read, so the span holds its device work."""

from portbench.program_spans import round_s


def read(run):
    return round_s(run, "prove.witness")
