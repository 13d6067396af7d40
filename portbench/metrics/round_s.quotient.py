"""Seconds a proof in the prover's `prove.quotient` span (round 3: the quotient on the extended cosets and its chunk commits, through x): the
program's own span (zksnap_tpu_torch/obs.py), host clock; the round ends
in a device-to-host read, so the span holds its device work."""

from portbench.program_spans import round_s


def read(run):
    return round_s(run, "prove.quotient")
