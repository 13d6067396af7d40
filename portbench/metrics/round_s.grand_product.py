"""Seconds a proof in the prover's `prove.grand_product` span (round 2: the logUp helper h, the permutation products Z, their commits and inverse NTTs, through y): the
program's own span (zksnap_tpu_torch/obs.py), host clock; the round ends
in a device-to-host read, so the span holds its device work."""

from portbench.program_spans import round_s


def read(run):
    return round_s(run, "prove.grand_product")
