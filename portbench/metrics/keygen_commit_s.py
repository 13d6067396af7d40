"""Seconds of keygen's fixed and sigma commits: the program's own
`keygen.commit` span (zksnap_tpu_torch/obs.py) in set-up, host clock; the
last commit ends in a device-to-host read."""

from portbench.program_spans import setup_s


def read(run):
    return setup_s("keygen.commit")
