"""Seconds of keygen's layout (`layout_circuit` on the host): the program's
own `keygen.layout` span (zksnap_tpu_torch/obs.py) in set-up, host clock."""

from portbench.program_spans import setup_s


def read(run):
    return setup_s("keygen.layout")
