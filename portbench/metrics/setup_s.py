"""Seconds from the start of the run's process to the window: imports,
inputs, synthesis, the SRS (made or loaded), keygen, the kernels' build
where there is none, and the warm-up requests.  Host clock."""


def read(run):
    return run.setup_s
