"""Share of the window in which an operation ran on the device: the union
of the profiler's device intervals over the window's length."""


def read(run):
    if run.device != "cuda" or run.busy_s is None or not run.window_s:
        return None
    return 100.0 * run.busy_s / run.window_s
