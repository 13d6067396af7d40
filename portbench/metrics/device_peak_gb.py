"""Peak device memory over the window (max_memory_allocated after
reset_peak_memory_stats at the window's start), in GB (1e9 bytes)."""


def read(run):
    if run.device != "cuda" or run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 1e9
