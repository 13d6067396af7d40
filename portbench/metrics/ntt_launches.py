"""Launches of the single-card NTT's kernels a proof over the window: the
program's counter `ntt_kernel.launches` (poly/ntt.py, one launch a pass),
from the deltas that the window's `prove` spans carry; None on the CPU
and where the program has no such counter."""

from portbench.program_spans import proofs

KEY = "ntt_kernel.launches"


def read(run):
    ps = proofs(run)
    if (run.device != "cuda" or ps is None
            or not any(KEY in p.counters for p in ps)):
        return None
    return sum(p.counters[KEY] for p in ps) / len(ps)
