"""Host microseconds a kernel launch of K1-K6: the wrappers' `.launch_ns`
(entry to return: operand checks and copies, geometry, the C call) over
their `.launches`, summed over the window's `prove` spans.  None where
nothing launched (the CPU)."""

from portbench.program_spans import LAUNCHED, proofs, total


def read(run):
    if proofs(run) is None:
        return None
    n = sum(total(run, f"{w}.launches") for w in LAUNCHED)
    if not n:
        return None
    return sum(total(run, f"{w}.launch_ns") for w in LAUNCHED) / n / 1e3
