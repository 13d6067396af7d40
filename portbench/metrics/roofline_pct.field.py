"""K1 and K2's share of their memory roofline over the window, in %: the
time their elements take at 32 bytes each (a 254-bit value packed, so the
share reads the same work whatever layout carries it; the kernels' 16
int32 limbs move 64 bytes, so 50 % is their ceiling) at 3.35 TB/s, over
their device seconds by kernel name in the profiler's trace.  Elements
are the wrappers' `.elements` (a launch's output and each operand's
distinct rows) over the window's `prove` spans."""

from portbench.devtrace import kernel_name
from portbench.program_spans import total

KERNELS = ("mont_mul_kernel", "mont_addsub_kernel")
BYTES = 32
HBM_BYTES_S = 3.35e12


def read(run):
    if run.device != "cuda" or not run.ops:
        return None
    counts = [total(run, f"{w}.elements") for w in ("mont_mul", "mont_addsub")]
    if None in counts or not sum(counts):
        return None
    device_s = sum(v[1] for n, v in run.ops.items()
                   if kernel_name(n) in KERNELS)
    if not device_s:
        return None
    return 100.0 * BYTES * sum(counts) / HBM_BYTES_S / device_s
