"""The fixed-base bucket accumulation's share of its roofline over the
window, in %: the least time its work takes over K4's
(`bucket_scan_kernel`) device seconds by kernel name in the profiler's
trace.  The work is the (point, digit) pairs the window's proofs
accumulated, W*n a commit, from the program's counter
`commit_fixed.pairs` (the deltas the window's `prove` spans carry), each
one RCB mixed addition (pmadd): 11 products and 21 adds or subtracts.
Its least time is that of the slowest of the IMAD pipe (a product's 264
multiply results), the integer ALU pipe (a product's 16, an add's 24),
64 lanes an SM a clock each, and the warp schedulers, 128; 132 SMs at 1.98 GHz
(the IMAD pipe decides), or its bytes at 3.35 TB/s (a point packed,
64 bytes a pair), whichever is larger.  Counting pairs and not launches
keeps the share the same whatever implements the accumulation.  In a
cell whose commits all take the fixed-base path every K4 launch is one
of these.  None on the CPU and where the program has no such counter."""

from portbench.devtrace import kernel_name
from portbench.program_spans import total

KERNELS = ("bucket_scan_kernel",)
PMADD = (11, 21)  # (products, adds)
IMAD_PER_PRODUCT = 8 * (16 * 2 + 1)
ALU_PER_PRODUCT = 16
ALU_PER_ADD = 24
LANES = {"imad": 64, "alu": 64, "schedulers": 128}
SM_CLOCKS_PER_S = 132 * 1.98e9
BYTES_PER_PAIR = 64
HBM_BYTES_S = 3.35e12


def bound_s(pairs: int) -> float:
    """The least device seconds that `pairs` mixed additions take."""
    m, a = PMADD
    imad = pairs * m * IMAD_PER_PRODUCT
    alu = pairs * (m * ALU_PER_PRODUCT + a * ALU_PER_ADD)
    clocks = max(imad / LANES["imad"], alu / LANES["alu"],
                 (imad + alu) / LANES["schedulers"])
    return max(clocks / SM_CLOCKS_PER_S, pairs * BYTES_PER_PAIR / HBM_BYTES_S)


def read(run):
    if run.device != "cuda" or not run.ops:
        return None
    pairs = total(run, "commit_fixed.pairs")
    if not pairs:
        return None
    device_s = sum(v[1] for n, v in run.ops.items()
                   if kernel_name(n) in KERNELS)
    if not device_s:
        return None
    return 100.0 * bound_s(pairs) / device_s
