"""Device milliseconds a proof in K1 and K2 (csrc/mont.cu), by kernel
name in the profiler's trace."""

from portbench.devtrace import kernel_name, ms_per_proof

KERNELS = ("mont_mul_kernel", "mont_addsub_kernel")


def read(run):
    return ms_per_proof(run, lambda n: kernel_name(n) in KERNELS)
