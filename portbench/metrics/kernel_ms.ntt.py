"""Device milliseconds a proof in the single-card NTT's kernels
(csrc/ntt.cu, `ntt_pass_kernel`), by kernel name in the profiler's trace;
None where the trace holds none of them (a program without them)."""

from portbench.devtrace import kernel_name, ms_per_proof

KERNELS = ("ntt_pass_kernel",)


def read(run):
    if not run.ops or not any(kernel_name(n) in KERNELS for n in run.ops):
        return None
    return ms_per_proof(run, lambda n: kernel_name(n) in KERNELS)
