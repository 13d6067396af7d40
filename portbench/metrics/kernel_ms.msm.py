"""Device milliseconds a proof in the MSM's kernels K3-K6 (csrc/point.cu,
bucket_scan.cu, reduce.cu), by kernel name in the profiler's trace."""

from portbench.devtrace import kernel_name, ms_per_proof

KERNELS = ("point_kernel", "bucket_scan_kernel", "suffix_chunk_total_kernel",
           "suffix_carry_kernel", "suffix_chunk_kernel", "ladder_tree_kernel")


def read(run):
    return ms_per_proof(run, lambda n: kernel_name(n) in KERNELS)
