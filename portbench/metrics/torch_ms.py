"""Device milliseconds a proof in PyTorch's own kernels and copies: every
operation of ATen or its CUB (gather, cat, where, roll, elementwise,
copies) and every memcpy and memset, by name in the profiler's trace.
The program's hand-written kernels are not among them."""

from portbench.devtrace import ms_per_proof


def _torch_op(name: str) -> bool:
    return (name.startswith(("Memcpy", "Memset")) or "at::" in name
            or "at_cuda_detail" in name or "cub::" in name)


def read(run):
    return ms_per_proof(run, _torch_op)
