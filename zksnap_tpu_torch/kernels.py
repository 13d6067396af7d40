"""Build and load the port's hand-written CUDA kernels.

The sources under `csrc/` compile on first use, one `nvcc` process for
each source, all started together, and link into a shared library with a
plain C interface, `build/torch_kernels/libzksnap_kernels_<srchash>.so`
at the repository root; `ctypes` loads it.  Every C entry launches on
the caller's stream and returns `cudaGetLastError()`; `check` raises if
that is not 0.  A wrapper calls its entry inside `on_device(...)` of its
operands, which makes their device the current one (the entries launch
there) and gives the stream.

Nothing here runs at import time: the CPU tests import every module, and
a machine without `nvcc` never reaches `library()`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
SOURCES = ("mont.cu", "ntt.cu", "point.cu", "bucket_scan.cu", "reduce.cu",
           "exp_rates.cu", "exp_mul_variants.cu", "exp_mul_mxu.cu")
HEADERS = ("field.cuh", "field_inline.cuh", "point.cuh", "point_inline.cuh",
           "mont16.cuh")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "build",
                         "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_U = ctypes.c_uint
_ROWS = [_P] + [_U] * 5  # an operand's rows: base, inner, magic, shift, strides
_SIGNATURES = {
    "zk_mont_mul": _ROWS * 2 + [_P, _U, _I, _I, _P, _P],
    "zk_mont_addsub": _ROWS * 2 + [_P, _U, _I, _I, _I, _P, _P],
    "zk_ntt_pass": [_P] * 5 + [ctypes.POINTER(_I), _P, _P],
    "zk_point": [_I] + [_P] * 9 + [_LL, _I, _I, _P, _P],
    "zk_bucket_scan": [_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _P, _P],
    "zk_weighted_suffix": [_P] * 7 + [_LL, _LL] + [_I] * 5 + [_P, _P],
    "zk_ladder_tree": [_P] * 6 + [_I, _I, _I, _I, _P, _P],
    "zk_exp_chain": [_I, _P, _P, _P, _LL, _I, _P],
    "zk_exp_dot": [_I, _P, _P, _P, _I, _I, _P],
    "zk_exp_mul16": [_P, _P, _P, _LL, _I, _I, _P, _P],
    "zk_exp_mxu_mul": [_I, _P, _P, _P, _LL, _P, _P, _P],
}


def source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build(build_dir: str = BUILD_DIR) -> str:
    """Compile the kernels if this source hash has no library yet; returns
    the library path.  Every source compiles in its own `nvcc` process,
    all at once, then one `nvcc -shared` links them.  The compilers'
    output (ptxas register counts included) is kept beside the library as
    build_<hash>.log."""
    build_dir = os.path.abspath(build_dir)
    tag = source_hash()
    lib = os.path.join(build_dir, f"libzksnap_kernels_{tag}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(build_dir, exist_ok=True)
    stem = f"{lib}.{os.getpid()}"
    objs = [f"{stem}.{s}.o" for s in SOURCES]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    runs = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
    link = [_nvcc(), "-shared", "-o", f"{stem}.tmp", *objs]
    if all(rc == 0 for _, _, rc in runs):
        res = subprocess.run(link, capture_output=True, text=True)
        runs.append((link, res.stdout + res.stderr, res.returncode))
    with open(os.path.join(build_dir, f"build_{tag}.log"), "w") as f:
        for cmd, out, _ in runs:
            f.write(" ".join(cmd) + "\n" + out)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    failed = [(cmd, out, rc) for cmd, out, rc in runs if rc != 0]
    if failed:
        cmd, out, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    os.replace(f"{stem}.tmp", lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(build())
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def sm_count(index: int) -> int:
    """The number of SMs of CUDA device `index`."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


@functools.cache
def modulus_words(p: int) -> ctypes.Array:
    """Host array of 17 uint32: p, R mod p (both 8 little-endian words) and
    n0 = -p^-1 mod 2^32 -- the kernels' Modulus struct."""
    one = (1 << 256) % p
    n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
    words = [(p >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    words += [(one >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    words.append(n0)
    arr = (ctypes.c_uint32 * 17)(*words)
    return arr


def mod_ptr(p: int) -> int:
    return ctypes.addressof(modulus_words(p))


@functools.cache
def mod16_words(p: int) -> ctypes.Array:
    """Host array of 17 uint32: p as 16 limbs of 16 bits and the 16-bit
    n0 = -p^-1 mod 2^16 -- the experiment kernels' Mod16 struct."""
    n0 = (-pow(p, -1, 1 << 16)) % (1 << 16)
    words = [(p >> (16 * i)) & 0xFFFF for i in range(16)] + [n0]
    return (ctypes.c_uint32 * 17)(*words)


def mod16_ptr(p: int) -> int:
    return ctypes.addressof(mod16_words(p))


class on_device:
    """`with on_device(*tensors) as stream:` makes the device of `tensors`
    (one CUDA device, or this raises) the current one for the block and
    gives the pointer of its current stream: the C entries launch on the
    thread's current device, so a kernel for a tensor on cuda:1 must be
    launched under cuda:1, on a stream of cuda:1.  Where that device is
    current already, nothing is switched.  (torch.cuda.device and
    torch.cuda.current_stream do the same through Python objects, which
    cost a field kernel's launch more than its device time at n = 8192.)"""

    __slots__ = ("index", "prev")

    def __init__(self, *tensors):
        devs = {t.device for t in tensors}
        if len(devs) != 1:
            raise ValueError(f"kernel operands on {len(devs)} devices: "
                             f"{sorted(map(str, devs))}")
        dev = devs.pop()
        if dev.type != "cuda":
            raise ValueError(f"kernel operands must be on a CUDA device, "
                             f"got {dev}")
        self.index = dev.index
        self.prev = None

    def __enter__(self) -> int:
        import torch

        cur = torch._C._cuda_getDevice()
        if cur != self.index:
            torch._C._cuda_setDevice(self.index)
            self.prev = cur
        return torch._C._cuda_getCurrentRawStream(self.index)

    def __exit__(self, *exc):
        if self.prev is not None:
            import torch

            torch._C._cuda_setDevice(self.prev)
        return False


def rows(t, n: int) -> int:
    """Check a [n, 16] int32 contiguous CUDA operand and return its pointer
    (the kernels read a row as four 16-byte vectors)."""
    import torch

    if not (t.dtype == torch.int32 and t.is_cuda and t.is_contiguous()):
        raise ValueError(f"kernel operand must be contiguous int32 on a CUDA "
                         f"device, got {t.dtype} on {t.device}")
    if t.shape[-1] != 16 or t.numel() != 16 * n:
        raise ValueError(f"kernel operand of shape {tuple(t.shape)}, "
                         f"expected {n} rows of 16 limbs")
    if t.data_ptr() % 16:
        raise ValueError("kernel operand rows must be 16-byte aligned")
    return t.data_ptr()


def operand(t, dtype, shape) -> int:
    """Check a contiguous CUDA operand of `dtype` and `shape` and return
    its pointer."""
    if not (t.dtype == dtype and t.is_cuda and t.is_contiguous()):
        raise ValueError(f"kernel operand must be contiguous {dtype} on a "
                         f"CUDA device, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"kernel operand of shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    return t.data_ptr()

