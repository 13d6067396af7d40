"""Raw op-rate probes (kernel K11): what does one operation cost on the card?

PyTorch counterpart of scripts/exp_vpu_rates.py.  Times chains of
dependent operations on [16, W] uint32 tiles, the layout of the TPU's field
kernels, and chains of small products on the tensor cores:

  u32mul   -- a = a * b + 1, 32-bit wrapping
  u16mul   -- operands masked to 16 bits, a = (a * b) & 0xffff
  u32add   -- a = a + b
  u32mask  -- a = (a & 0xffff) | (a >> 16)
  f32fma   -- x = x * y + 1 in float32 (one rounding), then cast to int32
  i8dot    -- acc[64, W] += L[64, 32] . x, x <- int8(y[:32]) (wrapping)
  bf16dot  -- the same in bf16 with an f32 accumulator,
              x <- bf16(y[:32] * 1e-3)

`op_chain` and `dot_chain` launch csrc/exp_rates.cu on CUDA tensors and run
their plain versions on CPU tensors; `op_chain.launches` and
`dot_chain.launches` count the launches.  The dot kernels' fragment and
shared-memory layouts are written out below (DOT_PERM, dot_a_source,
dot_b_image) for the CPU tests' lane-by-lane model.

    python -m zksnap_tpu_torch.experiments.exp_vpu_rates [w_log=14] [chain=512]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .common import (U32, as_u32, bench, check_device, device_name, parser,
                     to_i32_bits, u32_tensor)

CHAIN_KINDS = ("u32mul", "u16mul", "u32add", "u32mask", "f32fma")
DOT_KINDS = ("i8dot", "bf16dot")
N_MM = 64
# steps a trip of the chain kernel's main loop (csrc/exp_rates.cu)
CHAIN_UNROLL = 16
DOT_COLUMNS_A_WARP = 16  # a warp's M rows: 16 columns of W
# a step's tensor-core work in products of the function: y's outputs 0..31
# fresh for the chain, all 64 into the sum
DOT_PRODUCTS_A_STEP = 1.5


def _perm(p: int) -> int:
    i = p & 3
    return (p & 16) + 2 * ((p >> 2) & 3) + (i & 1) + 8 * (i >> 1)


# The dot kernels compute y^T = x^T . L^T: a block's 64 columns of W are the
# product's M rows (warp w has rows 16w..16w+15; g = lane // 4, t = lane % 4
# as in the fragments of csrc/exp_rates.cu), the contraction's 32 slots
# its K, y's 64 rows its N.  i8dot's slot p holds row DOT_PERM[p] of x (and
# so of y, and B's K row p is L's column DOT_PERM[p]); bf16dot's slot p
# holds row p.
DOT_PERM = np.array([_perm(p) for p in range(32)])


def dot_a_source(kind: str, ks: int, r: int, i: int) -> tuple[int, int]:
    """(n tile, register) of the D fragment that feeds byte (i8dot) or half
    (bf16dot) i of A register r of k step ks in the next step."""
    if kind == "i8dot":
        return 2 * (r >> 1) + (i >> 1), 2 * (r & 1) + (i & 1)
    return 2 * ks + (r >> 1), 2 * (r & 1) + i


def dot_a_slot(kind: str, ks: int, r: int, t: int, i: int) -> int:
    """The contraction slot of byte or half i of A register r of k step ks
    in lane t of a quad (its row is g + 8 (r & 1))."""
    if kind == "i8dot":
        return 16 * (r >> 1) + 4 * t + i
    return 16 * ks + 8 * (r >> 1) + 2 * t + i


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), rounded to nearest even."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def dot_b_image(kind: str, lhs: np.ndarray) -> np.ndarray:
    """The dot kernel's B (L^T, i8dot's K rows permuted by DOT_PERM) as
    a block writes it to shared memory, uint8: K-major core matrices of 8
    N rows x 16 bytes of K, core (cb, kb) at (2 cb + kb) * 128, N row n of
    a core at 16 n; bf16dot's two k steps of 16 are 2048 bytes apart.  The
    descriptor's leading offset is K-adjacent cores' 128 bytes, its stride
    N-adjacent cores' 256."""
    lhs = np.asarray(lhs)
    if kind == "i8dot":
        rows = lhs[:, DOT_PERM].view(np.uint8)  # [n, K bytes]
    else:
        rows = _bf16_bits(lhs).view(np.uint8).reshape(64, 64)
    k_steps = rows.shape[1] // 32
    img = np.zeros(2048 * k_steps, np.uint8)
    for ks in range(k_steps):
        for n in range(64):
            for kb in range(2):
                at = 2048 * ks + (2 * (n // 8) + kb) * 128 + 16 * (n % 8)
                lo = 16 * (2 * ks + kb)
                img[at:at + 16] = rows[n, lo:lo + 16]
    return img


def _mul32(x, y):
    """x * y mod 2^32 for uint32 values in int64, with no int64 overflow."""
    lo = x * (y & 0xFFFF)
    hi = ((x * (y >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def fma_f32(x: torch.Tensor, y: torch.Tensor, c: float) -> torch.Tensor:
    """x * y + c in float32 with one rounding, as the FMA unit does: the
    product is exact in float64, the sum is rounded to odd in float64
    (TwoSum gives its error), and that rounds to the nearest float32 as the
    exact sum would."""
    p = x.to(torch.float64) * y.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    fix = torch.isfinite(s) & (err != 0) & even
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(fix, torch.nextafter(s, toward), s).to(torch.float32)


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """The truncating cast of JAX and of CUDA's cvt.rzi.s32.f32: out of
    range saturates (+inf -> 2147483647, -inf -> -2147483648) and NaN is 0.
    PyTorch's own cast on the CPU gives -2147483648 for all three."""
    big = x >= 2.0 ** 31
    small = x < -(2.0 ** 31)
    nan = torch.isnan(x)
    out = torch.where(big | small | nan, torch.zeros_like(x), x).to(
        torch.int32)
    out = torch.where(big, torch.full_like(out, 2 ** 31 - 1), out)
    out = torch.where(small, torch.full_like(out, -(2 ** 31)), out)
    return torch.where(nan, torch.zeros_like(out), out)


def op_chain_plain(kind: str, a: torch.Tensor, b: torch.Tensor,
                   chain: int) -> torch.Tensor:
    """The plain version of the chain kernel: a, b int32 (uint32 bits)."""
    if kind == "f32fma":
        x, y = a.to(torch.float32), b.to(torch.float32)
        for _ in range(chain):
            x = fma_f32(x, y, 1.0)
        return f32_to_i32(x)
    x, y = as_u32(a), as_u32(b)
    if kind == "u16mul":
        x, y = x & 0xFFFF, y & 0xFFFF
    for _ in range(chain):
        if kind == "u32mul":
            x = (_mul32(x, y) + 1) & U32
        elif kind == "u16mul":
            x = (x * y) & 0xFFFF
        elif kind == "u32add":
            x = (x + y) & U32
        else:
            x = (x & 0xFFFF) | (x >> 16)
    return to_i32_bits(x)


def op_chain(kind: str, a: torch.Tensor, b: torch.Tensor,
             chain: int) -> torch.Tensor:
    """`chain` dependent steps of `kind` on every lane of a and b (int32
    tensors of one shape holding uint32 bits) -> int32 bits (kernel K11)."""
    if kind not in CHAIN_KINDS:
        raise ValueError(f"chain kind {kind!r}")
    if a.device != b.device or a.shape != b.shape:
        raise ValueError(f"operands {tuple(a.shape)} on {a.device} and "
                         f"{tuple(b.shape)} on {b.device}")
    if check_device(a) == "cpu":
        return op_chain_plain(kind, a, b, chain)
    from .. import kernels

    out = torch.empty_like(a)
    with kernels.on_device(a, b, out) as stream:
        err = kernels.library().zk_exp_chain(
            CHAIN_KINDS.index(kind), kernels.operand(a, torch.int32, a.shape),
            kernels.operand(b, torch.int32, a.shape),
            kernels.operand(out, torch.int32, a.shape), a.numel(), chain,
            stream)
    kernels.check(err, "zk_exp_chain")
    op_chain.launches += 1
    return out


op_chain.launches = 0


def _dot_dtypes(kind: str):
    return {"i8dot": (torch.int8, torch.int8, torch.int32),
            "bf16dot": (torch.float32, torch.bfloat16, torch.float32)}[kind]


def dot_chain_plain(kind: str, lhs: torch.Tensor, x0: torch.Tensor,
                    n_mm: int) -> torch.Tensor:
    """The plain version of the dot kernel.  i8dot: exact products in
    float64, int8 wrapping; bf16dot: L rounded to bf16, float32 products,
    x rounded to bf16 after every step."""
    if kind == "i8dot":
        L = lhs.to(torch.float64)
        x = x0.to(torch.float64)
        acc = torch.zeros((64, x0.shape[1]), dtype=torch.int64,
                          device=x0.device)
        for _ in range(n_mm):
            y = (L @ x).to(torch.int64)
            acc = acc + y
            x = (((y[:32] + 128) & 255) - 128).to(torch.float64)
        return to_i32_bits(acc)
    L = lhs.to(torch.bfloat16).to(torch.float32)
    x = x0
    scale = torch.tensor(1e-3, dtype=torch.float32, device=x0.device)
    acc = torch.zeros((64, x0.shape[1]), dtype=torch.float32,
                      device=x0.device)
    for _ in range(n_mm):
        y = L @ x.to(torch.float32)
        acc = acc + y
        x = (y[:32] * scale).to(torch.bfloat16)
    return acc


def dot_chain(kind: str, lhs: torch.Tensor, x0: torch.Tensor,
              n_mm: int) -> torch.Tensor:
    """acc[64, W] = the sum of n_mm dependent products y = L . x, each
    feeding the next through x <- convert(y[:32]) (kernel K11, dots).
    i8dot: lhs int8 [64, 32], x0 int8 [32, W], acc int32; bf16dot: lhs
    float32 [64, 32], x0 bfloat16 [32, W], acc float32."""
    if kind not in DOT_KINDS:
        raise ValueError(f"dot kind {kind!r}")
    l_dt, x_dt, _ = _dot_dtypes(kind)
    if lhs.dtype != l_dt or x0.dtype != x_dt:
        raise ValueError(f"{kind} takes {l_dt} and {x_dt}, got {lhs.dtype} "
                         f"and {x0.dtype}")
    if (tuple(lhs.shape) != (64, 32) or x0.dim() != 2 or x0.shape[0] != 32
            or lhs.device != x0.device):
        raise ValueError(f"operands {tuple(lhs.shape)} on {lhs.device} and "
                         f"{tuple(x0.shape)} on {x0.device}")
    if check_device(x0) == "cpu":
        return dot_chain_plain(kind, lhs, x0, n_mm)
    from .. import kernels

    W = int(x0.shape[1])
    if W % 8:
        raise ValueError(f"W = {W} is not a multiple of 8")
    out = torch.empty((64, W), dtype=_dot_dtypes(kind)[2], device=x0.device)
    with kernels.on_device(lhs, x0, out) as stream:
        err = kernels.library().zk_exp_dot(
            DOT_KINDS.index(kind), kernels.operand(lhs, l_dt, (64, 32)),
            kernels.operand(x0, x_dt, (32, W)),
            kernels.operand(out, out.dtype, (64, W)), W, n_mm, stream)
    kernels.check(err, "zk_exp_dot")
    dot_chain.launches += 1
    return out


dot_chain.launches = 0


def make_chain(kind: str, chain: int, W: int, device="cuda"):
    """The script's `make_chain`: a function of (a, b), [16, W] uint32
    (numpy, or torch int32 bits), moved to `device`."""
    if kind not in CHAIN_KINDS:
        raise ValueError(f"chain kind {kind!r}")

    def go(a, b):
        a, b = u32_tensor(a, device), u32_tensor(b, device)
        if tuple(a.shape) != (16, W):
            raise ValueError(f"expected [16, {W}], got {tuple(a.shape)}")
        return op_chain(kind, a, b, chain)

    return go


def _bf16(x, device) -> torch.Tensor:
    """numpy float or bfloat16 data -> a bfloat16 tensor on `device`."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' type, as JAX returns it
        bits = torch.from_numpy(np.array(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.astype(np.float32)).to(device).to(
        torch.bfloat16)


def make_dot(kind: str, W: int, n_mm: int, lhs=None, x0=None,
             device="cuda"):
    """The script's `make_dot`: (a function of (lhs, x0), (lhs, x0) on
    `device`).  The sides are the caller's numpy arrays, or drawn as the
    script draws them from numpy's global generator: i8dot L, x0 in
    [-8, 8); bf16dot L standard normal, x0 normal * 0.1."""
    if kind not in DOT_KINDS:
        raise ValueError(f"dot kind {kind!r}")
    if kind == "i8dot":
        if lhs is None:
            lhs = np.random.randint(-8, 8, (64, 32)).astype(np.int8)
        if x0 is None:
            x0 = np.random.randint(-8, 8, (32, W)).astype(np.int8)
        lt = torch.from_numpy(np.array(lhs, np.int8)).to(device)
        xt = torch.from_numpy(np.array(x0, np.int8)).to(device)
    else:
        if lhs is None:
            lhs = np.random.randn(64, 32).astype(np.float32)
        if x0 is None:
            x0 = (np.random.randn(32, W) * 0.1).astype(np.float32)
        lt = torch.from_numpy(np.array(lhs, np.float32)).to(device)
        xt = _bf16(x0, device)
    if tuple(xt.shape) != (32, W):
        raise ValueError(f"x0 of shape {tuple(xt.shape)}, expected (32, {W})")

    def go(l, x):
        return dot_chain(kind, l, x, n_mm)

    return go, (lt.contiguous(), xt.contiguous())


def main(argv=None) -> dict:
    """Time every chain and dot at [16, 2^w_log] and print the script's
    lines; returns {kind: {"ms", "rate"}} (Gop/s for the chains, Tmac/s
    for the dots)."""
    ap = parser("exp_vpu_rates", __doc__.splitlines()[0])
    ap.add_argument("w_log", nargs="?", type=int, default=14)
    ap.add_argument("chain", nargs="?", type=int, default=512)
    args = ap.parse_args(argv)
    device, W, chain = args.device, 1 << args.w_log, args.chain
    lanes = 16 * W
    print(f"exp_vpu_rates on {device_name(device)}", flush=True)
    rng = np.random.default_rng(0)
    a = u32_tensor(rng.integers(0, 1 << 16, (16, W), dtype=np.uint32), device)
    b = u32_tensor(rng.integers(0, 1 << 16, (16, W), dtype=np.uint32), device)
    out = {}
    for kind in CHAIN_KINDS:
        dt = bench(make_chain(kind, chain, W, device), (a, b), device,
                   30)
        rate = lanes * chain / dt / 1e9
        out[kind] = {"ms": dt * 1e3, "rate": rate}
        print(f"{kind:8s}: {rate:8.1f} Gop/s  ({dt*1e3:.4f} ms,"
              f" chain={chain}, {lanes} lanes)", flush=True)
    for kind in DOT_KINDS:
        if kind == "i8dot":
            lhs = rng.integers(-8, 8, (64, 32)).astype(np.int8)
            x0 = rng.integers(-8, 8, (32, W)).astype(np.int8)
        else:
            lhs = rng.standard_normal((64, 32)).astype(np.float32)
            x0 = (rng.standard_normal((32, W)) * 0.1).astype(np.float32)
        fn, dargs = make_dot(kind, W, N_MM, lhs, x0, device)
        dt = bench(fn, dargs, device, 10)
        macs = 64 * 32 * W * N_MM
        out[kind] = {"ms": dt * 1e3, "rate": macs / dt / 1e12}
        print(f"{kind:8s}: {macs/dt/1e12:8.4f} Tmac/s  ({dt*1e3:.4f} ms,"
              f" {N_MM} matmuls [64,32]x[32,{W}])", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
