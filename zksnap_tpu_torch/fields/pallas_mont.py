"""Field kernels K1 (Montgomery multiply) and K2 (modular add / sub).

PyTorch counterpart of zksnap_tpu/fields/pallas_mont.py.  Each wrapper
takes [..., 16] int32 Montgomery limb tensors (broadcasting like the JAX
`mont_mul_batch` / `mont_addsub_batch`) and dispatches on the tensor's
device: a CUDA tensor launches the hand-written kernel in
csrc/mont.cu, a CPU tensor runs the plain int64 version beside it.  Any
other device raises.  The kernels read each operand where it lies (a
strided or broadcast view included, `operand_view`); an operand they
cannot describe is copied to contiguous rows on the card first.
`mont_mul.launches` / `mont_addsub.launches` count kernel launches,
`mont_mul.copies` / `mont_addsub.copies` those copies.  While tracing
is on (`obs`), `.launch_ns` adds each launch's host time and `.elements`
its elements (`launch_elements`).

Both return canonical values in [0, p), like the TPU kernels.
"""

from __future__ import annotations

import functools
import time

import torch

from .. import obs
from .common import (
    LIMB_BITS,
    N_LIMBS,
    carry_pass,
    normalize,
    pad_cols,
    product_columns,
    resolve,
    toeplitz,
)


def _limbs(x: int, k: int, device) -> torch.Tensor:
    return torch.tensor([(x >> (LIMB_BITS * i)) & 0xFFFF for i in range(k)],
                        dtype=torch.int64, device=device)


class _Consts:
    """Per (modulus, device) constants of the plain versions."""

    def __init__(self, p: int, device):
        nprime = (-pow(p, -1, 1 << 256)) % (1 << 256)
        # m = T * N' mod 2^256, N' split into 8-bit halves so that every
        # float64 partial sum stays below 2^53 (T columns are < 2^37):
        # one matmul gives the low halves' columns, then the high halves'
        self.nprime = torch.cat([toeplitz(nprime, N_LIMBS, device, (0, 8)),
                                 toeplitz(nprime, N_LIMBS, device, (8, 16))],
                                dim=1)
        self.p_z = toeplitz(p, 2 * N_LIMBS + 1, device)     # m * p
        # weight of column i of the low half of T + m p, over 2^256
        self.low_scale = torch.tensor(
            [2.0 ** (LIMB_BITS * i - 256) for i in range(N_LIMBS)],
            dtype=torch.float64, device=device)
        self.p17 = _limbs(p, N_LIMBS + 1, device)
        self.negp17 = _limbs((1 << (LIMB_BITS * (N_LIMBS + 1))) - p,
                             N_LIMBS + 1, device)           # 2^272 - p
        self.negp18 = pad_cols(self.negp17, 1)


@functools.lru_cache(maxsize=32)
def _consts(p: int, device: str) -> _Consts:
    return _Consts(p, torch.device(device))


def redc_plain(cols, p: int):
    """REDC of nonnegative int64 product columns [n, 32 or 33] (each
    below 2^37) -> canonical int32 limbs: the whole-word Montgomery
    reduction m = (T mod 2^256) * (-p^-1) mod 2^256,
    (T + m p) / 2^256 < 2p, one conditional subtract -- the value the TPU
    kernel's 16 word-by-word REDC steps reach.

    The low 256 bits of T + m p are zero, so the carry they pass up is
    their column sum over 2^256: an integer below 2^23, which a float64
    sum of the scaled columns gives to within 2^-20.  The result r and
    r + 2^272 - p are carried in one pass; the carry past 2^272 says
    r >= p."""
    c = _consts(p, str(cols.device))
    if cols.shape[-1] == 2 * N_LIMBS:
        cols = pad_cols(cols, 1)
    mm = (cols[:, :N_LIMBS].to(torch.float64) @ c.nprime).to(torch.int64)
    m = normalize(mm[:, :N_LIMBS]
                  + torch.bitwise_left_shift(mm[:, N_LIMBS:], 8))
    u = cols + (m.to(torch.float64) @ c.p_z).to(torch.int64)
    low = (u[:, :N_LIMBS].to(torch.float64) * c.low_scale).sum(-1)
    hi = pad_cols(u[:, N_LIMBS:], 1)             # r, 18 columns
    hi[:, 0] += torch.round(low).to(torch.int64)
    both = normalize(torch.stack([hi, hi + c.negp18]))
    ge = both[1, :, N_LIMBS + 1].unsqueeze(-1).bool()
    return torch.where(ge, both[1], both[0])[:, :N_LIMBS].to(torch.int32)


def _rows(a, b):
    """Broadcast two [..., 16] operands -> int64 [n, 16] each + shape."""
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    return (a.reshape(-1, N_LIMBS).to(torch.int64),
            b.reshape(-1, N_LIMBS).to(torch.int64), shape)


def mont_mul_plain(a, b, p: int):
    """a*b*2^-256 mod p on int64 limbs (the plain version of K1)."""
    a, b, shape = _rows(a, b)
    return redc_plain(product_columns(a, b), p).reshape(shape)


def mont_addsub_plain(a, b, p: int, mode: str):
    """(a +/- b) mod p on int64 limbs (the plain version of K2), with
    nonnegative columns throughout.  Both candidates go through one
    carry step: for add, a + b and a + b + 2^272 - p (the carry past 2^272
    says a + b >= p); for sub, a - b + 2^256 and a - b + p + 2^256, taken
    as a + (0xFFFF - b_i) per column plus a carry in of 1 (bit 256 says
    a >= b)."""
    c = _consts(p, str(a.device))
    a, b, shape = _rows(a, b)
    if mode == "add":
        s = pad_cols(a + b, 1)
        both = torch.stack([s, s + c.negp17])
        limbs, carry = resolve(carry_pass(both, 1))
        pick = carry[1]
    else:
        e = pad_cols(a + (0xFFFF - b), 1)
        both = torch.stack([e, e + c.p17])
        limbs, _ = resolve(carry_pass(both, 1), cin=1)
        pick = 1 - limbs[0, :, N_LIMBS]
    out = torch.where(pick.unsqueeze(-1).bool(), limbs[1], limbs[0])
    return out[:, :N_LIMBS].to(torch.int32).reshape(shape)


MAX_ROWS = 1 << 31  # row indices and offsets the kernels hold in 32 bits


@functools.lru_cache(maxsize=1024)
def launch_geometry(n: int, sms: int) -> tuple[int, int]:
    """(threads a block, blocks) for n rows, one a thread, on a card of
    `sms` SMs: 256 threads a block, halved (down to 32) while that leaves
    fewer blocks than SMs, so that a small n still reaches every SM."""
    threads = 256
    while threads > 32 and -(-n // threads) < sms:
        threads //= 2
    return threads, -(-n // threads)


@functools.lru_cache(maxsize=1024)
def divider(d: int) -> tuple[int, int]:
    """(magic, shift) for the kernels' division by an invariant d,
    1 <= d < 2^31: (umulhi(i, magic) + i) >> shift == i // d for every
    0 <= i < 2^31 (umulhi the high word of the 64-bit product)."""
    shift = (d - 1).bit_length()  # the least s with 2^s >= d
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def operand_view(x, shape):
    """How the kernels read x broadcast to `shape` ([..., 16]) in place:
    (inner, s_outer, s_inner), row i of the call at x.data_ptr() +
    ((i // inner) * s_outer + (i % inner) * s_inner) rows; or None where
    that cannot describe it (limbs not adjacent, a row stride that is
    not whole rows, a pointer not 16-byte aligned, dimensions that do not
    fold into two levels), and the wrapper copies."""
    if x.dtype != torch.int32 or x.shape[-1] != N_LIMBS:
        raise ValueError(f"field operand must be int32 [..., {N_LIMBS}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.data_ptr() % 16:
        return None
    if x.is_contiguous() and x.shape == shape:
        return (max(x.numel() // N_LIMBS, 1), 0, 1)
    if x.stride(-1) != 1:
        return None
    lead = len(shape) - x.dim()
    levels = []  # (size, stride in rows), outer to inner, sizes above 1
    for d in range(len(shape) - 1):
        size = int(shape[d])
        if size == 1:
            continue
        xd = d - lead
        stride = 0 if xd < 0 or x.shape[xd] == 1 else x.stride(xd)
        if stride % N_LIMBS:
            return None
        stride //= N_LIMBS
        if levels and levels[-1][1] == stride * size:
            levels[-1] = (levels[-1][0] * size, stride)
        else:
            levels.append((size, stride))
    if len(levels) > 2 or sum((s - 1) * st for s, st in levels) >= MAX_ROWS:
        return None
    if not levels:
        return (1, 0, 0)
    if len(levels) == 1:
        return (levels[0][0], 0, levels[0][1])
    return (levels[1][0], levels[0][1], levels[1][1])


def operand_rows(x, shape, n: int, counter):
    """The C entry's arguments for operand x of an n-row call (pointer,
    inner, magic, shift, s_outer, s_inner) and the tensor they point
    into.  Where operand_view cannot describe x, x is copied to fresh
    contiguous rows on its device and `counter.copies` counts it."""
    view = operand_view(x, shape)
    if view is None:
        x = (x.reshape(1, N_LIMBS) if x.numel() == N_LIMBS
             else x.expand(shape).reshape(n, N_LIMBS)).clone(
                 memory_format=torch.contiguous_format)
        counter.copies += 1
        view = (x.shape[0], 0, 1 if x.shape[0] > 1 else 0)
    inner, s_outer, s_inner = view
    return (x.data_ptr(), inner, *divider(inner), s_outer, s_inner), x


def unique_rows(x) -> int:
    """Distinct [16]-limb rows of operand x, wherever it is broadcast: a
    dimension of size 1 or stride 0 counts once."""
    rows = 1
    for size, stride in zip(x.shape[:-1], x.stride()[:-1]):
        if stride:
            rows *= size
    return rows


def launch_elements(n: int, a, b) -> int:
    """The elements a K1/K2 launch of n output rows works on: its output
    and each operand's distinct rows."""
    return n + unique_rows(a) + unique_rows(b)


def _device_kind(a, b) -> str:
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no field kernel for device {a.device}")
    return a.device.type


def _launch(fn, a, b, p: int, mode: int | None):
    """K1 (mode None) or K2 (mode 0 add, 1 sub) over operands a, b on one
    CUDA device (kernels.on_device raises otherwise), broadcast together;
    `fn` is the wrapper, whose counts this bumps."""
    from .. import kernels

    t0 = time.perf_counter_ns() if obs.ON else 0
    shape = (a.shape if a.shape == b.shape
             else torch.broadcast_shapes(a.shape, b.shape))
    on = kernels.on_device(a, b)
    if shape[-1] != N_LIMBS:
        raise ValueError(f"field operands of shape {tuple(shape)}")
    n = shape.numel() // N_LIMBS
    if n >= MAX_ROWS:
        raise ValueError(f"{n} rows: the field kernels take fewer than 2^31")
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    # a copied operand's tensor must stay referenced until the launch
    ra, a_rows = operand_rows(a, shape, n, fn)
    rb, b_rows = operand_rows(b, shape, n, fn)
    threads, blocks = launch_geometry(n, kernels.sm_count(on.index))
    lib = kernels.library()
    with on as stream:
        if mode is None:
            err = lib.zk_mont_mul(*ra, *rb, out.data_ptr(), n, threads,
                                  blocks, kernels.mod_ptr(p), stream)
        else:
            err = lib.zk_mont_addsub(*ra, *rb, out.data_ptr(), n, mode,
                                     threads, blocks, kernels.mod_ptr(p),
                                     stream)
    kernels.check(err, "zk_mont_mul" if mode is None else "zk_mont_addsub")
    fn.launches += 1
    if t0:
        fn.launch_ns += time.perf_counter_ns() - t0
        fn.elements += launch_elements(n, a, b)
    return out


def mont_mul(a, b, p: int):
    """Montgomery product over [..., 16] int32 tensors (kernel K1)."""
    if a.is_cuda:
        return _launch(mont_mul, a, b, p, None)
    _device_kind(a, b)
    return mont_mul_plain(a, b, p)


mont_mul.launches = 0
mont_mul.copies = 0
obs.register(mont_mul, "launches", "copies", "launch_ns", "elements")


def mont_addsub(a, b, p: int, mode: str):
    """(a + b) or (a - b) mod p over [..., 16] int32 tensors (kernel K2)."""
    if mode not in ("add", "sub"):
        raise ValueError(f"mode {mode!r}")
    if a.is_cuda:
        return _launch(mont_addsub, a, b, p, 0 if mode == "add" else 1)
    _device_kind(a, b)
    return mont_addsub_plain(a, b, p, mode)


mont_addsub.launches = 0
mont_addsub.copies = 0
obs.register(mont_addsub, "launches", "copies", "launch_ns", "elements")
