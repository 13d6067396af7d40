"""Field kernels K1 (Montgomery multiply) and K2 (modular add / sub).

PyTorch counterpart of zksnap_tpu/fields/pallas_mont.py.  Each wrapper
takes [..., 16] int32 Montgomery limb tensors (broadcasting like the JAX
`mont_mul_batch` / `mont_addsub_batch`) and dispatches on the tensor's
device: a CUDA tensor launches the hand-written kernel in
csrc/mont.cu, a CPU tensor runs the plain int64 version beside it.  Any
other device raises.  `mont_mul.launches` / `mont_addsub.launches` count
kernel launches.

Both return canonical values in [0, p), like the TPU kernels.
"""

from __future__ import annotations

import functools

import torch

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


def _operands(a, b):
    """Broadcast two [..., 16] operands -> (a rows, b rows, row strides,
    batch shape, n).  A one-element operand keeps stride 0 (the kernel
    reads the same row for every element); others are expanded."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    batch = shape[:-1]
    n = 1
    for d in batch:
        n *= int(d)

    def rows(x):
        if x.numel() == N_LIMBS:
            return x.reshape(1, N_LIMBS).contiguous(), 0
        return x.expand(shape).reshape(n, N_LIMBS).contiguous(), 1

    (ar, sa), (br, sb) = rows(a), rows(b)
    return ar, br, sa, sb, batch, n


def _device_kind(a, b) -> str:
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no field kernel for device {a.device}")
    return a.device.type


def mont_mul(a, b, p: int):
    """Montgomery product over [..., 16] int32 tensors (kernel K1)."""
    if _device_kind(a, b) == "cpu":
        return mont_mul_plain(a, b, p)
    from .. import kernels

    ar, br, sa, sb, batch, n = _operands(a, b)
    out = torch.empty((n, N_LIMBS), dtype=torch.int32, device=a.device)
    with kernels.on_device(ar, br, out) as stream:
        err = kernels.library().zk_mont_mul(
            kernels.rows(ar, n if sa else 1),
            kernels.rows(br, n if sb else 1), kernels.rows(out, n), n, sa,
            sb, kernels.mod_ptr(p), stream)
    kernels.check(err, "zk_mont_mul")
    mont_mul.launches += 1
    return out.reshape(*batch, N_LIMBS)


mont_mul.launches = 0


def mont_addsub(a, b, p: int, mode: str):
    """(a + b) or (a - b) mod p over [..., 16] int32 tensors (kernel K2)."""
    if mode not in ("add", "sub"):
        raise ValueError(f"mode {mode!r}")
    if _device_kind(a, b) == "cpu":
        return mont_addsub_plain(a, b, p, mode)
    from .. import kernels

    ar, br, sa, sb, batch, n = _operands(a, b)
    out = torch.empty((n, N_LIMBS), dtype=torch.int32, device=a.device)
    with kernels.on_device(ar, br, out) as stream:
        err = kernels.library().zk_mont_addsub(
            kernels.rows(ar, n if sa else 1),
            kernels.rows(br, n if sb else 1), kernels.rows(out, n), n, sa,
            sb, 0 if mode == "add" else 1, kernels.mod_ptr(p), stream)
    kernels.check(err, "zk_mont_addsub")
    mont_addsub.launches += 1
    return out.reshape(*batch, N_LIMBS)


mont_addsub.launches = 0
