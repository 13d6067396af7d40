"""Pieces shared by the experiment modules: operands, timing, arguments,
and the plain uint32 arithmetic of the TPU kernels' 16-bit-limb Montgomery
product (the plain side of csrc/mont16.cuh).

uint32 values travel in `torch.int32` tensors (the same bits); the plain
versions compute in int64 and mask with `U32` wherever the TPU's uint32
lanes would wrap, since PyTorch on the CPU has no uint32 shift or compare.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

U32 = 0xFFFFFFFF
MASK16 = 0xFFFF


def u32_tensor(x, device) -> torch.Tensor:
    """numpy or torch uint32 data -> the same bits as an int32 tensor on
    `device`."""
    if isinstance(x, torch.Tensor):
        t = x if x.dtype == torch.int32 else x.to(torch.int64).bitwise_and(
            U32).to(torch.int32)
        return t.to(device).contiguous()
    arr = np.ascontiguousarray(np.asarray(x).astype(np.uint32).view(np.int32))
    return torch.from_numpy(arr).to(device)


def as_u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their uint32 values in int64."""
    return t.to(torch.int64).bitwise_and(U32)


def to_signed(t: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 -> the int32 values of the same bits."""
    t = t & U32
    return t - ((t >> 31) << 32)


def to_i32_bits(t: torch.Tensor) -> torch.Tensor:
    """int64 values mod 2^32 -> the same bits as int32."""
    return to_signed(t).to(torch.int32)


def device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def first_call(fn, args, device):
    """(fn(*args), seconds): the first call, kernel build included."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(device)
    return out, time.perf_counter() - t0


def bench(fn, args, device, iters: int) -> float:
    """Seconds a call of fn(*args) after one warm-up call: CUDA events over
    `iters` calls on the card, the host clock on the CPU."""
    fn(*args)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def parser(prog: str, doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description=doc)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the hand-written kernels) or "
                         "cpu (their plain versions)")
    return ap


def check_device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no experiment kernel for device {t.device}")
    return t.device.type


def limb_major(t: torch.Tensor, what: str) -> int:
    """Check a [16, n] operand of 16-bit limbs; returns n."""
    if t.dim() != 2 or t.shape[0] != 16:
        raise ValueError(f"{what}: expected [16, n] limbs, got "
                         f"{tuple(t.shape)}")
    return int(t.shape[1])


# ---------------------------------------------------------------------------
# Plain versions of mont16.cuh, over [rows, n] int64 uint32 values.
# Operands are 16-bit limbs, so every limb product is below 2^32.
# ---------------------------------------------------------------------------

def conv_schoolbook(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[16, n] x [16, n] -> the 33 schoolbook columns [33, n] (each low and
    high half of a limb product added to its column), each below 2^21."""
    cols = torch.zeros((33, a.shape[1]), dtype=torch.int64, device=a.device)
    for i in range(16):
        prod = a[i] * b
        cols[i:i + 16] += prod & MASK16
        cols[i + 1:i + 17] += prod >> 16
    return cols


def cond_sub(out, carry, p_limbs):
    """out (16 rows) - p where carry > 0 or out >= p, limbwise with the
    scripts' borrow chain."""
    ge_flag = carry > 0
    eq = torch.ones_like(ge_flag)
    gt = torch.zeros_like(ge_flag)
    for i in range(15, -1, -1):
        gt = gt | (eq & (out[i] > p_limbs[i]))
        eq = eq & (out[i] == p_limbs[i])
    ge = ge_flag | gt | eq
    borrow = torch.zeros_like(out[0])
    res = []
    for i in range(16):
        t = (out[i] - p_limbs[i] - borrow) & U32
        nb = (t >> 31) & 1
        res.append(torch.where(ge, (t + (nb << 16)) & MASK16, out[i]))
        borrow = nb
    return torch.stack(res)


def word_redc(cols: torch.Tensor, p: int,
              signed: bool = False) -> torch.Tensor:
    """Word-by-word REDC mod p of 33 columns, one carry pass, one
    conditional subtract -> [16, n].  Unsigned (the scripts' arithmetic):
    uint32 columns, every step wrapped mod 2^32 as the TPU's lanes wrap.
    Signed: int32 columns (Karatsuba's), carried with an arithmetic
    shift."""
    p_limbs, n0 = p_limbs16(p), n0_16(p)
    wrap = (lambda v: v) if signed else (lambda v: v & U32)
    cols = to_signed(cols) if signed else cols.clone()
    p_col = torch.tensor(p_limbs, dtype=torch.int64,
                         device=cols.device).unsqueeze(1)
    for i in range(16):
        m = (cols[i] * n0) & MASK16
        prod = m * p_col
        cols[i:i + 16] = wrap(cols[i:i + 16] + (prod & MASK16))
        cols[i + 1:i + 17] = wrap(cols[i + 1:i + 17] + (prod >> 16))
        cols[i + 1] = wrap(cols[i + 1] + (cols[i] >> 16))
    carry = torch.zeros_like(cols[0])
    out = []
    for i in range(16):
        tot = wrap(cols[16 + i] + carry)
        out.append(tot & MASK16)
        carry = tot >> 16
    return cond_sub(out, wrap(carry + cols[32]), p_limbs)


def p_limbs16(p: int) -> list[int]:
    return [(p >> (16 * i)) & MASK16 for i in range(16)]


def n0_16(p: int) -> int:
    """-p^-1 mod 2^16, the word REDC's multiplier."""
    return (-pow(p, -1, 1 << 16)) % (1 << 16)
