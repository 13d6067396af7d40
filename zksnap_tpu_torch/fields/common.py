"""Limb-vector bignum helpers shared by all prime fields (PyTorch port of
zksnap_tpu/fields/common.py).

Representation: a nonnegative integer x < 2^256 is a little-endian vector
of N_LIMBS=16 limbs of LIMB_BITS=16 bits, stored at rest in a
`torch.int32` tensor of shape [..., 16].  The integer values are the ones
the JAX package keeps in uint32, so `np.asarray(x).astype(np.int32)`
converts both ways.

PyTorch on the CPU has no uint32 add, shift or compare, so the plain
(CPU) arithmetic here works in int64 columns: a column may hold a signed
value of many more than 16 bits until `normalize` carries it into limbs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

N_LIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


# ---------------------------------------------------------------------------
# Host-side conversions (python int <-> limb arrays)
# ---------------------------------------------------------------------------

def int_to_limbs(x: int, n_limbs: int = N_LIMBS) -> np.ndarray:
    """Python int -> little-endian int32 limb vector."""
    assert 0 <= x < (1 << (LIMB_BITS * n_limbs)), "value out of range"
    return np.array(
        [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n_limbs)],
        dtype=np.int32,
    )


def limbs_to_int(limbs) -> int:
    """Little-endian limb vector -> python int (host only)."""
    limbs = _host(limbs)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(limbs.reshape(-1)))


def ints_to_limbs(xs, n_limbs: int = N_LIMBS) -> np.ndarray:
    """List of python ints -> [len(xs), n_limbs] int32 array."""
    if n_limbs == N_LIMBS and len(xs):
        return ints_to_limbs_fast(xs)
    return np.stack([int_to_limbs(x, n_limbs) for x in xs], axis=0)


def ints_to_limbs_fast(xs, modulus: int | None = None) -> np.ndarray:
    """List of python ints -> [len(xs), 16] int32 limbs via a bytes blit
    (optionally reduced mod `modulus` first).  256-bit values only."""
    if modulus is None:
        buf = b"".join(x.to_bytes(32, "little") for x in xs)
    else:
        buf = b"".join((x % modulus).to_bytes(32, "little") for x in xs)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(xs), N_LIMBS)
    return arr.astype(np.int32)


def limbs_to_ints(arr) -> list:
    """[..., 16] canonical limbs (numpy or torch) -> flat list of ints."""
    arr = _host(arr)
    if arr.shape[-1] == N_LIMBS and arr.ndim >= 2:
        flat = arr.reshape(-1, N_LIMBS)
        buf = flat.astype("<u2").tobytes()
        return [int.from_bytes(buf[i * 32 : (i + 1) * 32], "little")
                for i in range(flat.shape[0])]
    flat = arr.reshape(-1, arr.shape[-1])
    return [limbs_to_int(row) for row in flat]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Plain int64 limb arithmetic (the plain versions of the field kernels)
#
# Columns are int64 [..., K] holding nonnegative values of up to 62 bits;
# `normalize` turns them into 16-bit limbs.  Eager PyTorch pays a few
# microseconds per call whatever the width, and the CPU tests run narrow
# batches, so these helpers use a fixed, small number of calls: no loop
# that runs until the carries die out, and no host sync.
# ---------------------------------------------------------------------------

_SH = torch.tensor(LIMB_BITS)
_MK = torch.tensor(LIMB_MASK)


def resolve(t, cin: int = 0):
    """Carry int64 columns [..., K] with 0 <= t_i <= 2^17 - 2 into 16-bit
    limbs in one step -> (limbs [..., K], carry out of column K-1 [...]).

    Every carry is a single bit, so the carries are those of a binary
    addition: column i generates one (g_i = t_i >> 16) or passes the
    incoming one on (low_i == 0xFFFF); with G and P those bit masks over
    the K columns, the carries into the columns are the bits of
    ((G|P) + G + cin) ^ (G|P) ^ G, `cin` the carry into column 0."""
    k = t.shape[-1]
    w, shifts = _pow2(k, t.device)
    low = torch.bitwise_and(t, _MK)
    gen = (torch.bitwise_right_shift(t, _SH) * w).sum(-1)
    x = gen | ((low == LIMB_MASK) * w).sum(-1)
    c = (x + gen + cin) ^ x ^ gen
    cin_cols = torch.bitwise_right_shift(c.unsqueeze(-1), shifts) & 1
    return (low + cin_cols) & _MK, torch.bitwise_right_shift(c, k)


def carry_pass(t, span: int):
    """One carry pass: bits 16-31, 32-47, ... of every column move one,
    two, ... columns up (span passes; bits beyond column K-1 drop)."""
    out = torch.bitwise_and(t, _MK)
    hi = t
    for s in range(1, span + 1):
        hi = torch.bitwise_right_shift(hi, _SH)
        out[..., s:] += torch.bitwise_and(hi[..., :-s], _MK)
    return out


def normalize(t):
    """Nonnegative int64 columns [..., K] of up to 62 bits -> 16-bit limbs
    of their value mod 2^(16K): a pass with span 3 leaves columns below
    2^18, a pass with span 1 below 2^16 + 4, and `resolve` the rest."""
    return resolve(carry_pass(carry_pass(t, 3), 1))[0]


def pad_cols(t, k: int):
    """Append k zero columns (room for carries)."""
    return torch.nn.functional.pad(t, (0, k))


@functools.lru_cache(maxsize=16)
def _pow2(n: int, device) -> tuple:
    """(2^i, i) for i < n as int64 tensors on `device`."""
    return (torch.tensor([1 << i for i in range(n)], dtype=torch.int64,
                         device=device),
            torch.arange(n, dtype=torch.int64, device=device))


def product_columns(a, b):
    """Schoolbook product columns of two int64 limb vectors [n, 16]:
    column k = sum_{i+j=k} a_i b_j (the JAX `mul_wide`), as [n, 33] with
    a zero top column (room for the carry).

    The 256 partial products go through one float64 matmul with the
    constant 0/1 column-sum matrix, as the JAX CPU path sends them
    through an int32 dot: every partial sum is an integer below 2^36, so
    float64 holds it exactly in any summation order."""
    outer = a.to(torch.float64).unsqueeze(-1) * b.to(torch.float64).unsqueeze(-2)
    cols = outer.reshape(-1, N_LIMBS * N_LIMBS) @ _column_sum(a.device)
    return cols.to(torch.int64)


@functools.lru_cache(maxsize=8)
def _column_sum(device) -> torch.Tensor:
    """[256, 33] float64 0/1 matrix: partial product (i, j) -> column i+j."""
    m = torch.zeros((N_LIMBS * N_LIMBS, 2 * N_LIMBS + 1), dtype=torch.float64)
    for i in range(N_LIMBS):
        for j in range(N_LIMBS):
            m[i * N_LIMBS + j, i + j] = 1
    return m.to(device)


def toeplitz(c: int, n_cols: int, device, bits: tuple = (0, 16)):
    """[16, n_cols] float64 matrix Z with (x @ Z)[k] = sum_{i+j=k} x_i c_j,
    where c_j are bits [bits[0], bits[1]) of limb j of the constant c:
    the product columns of limb vectors by a constant as one matmul."""
    lo, hi = bits
    limbs = [((c >> (LIMB_BITS * j)) >> lo) & ((1 << (hi - lo)) - 1)
             for j in range(N_LIMBS)]
    z = torch.zeros((N_LIMBS, n_cols), dtype=torch.float64)
    for i in range(N_LIMBS):
        for j in range(N_LIMBS):
            if i + j < n_cols:
                z[i, i + j] = limbs[j]
    return z.to(device)
