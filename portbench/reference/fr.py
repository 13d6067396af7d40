"""BN254 Fr on vectors of field elements in plain PyTorch, for the
reference: an element is a row of 16 little-endian 16-bit limbs held in
int64, so every partial product and column sum stays exact.

Nothing here is shared with the program: the product is a schoolbook
product followed by a word-by-word Montgomery reduction (R = 2^256),
written out step by step in tensor operations.
"""

from __future__ import annotations

import numpy as np
import torch

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
GENERATOR = 7
TWO_ADICITY = 28
LIMBS = 16
MASK = 0xFFFF
R2 = pow(2, 512, P)
# -p^-1 mod 2^16: the Montgomery reduction's per-word factor
PINV16 = (-pow(P, -1, 1 << 16)) % (1 << 16)


def int_limbs(v: int) -> list[int]:
    return [(v >> (16 * i)) & MASK for i in range(LIMBS)]


def const(v: int, device) -> torch.Tensor:
    """One element as a [1, 16] row."""
    return torch.tensor([int_limbs(v % P)], dtype=torch.int64, device=device)


def from_ints(vals: list[int], device) -> torch.Tensor:
    buf = b"".join((v % P).to_bytes(32, "little") for v in vals)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(vals), LIMBS)
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def from_u16(rows: np.ndarray, device) -> torch.Tensor:
    """(n, 16) uint16 canonical limb rows."""
    return torch.from_numpy(np.asarray(rows, dtype=np.int64)).to(device)


def to_ints(a: torch.Tensor) -> list[int]:
    arr = a.to("cpu").numpy().astype("<u2")
    b = arr.tobytes()
    return [int.from_bytes(b[i * 32 : (i + 1) * 32], "little")
            for i in range(arr.shape[0])]


_PLIMBS: dict = {}


def _p_limbs(device) -> torch.Tensor:
    key = str(device)
    if key not in _PLIMBS:
        _PLIMBS[key] = torch.tensor(int_limbs(P), dtype=torch.int64,
                                    device=device)
    return _PLIMBS[key]


def _normalize(t: torch.Tensor) -> torch.Tensor:
    """Carry every column into 16 bits; the top column takes the rest."""
    t = t.clone()
    for j in range(t.shape[1] - 1):
        t[:, j + 1] += t[:, j] >> 16
        t[:, j] &= MASK
    return t


def _reduce_once(r: torch.Tensor) -> torch.Tensor:
    """r (17 normalised limbs, value < 2p) -> r mod p (16 limbs)."""
    p = _p_limbs(r.device)
    d = r.clone()
    d[:, :LIMBS] -= p
    borrow = torch.zeros_like(d[:, 0])
    for j in range(LIMBS + 1):
        d[:, j] -= borrow
        borrow = (d[:, j] < 0).to(torch.int64)
        d[:, j] += borrow << 16
    keep = (borrow == 1)[:, None]  # r < p: keep r
    return torch.where(keep, r, d)[:, :LIMBS]


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod p, rows broadcast."""
    a, b = torch.broadcast_tensors(a, b)
    n = a.shape[0]
    t = torch.zeros((n, 2 * LIMBS + 1), dtype=torch.int64, device=a.device)
    for i in range(LIMBS):
        t[:, i : i + LIMBS] += a[:, i : i + 1] * b
    p = _p_limbs(a.device)
    for i in range(LIMBS):
        m = ((t[:, i] & MASK) * PINV16) & MASK
        t[:, i : i + LIMBS] += m[:, None] * p
        t[:, i + 1] += t[:, i] >> 16
    return _reduce_once(_normalize(t[:, LIMBS:]))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p on canonical values."""
    ab = mont_mul(a, b)
    return mont_mul(ab, const(R2, ab.device))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p on canonical values."""
    a, b = torch.broadcast_tensors(a, b)
    d = torch.cat([a - b, torch.zeros_like(a[:, :1])], dim=1)
    borrow = torch.zeros_like(d[:, 0])
    for j in range(LIMBS):
        d[:, j] -= borrow
        borrow = (d[:, j] < 0).to(torch.int64)
        d[:, j] += borrow << 16
    p = _p_limbs(a.device)
    add_p = d.clone()
    add_p[:, :LIMBS] += p
    add_p = _normalize(add_p)[:, :LIMBS]
    return torch.where((borrow == 1)[:, None], add_p, d[:, :LIMBS])


def total(a: torch.Tensor, mask: torch.Tensor | None = None) -> int:
    """The sum of the rows (of those where mask holds) mod p, as an int."""
    if mask is not None:
        a = a[mask]
    cols = a.sum(dim=0).tolist()
    return sum(int(c) << (16 * j) for j, c in enumerate(cols)) % P


def batch_inverse(x: torch.Tensor) -> torch.Tensor:
    """Inverses of non-zero rows: a product tree up, one inversion on the
    host, the tree down again."""
    levels = [x]
    while levels[-1].shape[0] > 1:
        cur = levels[-1]
        if cur.shape[0] % 2:
            cur = torch.cat([cur, const(1, cur.device)])
            levels[-1] = cur
        levels.append(mul(cur[0::2], cur[1::2]))
    inv = const(pow(to_ints(levels[-1])[0], -1, P), x.device)
    for lvl in reversed(levels[:-1]):
        left, right = lvl[0::2], lvl[1::2]
        inv = inv[: left.shape[0]]
        out = torch.empty_like(lvl)
        out[0::2] = mul(inv, right)
        out[1::2] = mul(inv, left)
        inv = out
    return inv[: x.shape[0]]


def powers(w: int, n: int, device) -> torch.Tensor:
    """w^i for i < n: two tables of about sqrt(n) powers on the host, one
    vector product."""
    lo_n = 1 << ((max(n, 2) - 1).bit_length() + 1) // 2
    hi_n = -(-n // lo_n)
    lo = [1] * lo_n
    for i in range(1, lo_n):
        lo[i] = lo[i - 1] * w % P
    step = pow(w, lo_n, P)
    hi = [1] * hi_n
    for i in range(1, hi_n):
        hi[i] = hi[i - 1] * step % P
    lo_t, hi_t = from_ints(lo, device), from_ints(hi, device)
    idx = torch.arange(n, device=device)
    return mul(lo_t[idx % lo_n], hi_t[idx // lo_n])


def omega(k: int) -> int:
    return pow(GENERATOR, (P - 1) >> k, P)


def lagrange_at(tau: int, k: int, device) -> torch.Tensor:
    """L_i(tau) for i < 2^k: w^i (tau^n - 1) / (n (tau - w^i))."""
    n = 1 << k
    w = powers(omega(k), n, device)
    inv = batch_inverse(sub(const(tau, device), w))
    c = (pow(tau, n, P) - 1) * pow(n, -1, P) % P
    return mul(mul(w, inv), const(c, device))
