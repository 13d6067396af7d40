"""Montgomery multiply with a Karatsuba product and a REDC on the tensor
cores (kernel K10).

PyTorch counterpart of scripts/exp_mul_mxu.py, modulus BN254 Fr by default,
operands limb-major [16, B] (16-bit limbs in int32):

  base       -- 16x16 schoolbook + word-by-word REDC
  kar        -- two-level Karatsuba product (160 limb products), word REDC
                (its signed columns carried as signed; the JAX kernel
                carries them as uint32 and is wrong on a few inputs)
  mxu        -- schoolbook + the REDC as two products by fixed Toeplitz
                matrices of n' and p, on the tensor cores (u8 digits, s32
                accumulator: exact)
  kar+mxu    -- both (Karatsuba's signed columns carried into nonnegative
                ones before the digit split; the JAX kernel skips that and
                is wrong on every input)
  convonly   -- timing ablation: cols[i] ^ cols[i + 16], no reduction
  mxunocarry -- timing ablation: both products, no carry passes,
                mp[i] ^ mp[i + 32]

`mont_mul_mxu` launches csrc/exp_mul_mxu.cu on CUDA tensors and runs its
plain version on CPU tensors; `mont_mul_mxu.launches` counts launches.

    python -m zksnap_tpu_torch.experiments.exp_mul_mxu [batch_log2=18] [variants]
"""

from __future__ import annotations

import functools
import random
import sys

import numpy as np
import torch

from ..fields import bn254_fr
from ..fields.common import ints_to_limbs, limbs_to_ints
from .common import (MASK16, U32, as_u32, bench, check_device,
                     conv_schoolbook, cond_sub, device_name, limb_major,
                     n0_16, p_limbs16, parser, to_i32_bits, to_signed,
                     u32_tensor, word_redc)

FR = bn254_fr()
VARIANTS = ("base", "kar", "mxu", "kar+mxu", "convonly", "mxunocarry")
PRODUCTS = VARIANTS[:4]  # the variants that compute the Montgomery product


# ---------------------------------------------------------------------------
# the Toeplitz tables of the REDC (as the script builds them, in uint8)
# ---------------------------------------------------------------------------

def _limbs8(x: int, n: int) -> list[int]:
    return [(x >> (8 * i)) & 0xFF for i in range(n)]


@functools.cache
def mxu_tables(p: int):
    """(comps, NMAT uint8 [32, 47], PMAT uint8 [64, 32]).  comps lists the
    components (k, d) of T's columns: bits 8d.. of column k (d < 2) or its
    bits 16.. (d = 2), at 8-bit position 2k + d < 32;
    m = NMAT . comps (mod 2^256 after a carry pass), m * p = PMAT . m8."""
    nprime = (-pow(p, -1, 1 << 256)) % (1 << 256)
    np8, p8 = _limbs8(nprime, 32), _limbs8(p, 32)
    comps = [(k, d) for k in range(17) for d in range(3) if 2 * k + d < 32]
    nmat = np.zeros((32, len(comps)), np.uint8)
    for r, (k, d) in enumerate(comps):
        pos = 2 * k + d
        for j in range(pos, 32):
            nmat[j, r] = np8[j - pos]
    pmat = np.zeros((64, 32), np.uint8)
    for i in range(32):
        for j in range(i, i + 32):
            pmat[j, i] = p8[j - i]
    return comps, nmat, pmat


@functools.lru_cache(maxsize=8)
def _device_tables(p: int, device: str):
    """NMAT padded to K = 64 and PMAT, uint8 on the card."""
    _, nmat, pmat = mxu_tables(p)
    padded = np.zeros((32, 64), np.uint8)
    padded[:, :nmat.shape[1]] = nmat
    return (torch.from_numpy(padded).to(device),
            torch.from_numpy(pmat.copy()).to(device))


# ---------------------------------------------------------------------------
# plain versions: the script's arithmetic over lists of [B] int64 rows, each
# step wrapped mod 2^32 as the TPU's uint32 lanes wrap
# ---------------------------------------------------------------------------

def conv_mul_n(a, b, n: int):
    cols = [torch.zeros_like(a[0])] * (2 * n + 1)
    for i in range(n):
        for j in range(n):
            prod = a[i] * b[j]
            cols[i + j] = (cols[i + j] + (prod & MASK16)) & U32
            cols[i + j + 1] = (cols[i + j + 1] + (prod >> 16)) & U32
    return cols


def conv_mid(s_a, s_b, n: int):
    """Product of 17-bit-limb operands (the Karatsuba middle term)."""
    cols = [torch.zeros_like(s_a[0])] * (2 * n + 1)
    for i in range(n):
        xa, ca = s_a[i] & MASK16, s_a[i] >> 16
        for j in range(n):
            xb, cb = s_b[j] & MASK16, s_b[j] >> 16
            prod = xa * xb
            cross = torch.where(cb > 0, xa, 0) + torch.where(ca > 0, xb, 0)
            cols[i + j] = (cols[i + j] + (prod & MASK16)) & U32
            cols[i + j + 1] = (cols[i + j + 1] + (prod >> 16)
                               + (cross & MASK16)) & U32
            cols[i + j + 2] = (cols[i + j + 2] + (cross >> 16)
                               + ca * cb) & U32
    return cols


def conv_karatsuba(a, b, n: int = 16, depth: int = 2):
    """Karatsuba on limb lists -> 2n + 1 columns mod 2^32 (a column that is
    negative in the integers wraps)."""
    if depth == 0 or n <= 4:
        return conv_mul_n(a, b, n)
    h = n // 2
    s_a = [a[i] + a[h + i] for i in range(h)]
    s_b = [b[i] + b[h + i] for i in range(h)]
    z0 = conv_karatsuba(a[:h], b[:h], h, depth - 1)
    z2 = conv_karatsuba(a[h:], b[h:], h, depth - 1)
    z1 = conv_mid(s_a, s_b, h)
    out = [torch.zeros_like(a[0])] * (2 * n + 1)
    for i, v in enumerate(z0):
        out[i] = (out[i] + v) & U32
    for i, v in enumerate(z2):
        out[i + 2 * h] = (out[i + 2 * h] + v) & U32
    for i in range(len(z1)):
        out[i + h] = (out[i + h] + z1[i] - z0[i] - z2[i]) & U32
    return out


def carry_signed(cols: torch.Tensor) -> torch.Tensor:
    """Columns mod 2^32 read as signed, carried into nonnegative 16-bit
    columns."""
    out = []
    cols = to_signed(cols)
    c = torch.zeros_like(cols[0])
    for k in range(cols.shape[0]):
        v = cols[k] + c
        out.append(v & MASK16)
        c = v >> 16  # arithmetic: floor division
    return torch.stack(out)


def mxu_redc_plain(cols: torch.Tensor, p: int, nocarry: bool = False):
    """The REDC of the mxu variants on [33, B] nonnegative columns below
    2^23: the products in float64 (exact), the carries in int64."""
    comps, nmat, pmat = mxu_tables(p)
    dev = cols.device
    lhs = torch.stack([((cols[k] >> (8 * d)) if d < 2 else (cols[k] >> 16))
                       & 0xFF for k, d in comps])
    nm = torch.from_numpy(nmat.astype(np.float64)).to(dev)
    pm = torch.from_numpy(pmat.astype(np.float64)).to(dev)
    m_cols = (nm @ lhs.to(torch.float64)).to(torch.int64)
    if nocarry:
        m8 = m_cols & 0xFF
    else:
        digits, carry = [], torch.zeros_like(cols[0])
        for j in range(32):
            t = m_cols[j] + carry
            digits.append(t & 0xFF)
            carry = t >> 8
        m8 = torch.stack(digits)
    mp = (pm @ m8.to(torch.float64)).to(torch.int64)
    if nocarry:
        return mp[:16] ^ mp[32:48]

    def tdig(j):
        k, d = divmod(j, 2)
        v = (cols[k] >> (8 * d)) & 0xFF
        if d == 0 and k >= 1:
            v = v + (cols[k - 1] >> 16)
        return v

    carry = torch.zeros_like(cols[0])
    for j in range(32):
        carry = (mp[j] + tdig(j) + carry) >> 8
    out = []
    for i in range(16):
        j = 32 + 2 * i
        lo = mp[j] + tdig(j) + carry
        hi = mp[j + 1] + tdig(j + 1) + (lo >> 8)
        out.append((lo & 0xFF) | ((hi & 0xFF) << 8))
        carry = hi >> 8
    return cond_sub(out, carry, p_limbs16(p))


def mont_mul_mxu_plain(a: torch.Tensor, b: torch.Tensor, variant: str,
                       p: int) -> torch.Tensor:
    """The plain version of the K10 kernel for one variant."""
    x, y = as_u32(a), as_u32(b)
    if variant.startswith("kar"):
        cols = torch.stack(conv_karatsuba(list(x), list(y)))
    else:
        cols = conv_schoolbook(x, y)
    if variant == "convonly":
        out = cols[:16] ^ cols[16:32]
    elif variant == "mxunocarry":
        out = mxu_redc_plain(cols, p, nocarry=True)
    elif variant == "mxu":
        out = mxu_redc_plain(cols, p)
    elif variant == "kar+mxu":
        out = mxu_redc_plain(carry_signed(cols), p)
    else:
        out = word_redc(cols, p, signed=variant == "kar")
    return to_i32_bits(out)


def mont_mul_mxu(a: torch.Tensor, b: torch.Tensor, variant: str,
                 p: int) -> torch.Tensor:
    """One variant of the experiment mod p over [16, B] limb-major int32
    operands of 16-bit limbs (kernel K10).  The four product variants
    return a * b * 2^-256 mod p for inputs below p."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}")
    n = limb_major(a, "a")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"operands {tuple(a.shape)} on {a.device} and "
                         f"{tuple(b.shape)} on {b.device}")
    if check_device(a) == "cpu":
        return mont_mul_mxu_plain(a, b, variant, p)
    from .. import kernels

    nmat, pmat = _device_tables(p, str(a.device))
    out = torch.empty_like(a)
    with kernels.on_device(a, b, out, nmat, pmat) as stream:
        err = kernels.library().zk_exp_mxu_mul(
            VARIANTS.index(variant), kernels.operand(a, torch.int32, (16, n)),
            kernels.operand(b, torch.int32, (16, n)),
            kernels.operand(out, torch.int32, (16, n)), n,
            kernels.mod16_ptr(p), nmat.data_ptr(), pmat.data_ptr(), stream)
    kernels.check(err, "zk_exp_mxu_mul")
    mont_mul_mxu.launches += 1
    return out


mont_mul_mxu.launches = 0


def make_kernel(variant: str, p_int: int, n0: int, device="cuda"):
    """The script's `make_kernel`: a function of (a, b), [16, B] limbs
    (numpy uint32 or torch int32), moved to `device`.  n0, the script's
    argument, must be -p^-1 mod 2^16."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}")
    if n0 != n0_16(p_int):
        raise ValueError("n0 is not -p^-1 mod 2^16")

    def call(a, b):
        return mont_mul_mxu(u32_tensor(a, device), u32_tensor(b, device),
                            variant, p_int)

    return call


def oracle_inputs(seed: int = 0, n: int = 256):
    """n seeded pairs below p as python ints, their [16, n] limbs, and the
    Montgomery products the four product variants must return."""
    rng = random.Random(seed)
    p = FR.p
    avals = [rng.randrange(p) for _ in range(n)]
    bvals = [rng.randrange(p) for _ in range(n)]
    r_inv = pow(1 << 256, -1, p)
    want = [(x * y % p) * r_inv % p for x, y in zip(avals, bvals)]
    return (torch.from_numpy(ints_to_limbs(avals).T.copy()),
            torch.from_numpy(ints_to_limbs(bvals).T.copy()), want)


def main(argv=None) -> dict:
    """Check the product variants on 256 values against the host oracle,
    then time each variant at B = 2^batch_log2; prints the script's lines
    and returns {variant: {"ok", "ms", "mmul_s"}} ("ok" None for the
    timing-only ablations)."""
    ap = parser("exp_mul_mxu", __doc__.splitlines()[0])
    ap.add_argument("batch_log2", nargs="?", type=int, default=18)
    ap.add_argument("variants", nargs="?", default="base,mxu")
    args = ap.parse_args(argv)
    device, blog = args.device, args.batch_log2
    B = 1 << blog
    print(f"exp_mul_mxu on {device_name(device)}", flush=True)
    a_small, b_small, want = oracle_inputs()
    rng = np.random.default_rng(1)
    a_big = u32_tensor(rng.integers(0, 1 << 16, (16, B), dtype=np.uint32),
                       device)
    b_big = u32_tensor(rng.integers(0, 1 << 16, (16, B), dtype=np.uint32),
                       device)
    res = {}
    for variant in args.variants.split(","):
        fn = make_kernel(variant, FR.p, FR.n0, device)
        ok = None
        if variant in PRODUCTS:
            got = limbs_to_ints(fn(a_small, b_small).t().contiguous())
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            ok = not bad
            if bad:
                res[variant] = {"ok": False, "ms": None, "mmul_s": None}
                print(f"{variant}: WRONG ({len(bad)} bad, first {bad[:3]})",
                      flush=True)
                continue
        dt = bench(fn, (a_big, b_big), device, 20)
        res[variant] = {"ok": ok, "ms": dt * 1e3, "mmul_s": B / dt / 1e6}
        head = "(timing only)" if ok is None else "OK "
        print(f"{variant}: {head} {B/dt/1e6:.0f} Mmul/s  ({dt*1e3:.4f} ms"
              f" @ 2^{blog})", flush=True)
    return res


if __name__ == "__main__":
    r = main(sys.argv[1:])
    sys.exit(0 if all(v["ok"] is not False for v in r.values()) else 1)
