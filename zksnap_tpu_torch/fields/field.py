"""Batched prime-field arithmetic in Montgomery form (PyTorch port of
zksnap_tpu/fields/field.py).

One `PrimeField` per modulus (BN254 Fr/Fq, secp256k1 Fp/Fq).  Elements
are [..., 16] int32 tensors of 16-bit little-endian limbs in Montgomery
form (x * 2^256 mod p), always canonical (< p).  Multiplication goes
through kernel K1 and addition / subtraction through K2
(fields/pallas_mont.py): on a CUDA tensor the hand-written kernel, on a
CPU tensor its plain version.  Host conversions are python-int.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .common import (
    LIMB_BITS,
    N_LIMBS,
    int_to_limbs,
    ints_to_limbs_fast,
    limbs_to_int,
    limbs_to_ints,
)
from .pallas_mont import mont_addsub, mont_mul, redc_plain

R_BITS = N_LIMBS * LIMB_BITS  # 256


class PrimeField:
    """Arithmetic for Z/p with p < 2^256, batched over leading dims."""

    def __init__(self, name: str, modulus: int, generator: int | None = None):
        assert modulus % 2 == 1 and modulus < (1 << R_BITS)
        self.name = name
        self.p = modulus
        self.bits = modulus.bit_length()
        self.generator = generator  # multiplicative generator (NTT roots)
        self.R = 1 << R_BITS
        self.R_inv = pow(self.R, -1, modulus)
        # -p^-1 mod 2^16 (the JAX package's per-limb constant; the CUDA
        # kernels use -p^-1 mod 2^32, see kernels.modulus_words)
        self.n0 = (-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        t = modulus - 1
        self.two_adicity = (t & -t).bit_length() - 1

    # -- host-side canonical <-> Montgomery tensors ------------------------

    def to_mont(self, xs, device="cuda") -> torch.Tensor:
        """Python int or list of ints -> Montgomery limb tensor."""
        if isinstance(xs, int):
            arr = int_to_limbs(xs % self.p * self.R % self.p)
        else:
            arr = ints_to_limbs_fast([x % self.p * self.R % self.p
                                      for x in xs]).reshape(len(xs), N_LIMBS)
        return torch.from_numpy(arr).to(device)

    def from_mont(self, limbs) -> list | int:
        """Montgomery limb tensor -> python int(s) (host sync, host REDC)."""
        canon = limbs.detach().cpu().numpy() if isinstance(
            limbs, torch.Tensor) else np.asarray(limbs)
        if canon.ndim == 1:
            return limbs_to_int(canon) * self.R_inv % self.p
        return [v * self.R_inv % self.p for v in limbs_to_ints(canon)]

    # -- constants ----------------------------------------------------------

    def const_t(self, x: int, device) -> torch.Tensor:
        """Host constant -> Montgomery [16] tensor on `device`."""
        return _const_tensor(self.p, x % self.p, str(torch.device(device)))

    def one_t(self, device) -> torch.Tensor:
        return self.const_t(1, device)

    # -- modular add/sub/neg ------------------------------------------------

    def add(self, a, b):
        return mont_addsub(a, b, self.p, "add")

    def sub(self, a, b):
        return mont_addsub(a, b, self.p, "sub")

    def neg(self, a):
        """p - a, and 0 for 0 (a 0 - a subtraction)."""
        return mont_addsub(torch.zeros_like(a), a, self.p, "sub")

    def canon(self, a):
        """Reduce a value in [0, 2p) to [0, p) (an add of 0).  The port's
        kernels are canonical already; kept for the JAX call sites."""
        return mont_addsub(a, torch.zeros_like(a), self.p, "add")

    # -- Montgomery multiply ------------------------------------------------

    def mont_redc(self, cols):
        """REDC of int64 product columns [..., 32] (each below 2^37) ->
        canonical int32 limbs [..., 16] (plain torch, any device)."""
        return redc_plain(cols.to(torch.int64), self.p)

    def mul(self, a, b):
        return mont_mul(a, b, self.p)

    def square(self, a):
        return self.mul(a, a)

    def mont_reduce_narrow(self, a):
        """REDC(a) = a * 2^-256: Montgomery form -> canonical integer (a
        Montgomery product with the raw integer 1)."""
        return self.mul(a, _const_tensor(self.p, None, str(a.device)))

    # -- select / predicates -------------------------------------------------

    def select(self, cond, a, b):
        """cond ? a : b, cond is bool [...] matching leading dims."""
        return torch.where(cond[..., None], a, b)

    def is_zero(self, a):
        return (a == 0).all(dim=-1)

    # -- exponentiation / inversion ------------------------------------------

    def pow_const(self, a, e: int):
        """a^e for a host-known exponent (square-and-multiply, MSB first)."""
        result = self.one_t(a.device).expand(a.shape).contiguous()
        for bit in bin(e)[2:] if e else "":
            result = self.square(result)
            if bit == "1":
                result = self.mul(result, a)
        return result

    def inv(self, a):
        """Batched inversion via Fermat: a^(p-2).  inv(0) = 0."""
        return self.pow_const(a, self.p - 2)

    def batch_inv(self, a):
        """Inversion along the leading axis; zeros map to zeros.

        Montgomery's trick, log-depth as in the JAX package: Hillis-Steele
        prefix and suffix product scans (2 log2(n) full-width muls), one
        Fermat inversion of the total, then inv(a_i) = prefix_excl(i) *
        suffix_excl(i) * inv(total)."""
        n = a.shape[0]
        zero_mask = self.is_zero(a)
        one = self.one_t(a.device).expand(a.shape)
        a_safe = torch.where(zero_mask[..., None], one, a)
        if n == 1:
            inv = self.inv(a_safe)
            return torch.where(zero_mask[..., None], torch.zeros_like(a), inv)
        idx = torch.arange(n, device=a.device).reshape(
            (n,) + (1,) * (a.ndim - 1))
        pref = a_safe
        d = 1
        while d < n:
            sh = torch.where(idx >= d, torch.roll(pref, d, dims=0), one)
            pref = self.mul(pref, sh)
            d <<= 1
        suf = a_safe
        d = 1
        while d < n:
            sh = torch.where(idx < n - d, torch.roll(suf, -d, dims=0), one)
            suf = self.mul(suf, sh)
            d <<= 1
        total_inv = self.inv(pref[-1])
        pref_ex = torch.cat([one[:1], pref[:-1]], dim=0)
        suf_ex = torch.cat([suf[1:], one[:1]], dim=0)
        invs = self.mul(self.mul(pref_ex, suf_ex), total_inv[None])
        return torch.where(zero_mask[..., None], torch.zeros_like(a), invs)


@functools.lru_cache(maxsize=256)
def _const_tensor(p: int, x: int | None, device: str) -> torch.Tensor:
    """Montgomery constant x (or, for x=None, the raw integer 1) as a [16]
    int32 tensor on `device` (cached: constants recur in every round)."""
    raw = 1 if x is None else x * (1 << R_BITS) % p
    return torch.from_numpy(int_to_limbs(raw)).to(device)


# ---------------------------------------------------------------------------
# Field instances (moduli match halo2curves bn256 / secp256k1)
# ---------------------------------------------------------------------------

BN254_FR_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617
BN254_FQ_MOD = 21888242871839275222246405745257275088696311157297823662689037894645226208583
SECP_P = 2**256 - 2**32 - 977
SECP_N = 115792089237316195423570985008687907852837564279074904382605163141518161494337


@functools.cache
def bn254_fr() -> PrimeField:
    """BN254 scalar field (halo2curves bn256::Fr, generator 7, 2-adicity 28)."""
    return PrimeField("bn254_fr", BN254_FR_MOD, generator=7)


@functools.cache
def bn254_fq() -> PrimeField:
    """BN254 base field (halo2curves bn256::Fq)."""
    return PrimeField("bn254_fq", BN254_FQ_MOD, generator=3)


@functools.cache
def secp256k1_fp() -> PrimeField:
    """secp256k1 base field (halo2curves secp256k1::Fp)."""
    return PrimeField("secp_fp", SECP_P, generator=3)


@functools.cache
def secp256k1_fq() -> PrimeField:
    """secp256k1 scalar field (halo2curves secp256k1::Fq)."""
    return PrimeField("secp_fq", SECP_N, generator=7)
