"""Radix-2 evaluation domains over BN254 Fr (PyTorch port of
zksnap_tpu/poly/domain.py).

Twiddle tables are built on the tensor's device by repeated doubling (log n
batched multiplies): powers[0:2] = [1, w], then
powers[2^s:2^(s+1)] = powers[0:2^s] * w^(2^s).
"""

from __future__ import annotations

import functools

import torch

from ..fields.field import PrimeField, bn254_fr


class Domain:
    """Multiplicative subgroup of order 2^k with generator omega."""

    def __init__(self, F: PrimeField, k: int):
        assert k <= F.two_adicity
        self.F = F
        self.k = k
        self.n = 1 << k
        self.omega = pow(F.generator, (F.p - 1) >> k, F.p)
        self.omega_inv = pow(self.omega, -1, F.p)
        self.n_inv = pow(self.n, -1, F.p)
        self._tables = {}

    def powers_of(self, w_int: int, count_log2: int, device="cuda"):
        """[2^count_log2, 16] table of w^i in Montgomery form."""
        F = self.F
        one = F.one_t(device)[None, :]
        if count_log2 == 0:
            return one
        w = F.const_t(w_int, device)
        powers = torch.cat([one, w[None, :]])
        for _ in range(1, count_log2):
            mult = F.mul(powers[-1], w)  # w^(2^s)
            powers = torch.cat([powers, F.mul(powers, mult[None, :])])
        return powers

    def _table(self, w_int: int, device):
        key = (w_int, str(torch.device(device)))
        if key not in self._tables:
            self._tables[key] = self.powers_of(w_int, max(self.k - 1, 0),
                                               device)
        return self._tables[key]

    def twiddles(self, device="cuda"):
        """[n/2, 16] omega^i for i < n/2 (Montgomery), cached per device."""
        return self._table(self.omega, device)

    def twiddles_inv(self, device="cuda"):
        return self._table(self.omega_inv, device)


@functools.cache
def domain(k: int, field_name: str = "bn254_fr") -> Domain:
    assert field_name == "bn254_fr"
    return Domain(bn254_fr(), k)
