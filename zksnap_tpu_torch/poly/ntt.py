"""Number-theoretic transform over BN254 Fr, single device (PyTorch port of
zksnap_tpu/poly/ntt.py; the mesh-sharded four-step NTT waits for the
multi-GPU port).

Iterative radix-2 decimation-in-time: a bit-reversal gather, then k
stages, each one batched multiply (K1) and one add and one subtract (K2)
over [n/2, 16] limb tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.field import PrimeField
from .domain import Domain, domain


@functools.cache
def _bitrev_perm(k: int) -> np.ndarray:
    n = 1 << k
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def _ntt_impl(x, twiddles, k: int, F: PrimeField):
    """x: [n, 16] coefficients -> [n, 16] evaluations (natural order).

    twiddles: [n/2, 16] table of omega^i on x's device."""
    n = 1 << k
    x = x[torch.from_numpy(_bitrev_perm(k)).to(x.device)]
    for s in range(k):
        m = 1 << s          # half-block
        nb = n >> (s + 1)   # number of blocks
        xb = x.reshape(nb, 2, m, 16)
        u = xb[:, 0]
        # twiddle for position j in a block: omega^(j * n/(2m))
        w = twiddles[:: (n // 2) // m] if m > 1 else twiddles[:1]
        t = F.mul(xb[:, 1], w[None, :, :])
        x = torch.cat([F.add(u, t), F.sub(u, t)], dim=1).reshape(n, 16)
    return x


class NTT:
    """NTT / inverse NTT for one domain size."""

    def __init__(self, dom: Domain):
        self.dom = dom
        self.F = dom.F
        self.k = dom.k

    def forward(self, x):
        """Coefficients -> evaluations on the domain (natural order)."""
        return _ntt_impl(x, self.dom.twiddles(x.device), self.k, self.F)

    def inverse(self, y):
        """Evaluations -> coefficients."""
        x = _ntt_impl(y, self.dom.twiddles_inv(y.device), self.k, self.F)
        return self.F.mul(x, self.F.const_t(self.dom.n_inv, y.device)[None])


@functools.cache
def ntt(k: int) -> NTT:
    return NTT(domain(k))

