"""Number-theoretic transform over BN254 Fr: single device and
mesh-sharded (PyTorch port of zksnap_tpu/poly/ntt.py).

Single device: iterative radix-2 decimation-in-time, a bit-reversal
gather, then k stages, each one batched multiply (K1) and one add and
one subtract (K2) over [..., n/2, 16] limb tensors.

Mesh: the four-step NTT -- the length-n vector as an n1 x n2 matrix
sharded by rows over a 1-D `parallel.Mesh`; local NTTs of length n2, a
twiddle scale, one exchange between the mesh's devices (the JAX
package's all_to_all), then NTTs of length n1.
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
    """x: [..., n, 16] coefficients -> [..., n, 16] evaluations (natural
    order), one transform for each index of the leading dimensions (the
    JAX package's vmap, written out as a batch).

    twiddles: [n/2, 16] table of omega^i on x's device."""
    n = 1 << k
    lead = x.shape[:-2]
    x = x[..., torch.from_numpy(_bitrev_perm(k)).to(x.device), :]
    for s in range(k):
        m = 1 << s          # half-block
        nb = n >> (s + 1)   # number of blocks
        xb = x.reshape(*lead, nb, 2, m, 16)
        u = xb[..., 0, :, :]
        # twiddle for position j in a block: omega^(j * n/(2m))
        w = twiddles[:: (n // 2) // m] if m > 1 else twiddles[:1]
        t = F.mul(xb[..., 1, :, :], w[None, :, :])
        x = torch.cat([F.add(u, t), F.sub(u, t)], dim=-2).reshape(
            *lead, n, 16)
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



# ---------------------------------------------------------------------------
# Mesh-sharded four-step NTT
# ---------------------------------------------------------------------------

def four_step_input_perm(k: int, ndev: int) -> np.ndarray:
    """Gather indices putting x into the cyclic layout four_step_ntt expects:
    device d must hold x[d], x[d + n1], ..., x[d + (n2-1)*n1]."""
    n, n1 = 1 << k, ndev
    n2 = n // n1
    i = np.arange(n)
    return (i % n2) * n1 + i // n2  # x_prepared[d*n2 + j] = x[d + n1*j]


def four_step_output_perm(k: int, ndev: int) -> np.ndarray:
    """Gather indices mapping four_step_ntt's output (concatenated over
    devices) back to natural evaluation order: natural[X] = out[perm[X]]."""
    n, n1 = 1 << k, ndev
    n2 = n // n1
    chunk = n2 // n1  # t2-values per device after the transpose
    X = np.arange(n)
    t1, t2 = X // n2, X % n2
    d, r = t2 // chunk, t2 % chunk
    return d * n2 + t1 * chunk + r


@functools.lru_cache(maxsize=64)
def _shard_scale(k: int, ndev: int, d: int, inverse: bool, device: str):
    """Shard d's twiddle scale [n2, 16]: w^(d * t2) for t2 < n2, w the
    n-th root of unity (its inverse for `inverse`)."""
    dom = domain(k)
    w = dom.omega_inv if inverse else dom.omega
    return dom.powers_of(pow(w, d, dom.F.p), k - (ndev.bit_length() - 1),
                         device)


def four_step_ntt(x, k: int, mesh, axis: str = "x", inverse: bool = False):
    """NTT of size n = 2^k over the devices of `mesh` along `axis`.

    x: [n, 16] in the cyclic layout of `four_step_input_perm` (shard d
    takes rows [d*n2, (d+1)*n2), the residue class d).  Returns, on
    x's device, the permuted evaluation layout undone by
    `four_step_output_perm`.

    `inverse=True` runs the transform with omega^-1 throughout (the caller
    scales by n^-1), so iNTTs shard the same way.

    Math (s = i1 + n1*i2, t = t2 + n2*t1):
      X[t2 + n2 t1] = sum_i1 (w^(i1 t2) * NTT_n2(x[i1 + n1*.])[t2]) * (w^n2)^(i1 t1)
    i.e. local length-n2 NTTs -> twiddle scale by w^(i1*t2) -> the
    exchange (shard j receives chunk j of every shard) -> local length-n1
    NTTs, batched over the chunk.
    """
    devs = mesh.axis_devices(axis)
    ndev = len(devs)
    n = 1 << k
    if ndev & (ndev - 1) or n % ndev:
        raise ValueError(f"four-step NTT of 2^{k} over {ndev} devices")
    k1 = ndev.bit_length() - 1
    k2 = k - k1
    n1, n2 = ndev, n >> k1
    if n2 % n1:
        raise ValueError(f"four-step NTT needs n >= ndev^2 (2^{k}, {ndev})")
    chunk = n2 // n1
    d2, d1 = domain(k2), domain(k1)
    F = d2.F

    parts = []
    for d, dev in enumerate(devs):
        tw2 = d2.twiddles_inv(dev) if inverse else d2.twiddles(dev)
        y = _ntt_impl(x[d * n2:(d + 1) * n2].to(dev), tw2, k2, F)  # over t2
        y = F.mul(y, _shard_scale(k, ndev, d, inverse, str(dev)))
        parts.append(y.reshape(n1, chunk, 16))
    out = []
    for j, dev in enumerate(devs):
        z = torch.stack([p[j].to(dev) for p in parts], dim=1)  # [chunk, n1, 16]
        if k1 > 0:
            tw1 = d1.twiddles_inv(dev) if inverse else d1.twiddles(dev)
            z = _ntt_impl(z, tw1, k1, F)
        out.append(z.transpose(0, 1).reshape(n2, 16).to(x.device))
    return torch.cat(out)
