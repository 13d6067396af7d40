"""Device-side prover round computations: the logUp helper column h, the
chained permutation grand products Z and omega power tables (PyTorch port
of zksnap_tpu/prover/device_rounds.py).

Denominators are inverted with the log-depth `PrimeField.batch_inv`;
running sums and products are Hillis-Steele prefix scans (log2(n)
full-width adds or multiplies).
"""

from __future__ import annotations

import functools

import torch

from ..fields.common import N_LIMBS
from ..fields.field import bn254_fr

FR = bn254_fr()


@functools.lru_cache(maxsize=8)
def _omega_pows_cached(k: int, device: str):
    from ..poly.domain import domain

    omega = domain(k).omega
    n = 1 << k
    one = FR.one_t(device)
    acc = one.expand(n, N_LIMBS)
    idx = torch.arange(n, device=device)
    for b in range(k):
        w2b = FR.const_t(pow(omega, 1 << b, FR.p), device)
        fac = torch.where(((idx >> b) & 1).to(torch.bool)[:, None], w2b, one)
        acc = FR.mul(acc, fac)
    return acc


def _omega_pows_dev(k: int, device="cuda"):
    """[n,16] Montgomery table of omega^i: log2(n) full-width multiplies
    by the omega^(2^b) factors selected per bit of i."""
    return _omega_pows_cached(k, str(torch.device(device)))


def _prefix_op(op, x, identity, axis: int = 0):
    """Inclusive Hillis-Steele scan with `op` along `axis` (log2 rounds)."""
    n = x.shape[axis]
    idx_shape = [1] * x.ndim
    idx_shape[axis] = n
    idx = torch.arange(n, device=x.device).reshape(idx_shape)
    d = 1
    while d < n:
        sh = torch.where(idx >= d, torch.roll(x, d, dims=axis), identity)
        x = op(x, sh)
        d <<= 1
    return x


def compute_h_dev(k: int, lookup_devs: list, table_dev, mult_dev,
                  beta_lk: int):
    """logUp helper column (Montgomery [n,16]) and its closure residue:
    h[i+1] = h[i] + sum_j 1/(b+L_j[i]) - m[i]/(b+T[i])."""
    n = 1 << k
    dev = table_dev.device
    n_lookup = len(lookup_devs)
    bl = FR.const_t(beta_lk, dev)[None, :]
    dens = [FR.add(lk, bl) for lk in lookup_devs]
    dens.append(FR.add(table_dev, bl))
    invs = FR.batch_inv(torch.stack(dens).reshape(-1, N_LIMBS))
    invs = invs.reshape(n_lookup + 1, n, N_LIMBS)
    step = invs[0]
    for j in range(1, n_lookup):
        step = FR.add(step, invs[j])
    step = FR.sub(step, FR.mul(mult_dev, invs[n_lookup]))
    zero = torch.zeros((n, N_LIMBS), dtype=torch.int32, device=dev)
    incl = _prefix_op(FR.add, step, zero)
    # h[0] = 0, h[i] = sum_{j<i} step[j]; closure = incl[-1] (must be 0)
    h = torch.cat([zero[:1], incl[:-1]], dim=0)
    return h, incl[-1]


def compute_z_dev(layout, col_loader, sigma_loader, beta: int, gamma: int):
    """Chained permutation grand products, one PERM_CHUNK of columns at a
    time.  col_loader(j) / sigma_loader(j) give the evaluation form of
    permutation column j / sigma_j ([n,16] Montgomery; a list works for
    col_loader too).  Returns (list of z_c [n,16], closure), the closure
    equal to Montgomery one for a satisfied permutation."""
    from .keygen import PERM_CHUNK

    if isinstance(col_loader, (list, tuple)):
        cols_list = col_loader
        col_loader = lambda j: cols_list[j]  # noqa: E731
    n, u = layout.n, layout.usable
    n_perm = len(layout.perm_columns)
    first = col_loader(0)
    dev = first.device
    om = _omega_pows_dev(layout.k, dev)
    beta_d = FR.const_t(beta, dev)
    gamma_d = FR.const_t(gamma, dev)[None, :]
    carry = FR.one_t(dev)
    zs = []
    for c0 in range(0, n_perm, PERM_CHUNK):
        sz = min(PERM_CHUNK, n_perm - c0)
        num, den = None, None
        for j in range(c0, c0 + sz):
            col = col_loader(j)
            bd = FR.mul(beta_d, FR.const_t(layout.deltas[j], dev))
            lhs = FR.add(FR.add(col, FR.mul(bd[None, :], om)), gamma_d)
            rhs = FR.add(FR.add(col, FR.mul(beta_d[None, :],
                                            sigma_loader(j))), gamma_d)
            num = lhs if num is None else FR.mul(num, lhs)
            den = rhs if den is None else FR.mul(den, rhs)
        ratio = FR.mul(num[:u], FR.batch_inv(den[:u]))  # [u, 16]
        one = FR.one_t(dev).expand(ratio.shape)
        incl = _prefix_op(FR.mul, ratio, one, axis=0)
        new_carry = FR.mul(carry, incl[u - 1])
        cc = carry[None, :]
        body = FR.mul(incl, cc)  # z_c[1..u]
        tail = new_carry[None, :].expand(n - u - 1, N_LIMBS)
        zs.append(torch.cat([cc, body, tail], dim=0))
        carry = new_carry
    return zs, carry
