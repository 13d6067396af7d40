"""KZG structured reference string, dev setup (PyTorch port of
zksnap_tpu/prover/srs.py).

tau comes from a hash of the seed, exactly as in the JAX package.  The
G1 powers [tau^i]G and Lagrange points [L_i(tau)]G are batched
double-and-add scalar multiplications on the device (Jacobian kernels of
K3).  The results are cached in the JAX package's file format,
`srs_{k}_{sha8}.npz` holding uint32 x, y, z, lx, ly, lz before
normalisation, so the two packages can read each other's files.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from ..curves.jacobian import JacPoint, bn254_ops
from ..curves.native import BN254_G1, AffinePoint
from ..fields.common import ints_to_limbs
from ..fields.field import bn254_fr
from . import pairing as pr

DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..",
                                 "build")


class SRS:
    """[tau^i]G1 and [L_i(tau)]G1 for i < n (device) + [tau]G2 (host)."""

    def __init__(self, k: int, g1_powers: JacPoint, g1_lagrange: JacPoint,
                 tau_g2, g2):
        self.k = k
        self.n = 1 << k
        self.g1 = g1_powers            # JacPoint [n], monomial basis
        self.g1_lagrange = g1_lagrange  # JacPoint [n], Lagrange basis
        self.tau_g2 = tau_g2           # twist point (Fq2 pair)
        self.g2 = g2


def _tau_from_seed(seed: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"zksnap-tpu-srs" + seed).digest(),
                          "big") % BN254_G1.n


def srs_cache_path(k: int, seed: bytes = b"dev", cache_dir: str | None = None):
    d = DEFAULT_CACHE_DIR if cache_dir is None else cache_dir
    name = f"srs_{k}_{hashlib.sha256(seed).hexdigest()[:8]}.npz"
    return os.path.abspath(os.path.join(d, name))


_MEMO: dict = {}


def gen_srs(k: int, seed: bytes = b"dev", cache_dir: str | None = None,
            device="cuda") -> SRS:
    """Dev SRS for domain size 2^k, cached on disk in `cache_dir` (default:
    build/ at the repository root) and built on `device` (the card unless
    the caller names the CPU) when no file is there.  The SRS is a
    function of (k, seed) alone, so one per (k, seed) is kept in memory
    and later calls return it, on the device it was made on, whatever
    device they name."""
    key = (k, seed)
    if key not in _MEMO:
        _MEMO[key] = _gen_srs(k, seed, cache_dir, torch.device(device))
    return _MEMO[key]


def lagrange_prefix(k: int, m: int, seed: bytes = b"dev") -> list:
    """[L_i(tau)]G1 for i < m as host points, for the host verifier's
    instance commitment: taken from the SRS kept in memory when there is
    one for (k, seed), else m scalar multiplications on the host, so that
    a verifier needs neither a device nor the whole 2^k set-up."""
    srs = _MEMO.get((k, seed))
    if srs is not None:
        lag = srs.g1_lagrange
        return bn254_ops().to_affine_host(JacPoint(
            lag.x[:m], lag.y[:m], lag.z[:m])) if m else []
    from ..poly.domain import domain

    p = bn254_fr().p
    tau = _tau_from_seed(seed)
    n, omega = 1 << k, domain(k).omega
    # L_i(tau) = w^i (tau^n - 1) / (n (tau - w^i)), as _gen_srs makes them
    zn = (pow(tau, n, p) - 1) * pow(n, -1, p) % p
    g = AffinePoint.generator(BN254_G1)
    out, w = [], 1
    for _ in range(m):
        out.append((w * zn % p * pow(tau - w, -1, p) % p) * g)
        w = w * omega % p
    return out


def _gen_srs(k: int, seed: bytes, cache_dir, device) -> SRS:
    F = bn254_fr()
    ops = bn254_ops()
    n = 1 << k
    tau = _tau_from_seed(seed)
    cache = srs_cache_path(k, seed, cache_dir)
    if os.path.exists(cache):
        d = dict(np.load(cache))
    else:
        taus = [1] * n
        for i in range(1, n):
            taus[i] = taus[i - 1] * tau % F.p
        # Lagrange scalars: L_i(tau) = w^i (tau^n - 1) / (n (tau - w^i))
        from ..poly.domain import domain

        dom = domain(k)
        w = [1] * n
        for i in range(1, n):
            w[i] = w[i - 1] * dom.omega % F.p
        zn = (pow(tau, n, F.p) - 1) % F.p
        n_inv = pow(n, -1, F.p)
        denoms = [(tau - w[i]) % F.p for i in range(n)]
        pref = [1]
        for d_ in denoms:
            pref.append(pref[-1] * d_ % F.p)
        inv_tot = pow(pref[-1], -1, F.p)
        invs = [0] * n
        for i in range(n - 1, -1, -1):
            invs[i] = pref[i] * inv_tot % F.p
            inv_tot = inv_tot * denoms[i] % F.p
        lags = [w[i] * zn % F.p * n_inv % F.p * invs[i] % F.p
                for i in range(n)]
        # both bases in one batch of scalar multiplications
        both = _powers_to_points(ops, taus + lags, device)
        g1 = JacPoint(both.x[:n], both.y[:n], both.z[:n])
        g1_lag = JacPoint(both.x[n:], both.y[n:], both.z[n:])

        d = {name: t.cpu().numpy().astype(np.uint32) for name, t in (
            ("x", g1.x), ("y", g1.y), ("z", g1.z),
            ("lx", g1_lag.x), ("ly", g1_lag.y), ("lz", g1_lag.z))}
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        tmp = f"{cache}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **d)
        os.replace(tmp, cache)
    return srs_from_arrays(d, pr.g2_mul(pr.G2_GEN, tau), pr.G2_GEN, device)


def _powers_to_points(ops, scalars_int: list[int], device,
                      chunk: int = 1 << 20) -> JacPoint:
    """[s_i]G for each scalar, a batched MSB-first double-and-add over the
    254 scalar bits (Jacobian kernels), in chunks of 2^20 points."""
    nbits = 254
    idx = torch.arange(nbits - 1, -1, -1, device=device)
    parts = []
    for s in range(0, len(scalars_int), chunk):
        c = torch.from_numpy(ints_to_limbs(scalars_int[s : s + chunk])).to(
            device)
        bits = (c[:, idx // 16] >> (idx % 16)) & 1
        g = ops.generator((c.shape[0],), device)
        parts.append(ops.scalar_mul(g, bits))
    return JacPoint(*(torch.cat([getattr(p_, a) for p_ in parts])
                      for a in ("x", "y", "z")))


def srs_from_arrays(d: dict, tau_g2, g2, device="cuda") -> SRS:
    """SRS from the six [n, 16] arrays of the shared .npz format (x, y, z,
    lx, ly, lz; uint32 or int32, Jacobian), normalised to affine-or-
    identity (z in {0, 1}) as the MSM's mixed adds require."""
    ops = bn254_ops()

    def pts(a, b, c):
        return JacPoint(*(torch.from_numpy(np.asarray(d[k_]).astype(
            np.int32)).to(device) for k_ in (a, b, c)))

    g1 = _normalize_chunked(ops, pts("x", "y", "z"))
    g1_lag = _normalize_chunked(ops, pts("lx", "ly", "lz"))
    k = int(g1.x.shape[0]).bit_length() - 1
    return SRS(k, g1, g1_lag, tau_g2, g2)


def _normalize_chunked(ops, pts: JacPoint, chunk: int = 1 << 21) -> JacPoint:
    n = pts.x.shape[0]
    parts = [ops.normalize(JacPoint(pts.x[s : s + chunk],
                                    pts.y[s : s + chunk],
                                    pts.z[s : s + chunk]))
             for s in range(0, n, chunk)]
    return JacPoint(*(torch.cat([getattr(p_, a) for p_ in parts])
                      for a in ("x", "y", "z")))
