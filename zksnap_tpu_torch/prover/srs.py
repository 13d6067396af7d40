"""KZG structured reference string, dev setup (PyTorch port of
zksnap_tpu/prover/srs.py).

tau comes from a hash of the seed, exactly as in the JAX package.  The
G1 powers [tau^i]G and Lagrange points [L_i(tau)]G are batched
double-and-add scalar multiplications on the device (Jacobian kernels of
K3).  The results are cached in the JAX package's file format,
`srs_{k}_{sha8}.npz` holding uint32 x, y, z, lx, ly, lz before
normalisation, so the two packages can read each other's files.

`load_srs` / `save_srs` read and write a ceremony SRS in halo2's
`ParamsKZG` wire format, the byte layout of the JAX package's loader
(srs.py:174-287); `srs_sanity_check` and `_lagrange_sum_check` validate
one.  As in the JAX package, the host verifier's instance commitment
takes its Lagrange points from the dev set-up of the same k, so a proof
verifies with the port's `verify` only under an SRS of the dev tau.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from ..curves.jacobian import JacPoint, bn254_ops
from ..curves.native import BN254_G1, AffinePoint, bn254_generator
from ..fields.common import N_LIMBS, int_to_limbs, ints_to_limbs
from ..fields.field import bn254_fq, bn254_fr
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


# ---------------------------------------------------------------------------
# Ceremony SRS file ingestion (halo2 ParamsKZG wire format)
# ---------------------------------------------------------------------------
#
# Layout (halo2_proofs `ParamsKZG::write`, the format of the Axiom
# trusted-setup files the reference browser fetches):
#   k               u32 LE
#   g               2^k G1 points, 64 B each: x || y, 32-byte LE canonical
#                   Fq; the identity is encoded as x = y = 0
#   g_lagrange      2^k G1 points, same encoding
#   g2              G2 point, 128 B: x.c0 || x.c1 || y.c0 || y.c1 (LE Fq)
#   s_g2 = [tau]G2  G2 point, 128 B
# The G1 blocks are parsed with numpy and curve-checked on the device (one
# batch of field ops); the G2 points are checked on the host, the subgroup
# check included.  A loaded SRS passes the pairing sanity check
# e([tau]G1, G2) == e(G1, [tau]G2) and the Lagrange-basis identity
# sum_i [L_i(tau)]G1 == G1 before use.

def _ge(limbs: np.ndarray, p: int) -> np.ndarray:
    """Rows of 16-bit little-endian limbs [n, 16] that are >= p."""
    pl = int_to_limbs(p).astype(np.int64)
    gt = np.zeros(limbs.shape[0], dtype=bool)
    eq = np.ones(limbs.shape[0], dtype=bool)
    for i in range(N_LIMBS - 1, -1, -1):
        gt |= eq & (limbs[:, i] > pl[i])
        eq &= limbs[:, i] == pl[i]
    return gt | eq


def _read_g1_block(buf: bytes, off: int, n: int, device) -> JacPoint:
    """n encoded G1 points at byte `off` -> affine-or-identity JacPoint
    (z in {0, mont 1}) on `device`; ValueError names the first point that
    is not on the curve."""
    F = bn254_fq()
    raw = np.frombuffer(buf, dtype=np.uint8, count=64 * n, offset=off)
    limbs = raw.view("<u2").reshape(n, 2, N_LIMBS).astype(np.int64)
    ident = ~raw.reshape(n, 64).any(axis=1)
    bad = _ge(limbs[:, 0], F.p) | _ge(limbs[:, 1], F.p)
    lift = F.const_t(F.R, device)[None, :]  # canonical -> Montgomery
    x, y = (F.mul(torch.from_numpy(limbs[:, i].astype(np.int32)).to(device),
                  lift) for i in range(2))
    rhs = F.add(F.mul(F.square(x), x),
                F.const_t(BN254_G1.b, device)[None, :])
    off_curve = ~(F.square(y) == rhs).all(dim=-1)
    bad |= (off_curve.cpu().numpy() & ~ident)
    if bad.any():
        raise ValueError(f"G1 point at byte {off + 64 * int(bad.argmax())} "
                         "not on curve")
    inf = torch.from_numpy(ident).to(device)[:, None]
    one = F.one_t(device).expand(n, N_LIMBS)
    zero = torch.zeros_like(x)
    return JacPoint(torch.where(inf, zero, x), torch.where(inf, one, y),
                    torch.where(inf, zero, one))


def _g2_in_subgroup(pt) -> bool:
    """r-torsion check: [r]Q == identity.

    BN254's twist has a large cofactor, so an on-twist point is NOT
    necessarily in the r-order subgroup; pairings on off-subgroup points
    are ill-defined.  The reference stack (halo2curves) subgroup-checks G2
    on deserialization -- this is the equivalent for untrusted ceremony
    files.  g2_mul reduces the scalar mod r, so the ladder is inlined."""
    acc = None
    add = pt
    k = pr.R
    while k:
        if k & 1:
            acc = pr.g2_add(acc, add)
        add = pr.g2_add(add, add)
        k >>= 1
    return acc is None


def _read_g2(buf: bytes, off: int):
    c = [int.from_bytes(buf[off + 32 * i : off + 32 * (i + 1)], "little")
         for i in range(4)]
    pt = (pr.Fq2(c[0], c[1]), pr.Fq2(c[2], c[3]))
    if not pr.g2_is_on_curve(pt):
        raise ValueError(f"G2 point at byte {off} not on the twist")
    if not _g2_in_subgroup(pt):
        raise ValueError(f"G2 point at byte {off} not in the r-order subgroup")
    return pt


def load_srs(path: str, device="cuda") -> SRS:
    """Ingest a ceremony `.srs` file onto `device` (the card unless the
    caller names the CPU); validates before returning."""
    with open(path, "rb") as f:
        buf = f.read()
    k = int.from_bytes(buf[0:4], "little")
    n = 1 << k
    need = 4 + 2 * n * 64 + 2 * 128
    if len(buf) < need:
        raise ValueError(f"srs file truncated: {len(buf)} < {need}")
    device = torch.device(device)
    g1 = _read_g1_block(buf, 4, n, device)
    g1_lag = _read_g1_block(buf, 4 + n * 64, n, device)
    g2 = _read_g2(buf, 4 + 2 * n * 64)
    s_g2 = _read_g2(buf, 4 + 2 * n * 64 + 128)
    srs = SRS(k, g1, g1_lag, s_g2, g2)
    if not srs_sanity_check(srs):
        raise ValueError("srs failed the pairing sanity check")
    if not _lagrange_sum_check(srs):
        raise ValueError("srs failed the Lagrange-sum check")
    return srs


def _g1_bytes(pts: JacPoint) -> np.ndarray:
    """[n, 64] uint8 encodings x || y (canonical LE; identity zeros)."""
    F = bn254_fq()
    aff = bn254_ops().normalize(pts)
    raw_one = torch.zeros(N_LIMBS, dtype=torch.int32, device=aff.x.device)
    raw_one[0] = 1  # a Montgomery product with 1 leaves the canonical value
    inf = F.is_zero(aff.z)[:, None]
    xy = [torch.where(inf, torch.zeros_like(c), F.mul(c, raw_one[None, :]))
          for c in (aff.x, aff.y)]
    limbs = torch.stack(xy, dim=1).cpu().numpy().astype("<u2")
    return limbs.reshape(-1, 2 * N_LIMBS).view(np.uint8)


def save_srs(srs: SRS, path: str):
    """Write an SRS in the ceremony wire format (round-trip testing and
    dev-SRS export; byte layout identical to `load_srs`'s contract and to
    the JAX package's `save_srs`)."""
    out = bytearray()
    out += int(srs.k).to_bytes(4, "little")
    for block in (srs.g1, srs.g1_lagrange):
        out += _g1_bytes(block).tobytes()
    for g2pt in (srs.g2, srs.tau_g2):
        gx, gy = g2pt
        for c in (gx.a, gx.b, gy.a, gy.b):
            out += int(c).to_bytes(32, "little")
    with open(path, "wb") as f:
        f.write(bytes(out))


def _lagrange_sum_check(srs: SRS) -> bool:
    """sum_i [L_i(tau)]G1 == G1 (sum of the Lagrange basis is 1): a tree
    of Jacobian adds on the SRS's device (kernel K3)."""
    ops = bn254_ops()
    p = srs.g1_lagrange
    n = p.x.shape[0]
    while n > 1:
        half = n // 2
        p = ops.add(JacPoint(p.x[:half], p.y[:half], p.z[:half]),
                    JacPoint(p.x[half:n], p.y[half:n], p.z[half:n]))
        n = half
    return ops.to_affine_host(p)[0] == bn254_generator()


def srs_sanity_check(srs: SRS) -> bool:
    """e([tau]G1, G2) == e(G1, [tau]G2)."""
    ops = bn254_ops()
    pts = ops.to_affine_host(
        JacPoint(srs.g1.x[:2], srs.g1.y[:2], srs.g1.z[:2]))
    g1_0, g1_tau = pts
    if g1_0 != bn254_generator():
        return False
    return pr.pairing_check([
        (g1_tau, srs.g2),
        (-g1_0, srs.tau_g2),
    ])
