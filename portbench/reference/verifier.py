"""The verifying key worked out from a circuit's fixed columns and the
set-up's secret, and the proof check (the protocol of
zksnap_tpu_torch/prover/plonk.py, read from its verifier, frozen here).

The set-up is the dev ceremony: tau is a hash of its seed, so the
reference knows it.  A commitment to the column with values v_i is then
[sum_i v_i L_i(tau)] G, with no SRS, and the KZG pairing equation
e(lhs, G2) == e(rhs, [tau] G2) holds exactly when lhs == tau * rhs in G1:
the check below tests the latter.

The protocol: one basic gate q_c (a + a(wX) a(w^2 X) - a(w^3 X)) per
advice column; logUp over the range table; the copy permutation in
grand products of PERM_CHUNK columns each, chained at row `usable`;
the quotient over an extended domain in 2^ext_log pieces; evaluations at
x, wx, w^2 x, w^3 x and w^usable x; GWC opening witnesses per point.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

from ..natives.curve import BN254_G1, AffinePoint
from . import fr
from .layout import PERM_CHUNK, Fixed
from .transcript import Reader

P = fr.P
POINTS = ("x", "wx", "w2x", "w3x", "wux")


def tau_from_seed(seed: str) -> int:
    return int.from_bytes(hashlib.sha512(b"zksnap-tpu-srs" + seed.encode())
                          .digest(), "big") % BN254_G1.n


@dataclass
class VK:
    k: int
    ext_log: int
    n_advice: int
    n_lookup: int
    lookup_bits: int
    n_perm: int
    n_z: int
    usable: int
    deltas: list
    num_instance: int
    commitments: dict  # name -> AffinePoint
    omega: int


def _commit(s: int) -> AffinePoint:
    return s * AffinePoint.generator(BN254_G1)


def column_scalars(fixed: Fixed, tau: int, device) -> dict:
    """sum_i v_i L_i(tau) of every fixed column, by name."""
    n, k = fixed.n, fixed.k
    lag = fr.lagrange_at(tau, k, device)
    out = {}
    for c, rows in enumerate(fixed.q_rows):
        mask = torch.zeros(n, dtype=torch.bool, device=device)
        mask[torch.as_tensor(rows, device=device)] = True
        out[f"q_{c}"] = fr.total(lag, mask)
    nz = int(fixed.const_col.any(axis=1).nonzero()[0].max(initial=-1)) + 1
    out["const"] = (fr.total(fr.mul(fr.from_u16(fixed.const_col[:nz], device),
                                    lag[:nz])) if nz else 0)
    tb = 1 << fixed.lookup_bits
    out["table"] = fr.total(fr.mul(fr.from_ints(list(range(tb)), device),
                                   lag[:tb]))
    out["active"] = fr.total(lag[: fixed.usable])
    w = fr.powers(fr.omega(k), n, device)
    dl = fr.from_ints(fixed.deltas, device)
    for j in range(fixed.n_perm):
        sg = torch.from_numpy(fixed.sigma[j].astype("int64")).to(device)
        vals = fr.mul(dl[sg[:, 0]], w[sg[:, 1]])
        out[f"sigma_{j}"] = fr.total(fr.mul(vals, lag))
        del sg, vals
    return out


def derive_vk(fixed: Fixed, tau: int, num_instance: int, device) -> VK:
    scalars = column_scalars(fixed, tau, device)
    return VK(k=fixed.k, ext_log=fixed.ext_log, n_advice=fixed.n_advice,
              n_lookup=fixed.n_lookup, lookup_bits=fixed.lookup_bits,
              n_perm=fixed.n_perm, n_z=-(-fixed.n_perm // PERM_CHUNK),
              usable=fixed.usable, deltas=list(fixed.deltas),
              num_instance=num_instance,
              commitments={nm: _commit(s) for nm, s in scalars.items()},
              omega=fr.omega(fixed.k))


def _queries(vk: VK) -> list:
    q = set()
    for i in range(vk.n_advice):
        for pt in ("x", "wx", "w2x", "w3x"):
            q.add((f"advice_{i}", pt))
        q.add((f"q_{i}", "x"))
    for i in range(vk.n_lookup):
        q.add((f"lookup_{i}", "x"))
    for nm in ("const", "table", "active", "m", "h"):
        q.add((nm, "x"))
    q.add(("h", "wx"))
    for c in range(vk.n_z):
        q.add((f"z_{c}", "x"))
        q.add((f"z_{c}", "wx"))
        if c < vk.n_z - 1:
            q.add((f"z_{c}", "wux"))
    for j in range(vk.n_perm):
        q.add((f"sigma_{j}", "x"))
    q.add(("t", "x"))          # derived by the verifier
    q.add(("instance", "x"))   # derived by the verifier
    return sorted(q)


def _lagrange_scalar(i: int, x: int, k: int) -> int:
    n, w = 1 << k, pow(fr.omega(k), i, P)
    return w * (pow(x, n, P) - 1) % P * pow(n * (x - w) % P, -1, P) % P


def _accumulators(vk: VK, tau: int, instances: list, proof: bytes):
    """(lhs, rhs) with the proof valid iff lhs == tau * rhs; raises
    ValueError on a malformed stream."""
    n, omega = 1 << vk.k, vk.omega
    tr = Reader(proof)
    for v in instances:
        tr.absorb_scalar(v)
    comm = dict(vk.commitments)
    for i in range(vk.n_advice):
        comm[f"advice_{i}"] = tr.point()
    for i in range(vk.n_lookup):
        comm[f"lookup_{i}"] = tr.point()
    comm["m"] = tr.point()
    beta_lk, beta, gamma = tr.challenge(), tr.challenge(), tr.challenge()
    comm["h"] = tr.point()
    for c in range(vk.n_z):
        comm[f"z_{c}"] = tr.point()
    y = tr.challenge()
    E = 1 << vk.ext_log
    t_parts = [tr.point() for _ in range(E)]
    x = tr.challenge()

    queries = _queries(vk)
    ev = {}
    for nm, pt in queries:
        if nm not in ("instance", "t"):
            ev[(nm, pt)] = tr.scalar()
    ev[("instance", "x")] = sum(
        v * _lagrange_scalar(i, x, vk.k) for i, v in enumerate(instances)
        if v % P) % P
    v_ch, u_ch = tr.challenge(), tr.challenge()

    # the constraints at x, combined by y in the prover's order
    perm_names = ([f"advice_{c}" for c in range(vk.n_advice)]
                  + [f"lookup_{c}" for c in range(vk.n_lookup)]
                  + ["const", "instance"])
    acc = 0
    for c in range(vk.n_advice):
        a0, a1, a2, a3 = (ev[(f"advice_{c}", pt)]
                          for pt in ("x", "wx", "w2x", "w3x"))
        acc = (acc * y + ev[(f"q_{c}", "x")] * (a0 + a1 * a2 - a3)) % P
    if vk.n_lookup:
        T = (ev[("table", "x")] + beta_lk) % P
        Ls = [(ev[(f"lookup_{c}", "x")] + beta_lk) % P
              for c in range(vk.n_lookup)]
        prod = 1
        for lv in Ls:
            prod = prod * lv % P
        term = (ev[("h", "wx")] - ev[("h", "x")]) * prod % P * T % P
        for j in range(vk.n_lookup):
            others = 1
            for j2 in range(vk.n_lookup):
                if j2 != j:
                    others = others * Ls[j2] % P
            term = (term - others * T) % P
        acc = (acc * y + term + ev[("m", "x")] * prod) % P
    for c in range(vk.n_z):
        num = den = 1
        for j in range(c * PERM_CHUNK, min((c + 1) * PERM_CHUNK, vk.n_perm)):
            vj = ev[(perm_names[j], "x")]
            num = num * ((vj + beta * vk.deltas[j] % P * x + gamma) % P) % P
            den = den * ((vj + beta * ev[(f"sigma_{j}", "x")] + gamma) % P) % P
        term = (ev[(f"z_{c}", "wx")] * den - ev[(f"z_{c}", "x")] * num) % P
        acc = (acc * y + ev[("active", "x")] * term) % P
    zh = (pow(x, n, P) - 1) % P
    l0 = zh * pow(n * (x - 1) % P, -1, P) % P
    wu = pow(omega, vk.usable, P)
    lu = wu * zh % P * pow(n * (x - wu) % P, -1, P) % P
    acc = (acc * y + l0 * (ev[("z_0", "x")] - 1)) % P
    for c in range(1, vk.n_z):
        acc = (acc * y + l0 * (ev[(f"z_{c}", "x")]
                               - ev[(f"z_{c-1}", "wux")])) % P
    acc = (acc * y + lu * (ev[(f"z_{vk.n_z - 1}", "x")] - 1)) % P

    # the quotient's claimed value follows from the identity
    ev[("t", "x")] = acc * pow(zh, -1, P) % P
    xn = pow(x, n, P)
    t_comb, xp = AffinePoint.identity(BN254_G1), 1
    for part in t_parts:
        t_comb = t_comb + xp * part
        xp = xp * xn % P
    comm["t"] = t_comb
    comm["instance"] = _commit(sum(
        v * _lagrange_scalar(i, tau, vk.k) for i, v in enumerate(instances)
        if v % P) % P)

    at = {"x": x, "wx": x * omega % P, "w2x": x * pow(omega, 2, P) % P,
          "w3x": x * pow(omega, 3, P) % P, "wux": x * wu % P}
    by_point: dict = {}
    for nm, pt in queries:
        by_point.setdefault(pt, []).append(nm)
    wits = {pt: tr.point() for pt in POINTS if by_point.get(pt)}
    lhs = rhs = AffinePoint.identity(BN254_G1)
    gen = AffinePoint.generator(BN254_G1)
    u_pow = 1
    for pt in POINTS:
        names = by_point.get(pt)
        if not names:
            continue
        coef, f_acc, e_acc = 1, AffinePoint.identity(BN254_G1), 0
        for nm in names:
            f_acc = f_acc + coef * comm[nm]
            e_acc = (e_acc + coef * ev[(nm, pt)]) % P
            coef = coef * v_ch % P
        w = wits[pt]
        lhs = lhs + u_pow * (f_acc + at[pt] * w - e_acc * gen)
        rhs = rhs + u_pow * w
        u_pow = u_pow * u_ch % P
    if not tr.done():
        raise ValueError("trailing bytes")
    return lhs, rhs


def verify(vk: VK, tau: int, instances: list, proof: bytes) -> bool:
    try:
        lhs, rhs = _accumulators(vk, tau, instances, proof)
    except ValueError:
        return False
    return lhs == tau * rhs
