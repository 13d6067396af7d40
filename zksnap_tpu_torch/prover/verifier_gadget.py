# Copy of zksnap_tpu/prover/verifier_gadget.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""In-circuit PLONK succinct verifier (the recursion circuit's core).

Reference parity: snark-verifier's `PlonkSuccinctVerifier::verify` run
under the `Halo2Loader` (wrapper.rs:302-359 `succinct_verify`): replay
the Fiat-Shamir transcript over circuit cells, enforce the quotient
identity at x, and aggregate the GWC openings into a KZG accumulator
(lhs, rhs) -- NO pairing; the wrapper folds accumulators and the chain
pays one pairing at decide time (wrapper.rs:1140-1158).

This is the exact cell-level mirror of prover/plonk.py
`_verify_succinct`: every challenge, evaluation and coefficient is a
native-Fr cell computed with flex-gate ops; every commitment is either a
constant (fixed child protocols: voter, state_transition) or a witnessed
non-native point (the previous wrapper's protocol, pinned by a Poseidon
digest -- wrapper.rs:311-325); the two final MSMs run on the lazy
incomplete-add gadget (gadgets/ecc_msm.py).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..curves.native import BN254_G1, AffinePoint
from ..gadgets.bigint import BigUintChip
from ..gadgets.ecc import EccGadget, NNPoint
from ..gadgets.ecc_msm import MsmGadget
from ..gadgets.nonnative import NonNativeChip
from ..gadgets.poseidon_gadget import PoseidonGadget
from ..gadgets.transcript_gadget import ProofReader, TranscriptGadget
from ..trace.context import Cell, Context
from .plonk import POINT_NAMES, VerifyingKey, _perm_chunks, _query_plan


@dataclass
class VerifierChips:
    """Shared chip set for one wrapper circuit."""

    fq: NonNativeChip
    ecc: EccGadget
    msm: MsmGadget
    pg: PoseidonGadget

    @classmethod
    def create(cls, ctx: Context, msm_window: int = 4,
               unsound_truncate_bits: int | None = None) -> "VerifierChips":
        big = BigUintChip(ctx)
        fq = NonNativeChip(ctx, big, BN254_G1.p)
        ecc = EccGadget(ctx, fq, 0, BN254_G1.b)
        msm = MsmGadget(ctx, fq, window=msm_window,
                        unsound_truncate_bits=unsound_truncate_bits)
        return cls(fq=fq, ecc=ecc, msm=msm, pg=PoseidonGadget(ctx))


@dataclass
class VerifiedSnark:
    """Result of one in-circuit succinct verification."""

    lhs: NNPoint                # pairs with [tau]G2
    rhs: NNPoint                # pairs with G2
    instance_cells: list[Cell]  # the instances this verification bound
    protocol_cells: list[NNPoint] | None  # witnessed vk comms (digest input)


def _inv(ctx: Context, a: Cell) -> Cell:
    """Witnessed modular inverse; constrains a * inv == 1 (so a != 0)."""
    v = pow(a.value, -1, ctx.p) if a.value % ctx.p else 0
    inv = ctx.load_witness(v)
    ctx.constrain_equal(ctx.mul(a, inv), ctx.load_constant(1))
    return inv


@functools.lru_cache(maxsize=8)
def _lagrange_points(k: int, count: int) -> tuple:
    """First `count` Lagrange-basis SRS points as native affine points.

    Computed DIRECTLY from the dev-SRS tau (same formula as srs.gen_srs:
    L_i(tau) = w^i (tau^n - 1) / (n (tau - w^i)), then one native scalar
    mult per point) -- the former `gen_srs(k)` call regenerated the full
    2^k SRS to read `count` (~42) points, which sat >40min inside wrapper
    synthesis at k=21 (VERDICT r4 weak #3).  Matches srs.g1_lagrange
    exactly for the default dev seed, which is what the in-circuit
    verifier has always used here."""
    from ..curves.native import AffinePoint, BN254_G1
    from ..fields.field import bn254_fr
    from ..poly.domain import domain
    from .srs import _tau_from_seed

    F = bn254_fr()
    n = 1 << k
    tau = _tau_from_seed(b"dev")
    omega = domain(k).omega
    zn = (pow(tau, n, F.p) - 1) % F.p
    n_inv = pow(n, -1, F.p)
    g = AffinePoint.generator(BN254_G1)
    pts = []
    w = 1
    for _ in range(count):
        lag = w * zn % F.p * n_inv % F.p * pow(tau - w, -1, F.p) % F.p
        pts.append(lag * g)
        w = w * omega % F.p
    return tuple(pts)


def succinct_verify_gadget(
    ctx: Context,
    chips: VerifierChips,
    vk: VerifyingKey,
    instance_cells: list[Cell],
    proof: bytes,
    protocol_witness: bool = False,
) -> VerifiedSnark:
    """Verify one snark inside the circuit; returns its KZG accumulator.

    `instance_cells` must already be assigned by the caller (they carry
    the claimed public inputs; the wrapper constrains them against its
    own instances / cross-proof consistency).  `protocol_witness=True`
    witnesses the vk commitments instead of embedding them as constants
    (the previous-wrapper case; caller must digest-pin `protocol_cells`).
    MSM sizing (window, test truncation) is configured on `chips.msm`.
    """
    p = ctx.p
    fq, ecc, msm = chips.fq, chips.ecc, chips.msm
    tg = TranscriptGadget(ctx, chips.pg)
    reader = ProofReader(ctx, tg, fq, ecc, proof)
    assert len(instance_cells) == vk.num_instance

    for c in instance_cells:
        reader.absorb_scalar_cell(c)

    # -- fixed commitments: constants or witnessed-and-returned -------------
    protocol_cells: list[NNPoint] | None = None
    comm: dict = {}
    if protocol_witness:
        protocol_cells = []
        for name in sorted(vk.commitments.keys()):
            pt = vk.commitments[name]
            x, y = (0, 0) if pt.is_identity() else (pt.x, pt.y)
            nx, ny = fq.assign(x), fq.assign(y)
            is_inf = ctx.mul(fq.is_zero(nx), fq.is_zero(ny))
            np_ = NNPoint(nx, ny, is_inf)
            ecc.assert_on_curve(np_)
            comm[name] = np_
            protocol_cells.append(np_)
    else:
        comm.update(vk.commitments)  # native AffinePoints -> constant bases

    # -- transcript replay ----------------------------------------------------
    for i in range(vk.n_advice):
        comm[f"advice_{i}"] = reader.read_point()
    for i in range(vk.n_lookup):
        comm[f"lookup_{i}"] = reader.read_point()
    comm["m"] = reader.read_point()
    beta_lk = reader.challenge()
    beta = reader.challenge()
    gamma = reader.challenge()
    comm["h"] = reader.read_point()
    for c in range(vk.n_z):
        comm[f"z_{c}"] = reader.read_point()
    y = reader.challenge()
    E = 1 << vk.ext_log
    for i in range(E):
        comm[f"t_{i}"] = reader.read_point()
    x = reader.challenge()

    queries = _query_plan(vk, E)
    evals: dict = {}
    for nm, pt in sorted(queries):
        if nm in ("instance", "t"):
            continue  # derived, never part of the stream
        evals[(nm, pt)] = reader.read_scalar()

    # -- instance evaluation at x (barycentric) -------------------------------
    n = 1 << vk.k
    xn = x
    for _ in range(vk.k):
        xn = ctx.mul(xn, xn)
    zh_x = ctx.add_const(xn, -1)
    omega = vk.omega
    acc = ctx.load_constant(0)
    w = 1
    for c in instance_cells:
        d = ctx.add_const(x, -w)          # x - w^i
        d_inv = _inv(ctx, d)
        term = ctx.mul(ctx.scalar_mul(c, w), d_inv)
        acc = ctx.add(acc, term)
        w = w * omega % p
    n_inv = pow(n, -1, p)
    evals[("instance", "x")] = ctx.scalar_mul(ctx.mul(acc, zh_x), n_inv)

    v_ch = reader.challenge()
    u_ch = reader.challenge()

    # -- quotient identity at x (plonk.py _verify_succinct mirror) ------------
    perm_names = ([f"advice_{c}" for c in range(vk.n_advice)]
                  + [f"lookup_{c}" for c in range(vk.n_lookup)]
                  + ["const", "instance"])
    chunks = _perm_chunks(vk.n_perm)
    total = ctx.load_constant(0)
    for c in range(vk.n_advice):
        a = evals[(f"advice_{c}", "x")]
        a1 = evals[(f"advice_{c}", "wx")]
        a2 = evals[(f"advice_{c}", "w2x")]
        a3 = evals[(f"advice_{c}", "w3x")]
        expr = ctx.sub(ctx.mul_add(a1, a2, a), a3)
        total = ctx.mul_add(evals[(f"q_{c}", "x")], expr, ctx.mul(total, y))
    if vk.n_lookup:
        T = ctx.add(evals[("table", "x")], beta_lk)
        Ls = [ctx.add(evals[(f"lookup_{c}", "x")], beta_lk)
              for c in range(vk.n_lookup)]
        prod_all = Ls[0]
        for l in Ls[1:]:
            prod_all = ctx.mul(prod_all, l)
        dh = ctx.sub(evals[("h", "wx")], evals[("h", "x")])
        term = ctx.mul(ctx.mul(dh, prod_all), T)
        for j in range(vk.n_lookup):
            others = None
            for j2 in range(vk.n_lookup):
                if j2 != j:
                    others = Ls[j2] if others is None else ctx.mul(others, Ls[j2])
            part = T if others is None else ctx.mul(others, T)
            term = ctx.sub(term, part)
        term = ctx.mul_add(evals[("m", "x")], prod_all, term)
        total = ctx.add(ctx.mul(total, y), term)
    for c, chunk in enumerate(chunks):
        num, den = None, None
        for j in chunk:
            vj = evals[(perm_names[j], "x")]
            bd = ctx.mul(ctx.scalar_mul(beta, vk.deltas[j]), x)
            lhs_f = ctx.add(ctx.add(vj, bd), gamma)
            rhs_f = ctx.add(ctx.mul_add(beta, evals[(f"sigma_{j}", "x")], vj),
                            gamma)
            num = lhs_f if num is None else ctx.mul(num, lhs_f)
            den = rhs_f if den is None else ctx.mul(den, rhs_f)
        term = ctx.sub(ctx.mul(evals[(f"z_{c}", "wx")], den),
                       ctx.mul(evals[(f"z_{c}", "x")], num))
        total = ctx.mul_add(evals[("active", "x")], term, ctx.mul(total, y))

    l0_den = _inv(ctx, ctx.scalar_mul(ctx.add_const(x, -1), n))
    l0_x = ctx.mul(zh_x, l0_den)
    wu = pow(omega, vk.usable, p)
    lu_den = _inv(ctx, ctx.scalar_mul(ctx.add_const(x, -wu), n))
    lu_x = ctx.mul(ctx.scalar_mul(zh_x, wu), lu_den)

    total = ctx.mul_add(
        l0_x, ctx.add_const(evals[("z_0", "x")], -1), ctx.mul(total, y))
    for c in range(1, vk.n_z):
        chain = ctx.sub(evals[(f"z_{c}", "x")], evals[(f"z_{c-1}", "wux")])
        total = ctx.mul_add(l0_x, chain, ctx.mul(total, y))
    total = ctx.mul_add(
        lu_x, ctx.add_const(evals[(f"z_{vk.n_z-1}", "x")], -1),
        ctx.mul(total, y))

    # derived quotient opening claim t(x) = total / zh(x) (see plonk.py
    # _query_plan): no hard identity constraint -- an invalid child proof
    # surfaces as a bad accumulator, which round 0 selects away
    # (wrapper.rs:361-385) and any other round fails at the decide pairing.
    zh_inv = _inv(ctx, zh_x)
    evals[("t", "x")] = ctx.mul(total, zh_inv)

    # -- GWC aggregation -------------------------------------------------------
    by_point: dict[str, list[str]] = {}
    for nm, pt in sorted(queries):
        by_point.setdefault(pt, []).append(nm)

    w_comms = {}
    for pt_name in POINT_NAMES:
        if by_point.get(pt_name):
            w_comms[pt_name] = reader.read_point()

    # evaluation points as cells: x * omega^shift
    shift = {"x": 0, "wx": 1, "w2x": 2, "w3x": 3, "wux": vk.usable}
    eval_pt = {nm: (x if s == 0 else ctx.scalar_mul(x, pow(omega, s, p)))
               for nm, s in shift.items() if nm in w_comms}

    neg_gen = -AffinePoint.generator(BN254_G1)
    lagranges = (_lagrange_points(vk.k, vk.num_instance)
                 if vk.num_instance else ())

    # Scalars are AGGREGATED per unique base before the MSM: a commitment
    # opened at several points (advice: x, wx, w2x, w3x; z: x, wx, wux)
    # previously entered the MSM once per query -- at ~290k trace cells
    # per in-circuit MSM term that multiplied the wrapper's cell count
    # >2x and made the k=21 self-shape solve diverge (r5).  Summing the
    # Fr scalars first (a few cells each) is the same group element;
    # snark-verifier's query-map collapse does the identical thing.
    agg: dict = {}  # base key -> [scalar_cell, base]

    def add_pair(scal: Cell, base):
        if isinstance(base, AffinePoint):
            if base.is_identity():
                return  # contributes nothing
            key = (base.x, base.y)
        else:
            key = id(base)  # witnessed point: object identity
        e = agg.get(key)
        if e is None:
            agg[key] = [scal, base]
        else:
            e[0] = ctx.add(e[0], scal)

    u_pow: Cell | None = None  # None == 1 (first set)
    one = ctx.load_constant(1)
    e_total = ctx.load_constant(0)  # sum_sets u_pow * e_acc (single -G pair)
    rhs_pairs: list = []
    for pt_name in POINT_NAMES:
        names = by_point.get(pt_name)
        if not names:
            continue
        up = u_pow if u_pow is not None else one
        coef: Cell | None = None  # None == 1
        e_acc = ctx.load_constant(0)
        for nm in names:
            cf = coef if coef is not None else one
            e_acc = ctx.mul_add(cf, evals[(nm, pt_name)], e_acc)
            scal = ctx.mul(up, cf)
            if nm == "instance":
                for j, c in enumerate(instance_cells):
                    base = lagranges[j]
                    if not base.is_identity():
                        add_pair(ctx.mul(scal, c), base)
            elif nm == "t":
                # combined quotient commitment sum_i xn^i [t_i], expanded
                # into E MSM pairs instead of pre-combining
                xp: Cell | None = None  # None == 1
                for i in range(E):
                    s_i = scal if xp is None else ctx.mul(scal, xp)
                    add_pair(s_i, comm[f"t_{i}"])
                    xp = xn if xp is None else ctx.mul(xp, xn)
            else:
                add_pair(scal, comm[nm])
            coef = v_ch if coef is None else ctx.mul(coef, v_ch)
        w_pt = w_comms[pt_name]
        add_pair(ctx.mul(up, eval_pt[pt_name]), w_pt)
        e_total = ctx.mul_add(up, e_acc, e_total)
        rhs_pairs.append((up, w_pt))
        u_pow = u_ch if u_pow is None else ctx.mul(u_pow, u_ch)
    add_pair(e_total, neg_gen)
    lhs_pairs = [(s, b) for s, b in agg.values()]

    # naming per accumulator.py: acc.lhs pairs with [tau]G2 (the W sum),
    # acc.rhs pairs with G2 (the F + zW - eG combination)
    g2_side = msm.msm(lhs_pairs)
    tau_side = msm.msm(rhs_pairs)
    assert reader.done(), "proof stream length mismatch"
    return VerifiedSnark(lhs=tau_side, rhs=g2_side,
                         instance_cells=instance_cells,
                         protocol_cells=protocol_cells)
