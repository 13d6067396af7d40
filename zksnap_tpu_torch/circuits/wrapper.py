# Copy of zksnap_tpu/circuits/wrapper.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""Wrapper (recursion) circuit -- the IVC step, in-circuit.

Reference parity: aggregator/src/wrapper.rs `RecursionCircuit`
(:408-777) plus its keygen machinery (`gen_dummy_snark`/`CsProxy`
:179-276, `gen_recursion_pk` :834-867, `gen_recursion_snark` :869-902).

Per round the circuit:
  1. succinctly verifies the round's voter snark and state-transition
     snark against their FIXED verifying keys (constants), and the
     previous wrapper snark against its OWN verifying key loaded as
     WITNESS (wrapper.rs:311-325) -- pinned by a Poseidon
     `preprocessed_digest` exposed as an instance and chained to the
     previous wrapper's digest instance row;
  2. selects the round-0 defaults (wrapper.rs:361-385): at round 0 the
     previous snark is a protocol-shaped dummy, so both the accumulator
     produced by verifying it AND the accumulator decoded from its
     instance rows are replaced by a constant valid accumulator
     (G, [tau]G);
  3. folds the four accumulators -- voter, state, prev-proof,
     prev-carried -- with a transcript-derived challenge
     (wrapper.rs:387-396; `KzgAs<Bn256,Gwc19>` fold is a pure RLC, see
     prover/accumulator.py), exposing the folded accumulator's
     LimbsEncoding<3,88> as instance rows 0..12;
  4. enforces the cross-proof data-consistency equalities
     (wrapper.rs:617-711) via a pluggable `linkage` hook so tests can
     drive the machinery with miniature child circuits while production
     uses `zksnap_linkage` (the reference's exact wiring).

Instance layout (wrapper.rs:423-431, :813-815): rows [0,12) folded
accumulator limbs, row 12 the preprocessed digest, rows [13, 13+P) the
protocol payload (see `zksnap_linkage`), last row the round index.
With the zksnap payload (P=28) this is the reference's 42-row layout
(prover/recursion.py row constants).

Keygen is a FIXED-POINT: the wrapper verifies a snark of its own shape,
so its structural parameters (advice/lookup columns, permutation size)
feed back into its own trace size.  `solve_wrapper_shape` iterates
dummy-witness synthesis (Context(assert_witness=False), the CsProxy
analogue) until the layout the trace induces equals the shape the trace
assumed.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field, replace
from typing import Callable

from ..curves.native import BN254_G1, AffinePoint
from ..fields.field import bn254_fr
from ..gadgets.bigint import AssignedBigUint
from ..gadgets.ecc import NNPoint
from ..gadgets.nonnative import NNElement
from ..hash.poseidon import PoseidonNative
from ..prover.accumulator import KzgAccumulator, decide
from ..prover.keygen import PERM_CHUNK, ZK_ROWS
from ..prover.plonk import (
    POINT_NAMES,
    VerifyingKey,
    _query_plan,
    verify_succinct,
)
from ..prover.recursion import Snark
from ..prover.transcript import Transcript, fe_to_limbs
from ..prover.verifier_gadget import VerifierChips, succinct_verify_gadget
from ..gadgets.transcript_gadget import TranscriptGadget
from ..trace.context import Cell, Context

FR = bn254_fr()
ACC_ROWS = 12      # 2 points x 2 coords x 3 limbs
DIGEST_ROW = 12


# ---------------------------------------------------------------------------
# Self-referential verifying-key shape
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WrapperShape:
    """Structural parameters of the wrapper's own verifying key -- all
    that the trace SHAPE (not values) depends on."""

    n_advice: int
    n_lookup: int
    n_z: int
    n_perm: int
    ext_log: int


def _shape_from_counts(k: int, n_cells: int, gate_offsets,
                       n_lookups: int) -> WrapperShape:
    """Mirror keygen.layout_circuit's structural accounting (the column
    break-point walk, lookup column count, permutation width) without
    materializing columns or the sigma permutation."""
    import numpy as np

    from ..prover.keygen import _advice_col_starts

    usable = (1 << k) - ZK_ROWS
    gates = np.sort(np.asarray(gate_offsets, dtype=np.int64))
    n_advice = len(_advice_col_starts(n_cells, gates, usable))
    n_lookup = max(1, -(-n_lookups // usable)) if n_lookups else 0
    from ..prover.keygen import quotient_ext_log

    n_perm = n_advice + n_lookup + 2
    n_z = -(-n_perm // PERM_CHUNK)
    ext_log = quotient_ext_log(n_lookup)
    return WrapperShape(n_advice=n_advice, n_lookup=n_lookup, n_z=n_z,
                        n_perm=n_perm, ext_log=ext_log)


def _self_commitment_names(shape: WrapperShape) -> list[str]:
    """Fixed-commitment names keygen produces, in its insertion order."""
    return ([f"q_{i}" for i in range(shape.n_advice)]
            + ["const", "table", "active"]
            + [f"sigma_{j}" for j in range(shape.n_perm)])


def make_self_vk(k: int, lookup_bits: int, num_instance: int,
                 shape: WrapperShape,
                 commitments: dict | None = None) -> VerifyingKey:
    """VerifyingKey of the wrapper itself, from its structural shape.

    `commitments=None` fills deterministic placeholder points -- shape
    solving / dummy-snark keygen only (values are witnessed, never
    baked into the circuit).
    """
    from ..poly.domain import domain

    if commitments is None:
        g = AffinePoint.generator(BN254_G1)
        commitments = {nm: (i + 2) * g
                       for i, nm in enumerate(_self_commitment_names(shape))}
    delta = pow(FR.generator, 1 << FR.two_adicity, FR.p)
    return VerifyingKey(
        k=k, ext_log=shape.ext_log, n_advice=shape.n_advice,
        n_lookup=shape.n_lookup, lookup_bits=lookup_bits,
        n_perm=shape.n_perm, n_z=shape.n_z,
        usable=(1 << k) - ZK_ROWS,
        deltas=[pow(delta, j, FR.p) for j in range(shape.n_perm)],
        num_instance=num_instance,
        commitments=commitments, omega=domain(k).omega,
    )


# ---------------------------------------------------------------------------
# Dummy snarks (gen_dummy_snark / CsProxy parity, wrapper.rs:179-276)
# ---------------------------------------------------------------------------

def proof_shape(vk: VerifyingKey) -> list[str]:
    """The exact read sequence of a proof stream for `vk` ("point" /
    "scalar" tags), shared by the dummy generator and sanity checks."""
    E = 1 << vk.ext_log
    seq = ["point"] * (vk.n_advice + vk.n_lookup + 1)      # advice, lookup, m
    seq += ["point"] * (1 + vk.n_z)                        # h, z_c
    seq += ["point"] * E                                   # t_i
    queries = _query_plan(vk, E)
    seq += ["scalar"] * sum(1 for nm, _ in sorted(queries)
                            if nm not in ("instance", "t"))
    by_point: dict[str, bool] = {}
    for _, pt in queries:
        by_point[pt] = True
    seq += ["point"] * sum(1 for ptn in POINT_NAMES if by_point.get(ptn))
    return seq


def gen_dummy_proof(vk: VerifyingKey, seed: int = 0) -> bytes:
    """Protocol-shaped random transcript (wrapper.rs:254-273): valid
    curve points and canonical scalars in the positions the verifier
    reads, so succinct verification RUNS (yielding a garbage
    accumulator the round-0 select discards) but never aborts."""
    rng = random.Random(0x5DAC ^ seed)
    g = AffinePoint.generator(BN254_G1)
    tr = Transcript()
    for kind in proof_shape(vk):
        if kind == "point":
            tr.write_point(rng.randrange(1, 1 << 128) * g)
        else:
            tr.write_scalar(rng.randrange(FR.p))
    return tr.proof()


# ---------------------------------------------------------------------------
# Configuration + linkage hooks
# ---------------------------------------------------------------------------

# linkage(ctx, voter_cells, state_cells, prev_payload, is_r0, not_r0, eq_if)
#   -> own payload rows (list[Cell])
Linkage = Callable


def zksnap_linkage(ctx: Context, vi: list[Cell], si: list[Cell],
                   pp: list[Cell], is_r0: Cell, not_r0: Cell,
                   eq_if) -> list[Cell]:
    """The reference's cross-proof equalities (wrapper.rs:617-711).

    DOCUMENTED DEVIATION from the reference instance layout: wrapper.rs
    exposes THIS round's old nullifier root at its old-root payload row
    and enforces the pk_enc/prev-vote/old-root chain equalities
    unconditionally (round 0 is pinned by initial_snark's instances,
    wrapper.rs:740-754).  Here the chain equalities are gated with
    `not_r0` and the old-root payload row carries the GENESIS root
    forward unchanged (selected once at round 0 below) -- so the final
    wrapper instance binds genesis-root -> final-root in one snark
    instead of requiring the verifier to walk the chain.  Payload row 24
    therefore means "genesis old root", not "this round's old root".

    Voter rows: [0:4] pk_enc, [4:24] vote_enc, [24:28] nullifier,
    [28] membership_root, [29] proposal_id (voter/src/lib.rs:237-292).
    State rows: [0:4] pk_enc, [4:24] prev_vote, [24:44] incoming_vote,
    [44:64] aggr_vote, [64:68] nullifier, [68] old_root, [69] new_root
    (state_transition.rs:219-247).
    Payload rows (28): pk_enc(4), aggr_vote(20), nullifier_old_root,
    nullifier_new_root, membership_root, proposal_id
    (wrapper.rs:423-431; prover/recursion.py row constants).
    """
    one = ctx.load_constant(1)
    for i in range(4):                      # voter and state share pk_enc
        eq_if(vi[i], si[i], one)
    for i in range(20):                     # voter's votes enter the state
        eq_if(vi[4 + i], si[24 + i], one)
    for i in range(4):                      # same nullifier
        eq_if(vi[24 + i], si[64 + i], one)
    # chain to the previous wrapper (vacuous at round 0)
    for i in range(4):
        eq_if(pp[i], si[i], not_r0)         # pk_enc constant over the chain
    for i in range(20):
        eq_if(pp[4 + i], si[4 + i], not_r0)  # prev aggr == state prev_vote
    eq_if(pp[25], si[68], not_r0)           # prev new root == our old root
    eq_if(pp[26], vi[28], not_r0)           # membership root constant
    eq_if(pp[27], vi[29], not_r0)           # proposal id constant
    # genesis old-root carries over; at round 0 it's this round's old root
    own_old = ctx.select(si[68], pp[24], is_r0)
    return (si[0:4] + si[44:64]
            + [own_old, si[69], vi[28], vi[29]])


def toy_linkage(ctx: Context, vi: list[Cell], si: list[Cell],
                pp: list[Cell], is_r0: Cell, not_r0: Cell,
                eq_if) -> list[Cell]:
    """Miniature wiring for tests: voter exposes [out], state exposes
    [in, out]; the chain carries state's output forward."""
    one = ctx.load_constant(1)
    eq_if(vi[0], si[0], one)                # voter's output enters the state
    eq_if(pp[0], si[0], not_r0)             # prev carried == our input
    return [si[1]]


@dataclass
class WrapperConfig:
    k: int
    lookup_bits: int
    voter_vk: VerifyingKey
    state_vk: VerifyingKey
    shape: WrapperShape
    default_acc: KzgAccumulator             # (G, [tau]G): a valid pair
    linkage: Linkage = zksnap_linkage
    n_payload: int = 28
    msm_window: int = 4
    # TEST-ONLY: unbound truncated MSM scalars (see MsmGadget); breaks
    # soundness AND native accumulator parity -- never set in production
    msm_unsound_truncate: int | None = None

    @property
    def num_instance(self) -> int:
        return ACC_ROWS + 1 + self.n_payload + 1

    def self_vk(self, commitments: dict | None = None) -> VerifyingKey:
        return make_self_vk(self.k, self.lookup_bits, self.num_instance,
                            self.shape, commitments)


@dataclass
class WrapperRoundInput:
    round: int
    voter: Snark
    state: Snark
    prev: Snark                              # previous wrapper snark
    self_commitments: dict                   # name -> AffinePoint (witnessed)


def default_accumulator(srs) -> KzgAccumulator:
    """(lhs, rhs) = (G, [tau]G): e(G,[tau]G2) == e([tau]G, G2) holds, so
    folding it in keeps the chain decidable (round-0 select target)."""
    from ..curves.jacobian import JacPoint, bn254_ops

    ops = bn254_ops()
    pts = ops.to_affine_host(
        JacPoint(srs.g1.x[:2], srs.g1.y[:2], srs.g1.z[:2]))
    return KzgAccumulator(lhs=pts[0], rhs=pts[1])


def protocol_digest(commitments: dict, k: int, num_instance: int) -> int:
    """Poseidon digest of the wrapper's own fixed protocol
    (preprocessed_digest, wrapper.rs:482-492): domain size k and the
    instance count absorbed first -- standing in for the vk binding the
    reference gets by absorbing transcript_initial_state alongside the
    preprocessed commitments -- then the limb encoding of every
    commitment in sorted-name order (the witness order of
    succinct_verify_gadget's protocol_witness mode).  Pinned by
    PROTOCOL.md section "vk digest"."""
    sponge = PoseidonNative()
    sponge.update([k, num_instance])
    for name in sorted(commitments.keys()):
        pt = commitments[name]
        x, y = (0, 0) if pt.is_identity() else (pt.x, pt.y)
        sponge.update(fe_to_limbs(x) + fe_to_limbs(y))
    return sponge.squeeze()


def initial_snark(cfg: WrapperConfig, self_commitments: dict,
                  seed: int = 7) -> Snark:
    """Round-0 previous snark (RecursionCircuit::initial_snark,
    wrapper.rs:740-754): default-accumulator instances + a dummy proof.
    Everything but the accumulator limbs is selected away at round 0."""
    from ..prover.recursion import accumulator_limbs

    vk = cfg.self_vk(self_commitments)
    inst = accumulator_limbs(cfg.default_acc)
    inst += [protocol_digest(self_commitments, cfg.k, cfg.num_instance)]
    inst += [0] * cfg.n_payload + [0]
    return Snark(vk=vk, instances=inst, proof=gen_dummy_proof(vk, seed))


# ---------------------------------------------------------------------------
# The circuit
# ---------------------------------------------------------------------------

def _decode_point(ctx: Context, chips: VerifierChips,
                  limbs: list[Cell]) -> NNPoint:
    """Recompose 6 instance cells (x limbs, y limbs; LimbsEncoding<3,88>)
    into an on-curve non-native point.  Soundness: limbs range-checked,
    coordinates proven canonical and on-curve."""
    fq = chips.fq
    coords = []
    for off in (0, 3):
        cells = limbs[off : off + 3]
        for c in cells:
            ctx.range_check(c, 88)
        big = AssignedBigUint(cells)
        fq._check_canonical(big)
        coords.append(NNElement(big))
    pt = NNPoint(coords[0], coords[1], ctx.load_constant(0))
    chips.ecc.assert_on_curve(pt)
    return pt


def _select_point(ctx: Context, chips: VerifierChips, a_const: AffinePoint,
                  b: NNPoint, cond: Cell) -> NNPoint:
    """cond ? a_const : b (a is a native constant point, never identity)."""
    fq = chips.fq
    ax = fq.assign_constant(a_const.x)
    ay = fq.assign_constant(a_const.y)
    return NNPoint(fq.select(ax, b.x, cond), fq.select(ay, b.y, cond),
                   ctx.load_constant(0))


def build_wrapper(ctx: Context, cfg: WrapperConfig,
                  win: WrapperRoundInput) -> list[Cell]:
    """Synthesize one wrapper round; returns the exposed instance cells.

    Mirrors RecursionCircuit::build (wrapper.rs:538-738): three in-
    circuit succinct verifications, digest pinning, round-0 selection,
    in-circuit fold, linkage equalities, instance exposure.
    """
    chips = VerifierChips.create(
        ctx, msm_window=cfg.msm_window,
        unsound_truncate_bits=cfg.msm_unsound_truncate)
    zero = ctx.load_constant(0)

    def eq_if(a: Cell, b: Cell, cond: Cell):
        ctx.constrain_equal(ctx.mul(ctx.sub(a, b), cond), zero)

    v_cells = [ctx.load_witness(v) for v in win.voter.instances]
    s_cells = [ctx.load_witness(v) for v in win.state.instances]
    p_cells = [ctx.load_witness(v) for v in win.prev.instances]

    res_v = succinct_verify_gadget(ctx, chips, cfg.voter_vk, v_cells,
                                   win.voter.proof)
    res_s = succinct_verify_gadget(ctx, chips, cfg.state_vk, s_cells,
                                   win.state.proof)
    self_vk = cfg.self_vk(win.self_commitments)
    res_p = succinct_verify_gadget(ctx, chips, self_vk, p_cells,
                                   win.prev.proof, protocol_witness=True)

    # preprocessed digest over the witnessed protocol (wrapper.rs:482-492):
    # k and num_instance enter as circuit CONSTANTS, so the digest pins
    # the domain size and instance shape, not just the commitments
    sponge = TranscriptGadget(ctx, chips.pg)
    sponge.update([ctx.load_constant(cfg.k),
                   ctx.load_constant(cfg.num_instance)])
    for pt in res_p.protocol_cells:
        sponge.update(list(pt.x.limbs) + list(pt.y.limbs))
    digest = sponge.squeeze()

    r_cell = ctx.load_witness(win.round % ctx.p)
    is_r0 = ctx.is_zero(r_cell)
    not_r0 = ctx.sub(ctx.load_constant(1), is_r0)

    # chain pins (vacuous at round 0): same circuit, consecutive rounds
    eq_if(p_cells[DIGEST_ROW], digest, not_r0)
    eq_if(p_cells[-1], ctx.add_const(r_cell, -1), not_r0)

    # previous carried accumulator, decoded from its instance rows
    prev_lhs = _decode_point(ctx, chips, p_cells[0:6])
    prev_rhs = _decode_point(ctx, chips, p_cells[6:12])

    d = cfg.default_acc
    sel = [
        (res_v.lhs, res_v.rhs),
        (res_s.lhs, res_s.rhs),
        (_select_point(ctx, chips, d.lhs, res_p.lhs, is_r0),
         _select_point(ctx, chips, d.rhs, res_p.rhs, is_r0)),
        (_select_point(ctx, chips, d.lhs, prev_lhs, is_r0),
         _select_point(ctx, chips, d.rhs, prev_rhs, is_r0)),
    ]

    # fold: absorb all four accumulators, squeeze r, RLC (KzgAs parity
    # with prover/accumulator.py fold_accumulators)
    fold_tr = TranscriptGadget(ctx, chips.pg)
    for lhs, rhs in sel:
        fold_tr.update(list(lhs.x.limbs) + list(lhs.y.limbs))
        fold_tr.update(list(rhs.x.limbs) + list(rhs.y.limbs))
    r_ch = fold_tr.squeeze()
    coefs = [ctx.load_constant(1), r_ch]
    coefs.append(ctx.mul(r_ch, r_ch))
    coefs.append(ctx.mul(coefs[2], r_ch))
    f_lhs = chips.msm.msm([(c, lr[0]) for c, lr in zip(coefs, sel)])
    f_rhs = chips.msm.msm([(c, lr[1]) for c, lr in zip(coefs, sel)])

    payload = cfg.linkage(ctx, v_cells, s_cells,
                          p_cells[ACC_ROWS + 1 : ACC_ROWS + 1 + cfg.n_payload],
                          is_r0, not_r0, eq_if)
    assert len(payload) == cfg.n_payload

    inst: list[Cell] = []
    for pt in (f_lhs, f_rhs):
        inst.extend(list(pt.x.limbs))
        inst.extend(list(pt.y.limbs))
    inst.append(digest)
    inst.extend(payload)
    inst.append(r_cell)
    assert len(inst) == cfg.num_instance
    for c in inst:
        ctx.expose_public(c)
    return inst


# ---------------------------------------------------------------------------
# Native mirror (the pre-pass of RecursionCircuit::new, wrapper.rs:433-536)
# ---------------------------------------------------------------------------

def wrapper_native(cfg: WrapperConfig, win: WrapperRoundInput):
    """Replay the wrapper round natively; returns (instances, folded_acc).

    Bit-parity with `build_wrapper` is asserted by tests: the native
    fold challenge, folded accumulator and every instance value must
    equal the cells the trace produces."""
    from ..prover.recursion import accumulator_limbs

    def acc_of(vk, snark):
        res = verify_succinct(vk, snark.instances, snark.proof)
        assert res is not None, "malformed child proof"
        g2_side, tau_side = res
        return KzgAccumulator(lhs=tau_side, rhs=g2_side)

    acc_v = acc_of(cfg.voter_vk, win.voter)
    acc_s = acc_of(cfg.state_vk, win.state)
    self_vk = cfg.self_vk(win.self_commitments)
    acc_p = acc_of(self_vk, win.prev)

    is_r0 = win.round == 0
    d = cfg.default_acc
    prev_carry = (d if is_r0 else KzgAccumulator(
        lhs=_limbs_to_point(win.prev.instances[0:6]),
        rhs=_limbs_to_point(win.prev.instances[6:12])))
    accs = [acc_v, acc_s, d if is_r0 else acc_p, prev_carry]

    tr = Transcript()
    for a in accs:
        tr.absorb_point(a.lhs)
        tr.absorb_point(a.rhs)
    r = tr.challenge()
    lhs = AffinePoint.identity(BN254_G1)
    rhs = AffinePoint.identity(BN254_G1)
    coef = 1
    for a in accs:
        lhs = lhs + coef * a.lhs
        rhs = rhs + coef * a.rhs
        coef = coef * r % FR.p
    folded = KzgAccumulator(lhs, rhs)

    digest = protocol_digest(win.self_commitments, cfg.k, cfg.num_instance)
    vi, si = win.voter.instances, win.state.instances
    pp = win.prev.instances[ACC_ROWS + 1 : ACC_ROWS + 1 + cfg.n_payload]
    if cfg.linkage is zksnap_linkage:
        own_old = si[68] if is_r0 else pp[24]
        payload = (si[0:4] + si[44:64]
                   + [own_old, si[69], vi[28], vi[29]])
    elif cfg.linkage is toy_linkage:
        payload = [si[1]]
    else:
        raise ValueError("unknown linkage; provide a native mirror")
    inst = accumulator_limbs(folded) + [digest] + payload + [win.round]
    return inst, folded


def _limbs_to_point(limbs: list[int]) -> AffinePoint:
    x = sum(v << (88 * i) for i, v in enumerate(limbs[0:3]))
    y = sum(v << (88 * i) for i, v in enumerate(limbs[3:6]))
    if x == 0 and y == 0:
        return AffinePoint.identity(BN254_G1)
    return AffinePoint(BN254_G1, x, y)


# ---------------------------------------------------------------------------
# Keygen fixed point (gen_recursion_pk parity, wrapper.rs:834-867)
# ---------------------------------------------------------------------------

def _dummy_round(cfg: WrapperConfig) -> WrapperRoundInput:
    """Keygen synthesis input: dummy child + prev snarks (CsProxy)."""
    g = AffinePoint.generator(BN254_G1)
    self_comms = {nm: (i + 2) * g
                  for i, nm in enumerate(_self_commitment_names(cfg.shape))}
    nv, ns = cfg.voter_vk.num_instance, cfg.state_vk.num_instance
    voter = Snark(vk=cfg.voter_vk, instances=[0] * nv,
                  proof=gen_dummy_proof(cfg.voter_vk, 1))
    state = Snark(vk=cfg.state_vk, instances=[0] * ns,
                  proof=gen_dummy_proof(cfg.state_vk, 2))
    return WrapperRoundInput(round=0, voter=voter, state=state,
                             prev=initial_snark(cfg, self_comms, seed=3),
                             self_commitments=self_comms)


def solve_wrapper_shape(cfg: WrapperConfig, max_iter: int = 6,
                        verbose: bool = False):
    """Iterate dummy synthesis until the induced layout matches the
    assumed self-shape.  Returns (resolved cfg, last dummy Context) --
    the Context is reusable for keygen (same shape as real rounds)."""
    shape = cfg.shape
    for it in range(max_iter):
        cfg = replace(cfg, shape=shape)
        ctx = Context(lookup_bits=cfg.lookup_bits, assert_witness=False)
        build_wrapper(ctx, cfg, _dummy_round(cfg))
        new = _shape_from_counts(cfg.k, len(ctx.advice), ctx.gate_offsets,
                                 len(ctx.lookups))
        if verbose:
            print(f"shape iter {it}: {shape} -> {new} "
                  f"({len(ctx.advice)} cells, {len(ctx.lookups)} lookups)",
                  flush=True)  # block-buffered logs hid these for hours (r4)
        if new == shape:
            return cfg, ctx
        shape = new
    raise RuntimeError("wrapper shape did not converge")


def _cfg_fingerprint(cfg: WrapperConfig) -> str:
    """Cache key over everything the wrapper pk depends on: domain size,
    child verifying keys (commitments included), linkage and MSM config."""
    import hashlib

    def vk_fp(vk: VerifyingKey) -> str:
        h = hashlib.sha256()
        h.update(f"{vk.k}:{vk.ext_log}:{vk.n_advice}:{vk.n_lookup}:"
                 f"{vk.lookup_bits}:{vk.n_perm}:{vk.n_z}:{vk.usable}:"
                 f"{vk.num_instance}".encode())
        for name in sorted(vk.commitments):
            pt = vk.commitments[name]
            x, y = (0, 0) if pt.is_identity() else (pt.x, pt.y)
            h.update(name.encode() + x.to_bytes(32, "little")
                     + y.to_bytes(32, "little"))
        return h.hexdigest()

    key = (f"v3|k={cfg.k}|lb={cfg.lookup_bits}|np={cfg.n_payload}"
           f"|w={cfg.msm_window}|tr={cfg.msm_unsound_truncate}"
           f"|lk={cfg.linkage.__name__}"
           f"|voter={vk_fp(cfg.voter_vk)}|state={vk_fp(cfg.state_vk)}")
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def gen_wrapper_pk(cfg: WrapperConfig, srs, allow_unsound: bool = False,
                   cache_dir: str | None = None):
    """Resolve the shape fixed point and run real keygen on the dummy
    synthesis (witness-independent, as halo2 keygen is).  Returns
    (cfg, ProvingKey); pk.vk.commitments are the circuit's REAL
    preprocessed commitments -- the values every round witnesses.

    cache_dir checkpoints the resolved shape + pk to disk keyed by a
    config fingerprint (the reference's build/recursion_pk.bin reuse,
    wrapper.rs:1073-1106): the first run pays the fixed-point solve +
    keygen; later runs load in seconds.
    """
    import json
    import os
    import time

    from ..prover.plonk import keygen
    from ..prover.serialize import load_pk, save_pk

    assert allow_unsound or cfg.msm_unsound_truncate is None, (
        "msm_unsound_truncate is test-only (soundness-breaking); "
        "production keygen refuses it unless allow_unsound=True")

    meta_p = pk_p = None
    if cache_dir is not None:
        fp = _cfg_fingerprint(cfg)
        meta_p = os.path.join(cache_dir, f"wrapper_{fp}.meta.json")
        pk_p = os.path.join(cache_dir, f"wrapper_{fp}.pk")
        if os.path.exists(meta_p) and os.path.exists(pk_p):
            t0 = time.time()
            with open(meta_p) as f:
                meta = json.load(f)
            cfg = replace(cfg, shape=WrapperShape(**meta["shape"]))
            pk = load_pk(pk_p)
            assert pk.vk.num_instance == cfg.num_instance
            print(f"wrapper pk cache hit ({pk_p}): {time.time()-t0:.1f}s",
                  flush=True)
            return cfg, pk

    # verbose: each fixed-point iteration at production width is ~10 min
    # of python synthesis -- progress must be observable
    cfg, ctx = solve_wrapper_shape(cfg, verbose=True)
    pk = keygen(ctx, cfg.k, srs)
    got = WrapperShape(n_advice=pk.vk.n_advice, n_lookup=pk.vk.n_lookup,
                       n_z=pk.vk.n_z, n_perm=pk.vk.n_perm,
                       ext_log=pk.vk.ext_log)
    assert got == cfg.shape, f"keygen shape drift: {got} != {cfg.shape}"
    assert pk.vk.num_instance == cfg.num_instance
    if pk_p is not None:
        from dataclasses import asdict

        save_pk(pk, pk_p, strip_witness=True)
        with open(meta_p, "w") as f:
            json.dump({"shape": asdict(cfg.shape)}, f)
        print(f"wrapper pk cached -> {pk_p}", flush=True)
    return cfg, pk


def verify_wrapper_snark(cfg: WrapperConfig, self_commitments: dict,
                         snark: Snark, srs) -> bool:
    """Final native decide (wrapper.rs:1140-1158): succinctly verify the
    last wrapper snark, pin its digest row, decode the chain accumulator
    from its instances, and pay the two pairings."""
    assert cfg.msm_unsound_truncate is None, (
        "msm_unsound_truncate is test-only; a verifier configured with it "
        "would accept unsound proofs")
    vk = cfg.self_vk(self_commitments)
    res = verify_succinct(vk, snark.instances, snark.proof)
    if res is None:
        return False
    g2_side, tau_side = res
    if snark.instances[DIGEST_ROW] != protocol_digest(
            self_commitments, cfg.k, cfg.num_instance):
        return False
    outer = KzgAccumulator(lhs=tau_side, rhs=g2_side)
    inner = KzgAccumulator(lhs=_limbs_to_point(snark.instances[0:6]),
                           rhs=_limbs_to_point(snark.instances[6:12]))
    return (decide(outer, srs.g2, srs.tau_g2)
            and decide(inner, srs.g2, srs.tau_g2))
