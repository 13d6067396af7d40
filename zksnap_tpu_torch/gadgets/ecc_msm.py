# Copy of zksnap_tpu/gadgets/ecc_msm.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""In-circuit variable/fixed-base MSM over BN254 G1 (non-native Fq).

The cost center of the recursion circuit: snark-verifier's `Halo2Loader`
EC arithmetic (wrapper.rs:291, bn254 `FpChip`; used by `succinct_verify`
:302-359 and `accumulate` :387-396).  halo2-ecc gets its in-circuit MSM
cheap with CRT bigints, incomplete addition formulas and windowed tables;
this module is the same idea rebuilt for this framework's trace runtime:

  * LAZY arithmetic: coordinates are 3x88-bit limb vectors range-checked
    < 2^254 but NOT reduced to canonical form between steps.  Every curve
    formula is enforced with `constrain_zero` -- one carry-to-zero check
    per algebraic identity (sum of +-a*b quadratic terms, +-c linear
    terms and an integer constant == 0 mod q) with a witnessed shifted
    quotient.  This replaces ~5 canonical NonNativeChip ops per EC add
    (each with its own quotient, remainder, canonicity and range plumbing)
    by 3-4 direct identities.
  * INCOMPLETE affine addition, made sound by an explicit x1 != x2 proof
    ((x2-x1) * witnessed-inverse == 1).  Doubling constrains the tangent
    equation directly (BN254 has no 2-torsion, so y != 0 on the curve).
  * WINDOWED shared-doubling accumulation (c = 4): per point a 16-entry
    table C_i + d*P_i (offset C_i keeps incomplete adds away from the
    identity), one doubling chain shared by all points, digit selection
    by binary select tree; the total offset sum_i k_off * C_i is a
    CONSTANT point subtracted at the end.
  * Fixed bases (vk commitments, the generator, instance Lagrange bases)
    get their tables computed natively and embedded as constants -- no
    table-build adds, no coordinate witnesses.

Completeness caveat (same as halo2-ecc): an honest prover fails iff two
intermediate points share an x-coordinate, probability ~#ops * 2^-254 --
negligible.  Soundness never depends on it.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.native import BN254_G1, AffinePoint
from ..trace.context import Cell, Context
from .bigint import LIMB_BITS, AssignedBigUint, BigUintChip
from .ecc import NNPoint
from .nonnative import NNElement, NonNativeChip

Q = BN254_G1.p  # the BN254 base field (Fq) modulus
WINDOW = 4
N_BITS = 254  # ceil(log2(Fr)); Fr-order decomposition is group-order safe
N_WINDOWS = -(-N_BITS // WINDOW)

import functools as _functools
import hashlib as _hashlib


@_functools.cache
def _offset_base() -> AffinePoint:
    """Nothing-up-my-sleeve point H with UNKNOWN discrete log wrt G
    (try-and-increment on sha256), used for the incomplete-add collision
    offsets.

    The offsets were (2i+3)*G; but MSM inputs are often G-multiples with
    SMALL known coefficients (the wrapper's round-0 fold carries the
    default accumulator (G, tau*G) twice, and the constant-1 fold scalar
    has digit 0 in every window but the first), so the accumulator could
    stay inside the small-multiples-of-G lattice and hit an exact
    x-collision with a table entry -- observed with ~few-% probability
    per proof at k=22 round 0 ("lazy identity violated").  With offsets
    on H, the running H-coefficient of the accumulator is deterministic
    and never matches a table entry's, so point equality would need the
    unknown dlog -- completeness holds except with negligible probability
    for ANY input points in the G-lattice."""
    ctr = 0
    while True:
        x = int.from_bytes(_hashlib.sha256(
            b"zksnap-tpu-msm-offset-h" + ctr.to_bytes(4, "little")).digest(),
            "big") % Q
        rhs = (x * x * x + BN254_G1.b) % Q
        y = pow(rhs, (Q + 1) // 4, Q)
        if y * y % Q == rhs:
            return AffinePoint(BN254_G1, x, min(y, Q - y))
        ctr += 1


@dataclass
class LazyPoint:
    """Affine point, never the identity; coords < 2^254, not nec. < q."""

    x: AssignedBigUint
    y: AssignedBigUint


class MsmGadget:
    def __init__(self, ctx: Context, fq: NonNativeChip, window: int = WINDOW,
                 unsound_truncate_bits: int | None = None):
        """`window` is the Pippenger digit width (shape knob).

        `unsound_truncate_bits` replaces every scalar with an UNBOUND
        fresh witness of its low bits -- it breaks the link between the
        scalar cell and the MSM result and exists ONLY so structural
        tests of the (huge) wrapper circuit fit in CI.  Production code
        paths must leave it None; `bits_sound` reports the mode.
        """
        assert fq.m == Q
        self.ctx = ctx
        self.fq = fq
        self.big = fq.big
        self.m_bits = Q.bit_length()
        self.n_limbs = 3
        self.window = window
        self.unsound_truncate_bits = unsound_truncate_bits

    @property
    def bits_sound(self) -> bool:
        return self.unsound_truncate_bits is None

    # -- lazy element plumbing ------------------------------------------------

    def _assign(self, value: int) -> AssignedBigUint:
        """Witness a reduced (< q) value as ranged 3x88 limbs."""
        return self.big.assign(value % Q, self.m_bits)

    def _const(self, value: int) -> AssignedBigUint:
        return self.big.assign_constant(value % Q, self.n_limbs)

    def constrain_zero(self, quads, lins, const_int: int = 0):
        """Prove sum s*a*b + sum s*c + const == 0 (mod q).

        quads: list of (sign, AssignedBigUint, AssignedBigUint);
        lins: list of (sign, AssignedBigUint); sign is +1/-1.
        One witnessed shifted quotient + one carry-to-zero equality.
        """
        big, ctx = self.big, self.ctx
        pos_terms, neg_terms = [], []
        v = const_int
        neg_bound = max(0, -const_int)
        for s, a, b in quads:
            t = big.mul(a, b)
            v += s * (a.value * b.value)
            (pos_terms if s > 0 else neg_terms).append(t)
            if s < 0:
                neg_bound += 1 << (2 * self.m_bits)
        for s, c in lins:
            v += s * c.value
            (pos_terms if s > 0 else neg_terms).append(c)
            if s < 0:
                neg_bound += 1 << self.m_bits
        assert not ctx.assert_witness or v % Q == 0, "lazy identity violated"
        off = neg_bound // Q + 1
        q_shift = (v + off * Q) // Q if v % Q == 0 else 0
        # bound the shifted quotient for the witness limb count
        pos_bound = (const_int if const_int > 0 else 0) + off * Q
        for s, a, b in quads:
            if s > 0:
                pos_bound += 1 << (2 * self.m_bits)
        for s, c in lins:
            if s > 0:
                pos_bound += 1 << self.m_bits
        q_bits = max((pos_bound // Q).bit_length(), 1)
        q_cell = self.big.assign(q_shift, q_bits)

        lhs = self._const_unnorm(off * Q + (const_int if const_int > 0 else 0))
        for t in pos_terms:
            lhs = big.add(lhs, t)
        rhs = big.mul(q_cell, self.fq.m_const)
        if const_int < 0:
            rhs = big.add(rhs, self._const_unnorm(-const_int))
        for t in neg_terms:
            rhs = big.add(rhs, t)
        big.assert_equal(lhs, rhs)

    def _const_unnorm(self, value: int) -> AssignedBigUint:
        n = max(1, -(-value.bit_length() // LIMB_BITS))
        return self.big.assign_constant(value, n)

    # -- incomplete affine group ops -------------------------------------------

    def add_incomplete(self, p: LazyPoint, q: LazyPoint) -> LazyPoint:
        """p + q assuming x_p != x_q (proven) and neither is the identity."""
        xp, yp, xq, yq = p.x.value, p.y.value, q.x.value, q.y.value
        dx = (xq - xp) % Q
        if dx != 0:
            dxi = pow(dx, -1, Q)
            lam = (yq - yp) * dxi % Q
        else:  # garbage witness (dummy-snark synthesis); constraints fail
            dxi, lam = 0, 0
        x3 = (lam * lam - xp - xq) % Q
        y3 = (lam * (xp - x3) - yp) % Q
        dxi_c = self._assign(dxi)
        lam_c = self._assign(lam)
        x3_c = self._assign(x3)
        y3_c = self._assign(y3)
        # (xq - xp) * dxi == 1
        self.constrain_zero([(1, q.x, dxi_c), (-1, p.x, dxi_c)], [], -1)
        # lam * (xq - xp) == yq - yp
        self.constrain_zero([(1, lam_c, q.x), (-1, lam_c, p.x)],
                            [(-1, q.y), (1, p.y)])
        # lam^2 == xp + xq + x3
        self.constrain_zero([(1, lam_c, lam_c)],
                            [(-1, p.x), (-1, q.x), (-1, x3_c)])
        # lam * (xp - x3) == yp + y3
        self.constrain_zero([(1, lam_c, p.x), (-1, lam_c, x3_c)],
                            [(-1, p.y), (-1, y3_c)])
        return LazyPoint(x3_c, y3_c)

    def dbl_incomplete(self, p: LazyPoint) -> LazyPoint:
        """2p for a finite curve point (y != 0 holds: no 2-torsion)."""
        xp, yp = p.x.value % Q, p.y.value % Q
        if yp != 0:
            lam = 3 * xp * xp * pow(2 * yp, -1, Q) % Q
        else:
            lam = 0
        x3 = (lam * lam - 2 * xp) % Q
        y3 = (lam * (xp - x3) - yp) % Q
        lam_c = self._assign(lam)
        x3_c = self._assign(x3)
        y3_c = self._assign(y3)
        # 2*yp*lam == 3*xp^2
        self.constrain_zero([(1, lam_c, p.y), (1, lam_c, p.y),
                             (-1, p.x, p.x), (-1, p.x, p.x), (-1, p.x, p.x)],
                            [])
        # lam^2 == 2*xp + x3
        self.constrain_zero([(1, lam_c, lam_c)],
                            [(-1, p.x), (-1, p.x), (-1, x3_c)])
        # lam*(xp - x3) == yp + y3
        self.constrain_zero([(1, lam_c, p.x), (-1, lam_c, x3_c)],
                            [(-1, p.y), (-1, y3_c)])
        return LazyPoint(x3_c, y3_c)

    # -- table selection --------------------------------------------------------

    def _select_limbs(self, table_limbs: list, bits: list[Cell]):
        """Binary select tree over 2^len(bits) rows of cells/constants."""
        ctx = self.ctx
        cur = table_limbs
        for b in bits:
            nxt = []
            for j in range(0, len(cur), 2):
                lo, hi = cur[j], cur[j + 1]
                if isinstance(lo, Cell) or isinstance(hi, Cell):
                    lo_c = lo if isinstance(lo, Cell) else ctx.load_constant(lo)
                    hi_c = hi if isinstance(hi, Cell) else ctx.load_constant(hi)
                    nxt.append(ctx.select(hi_c, lo_c, b))
                else:  # both ints: b*hi + (1-b)*lo = lo + b*(hi-lo)
                    diff = (hi - lo) % ctx.p
                    nxt.append(ctx.mul_add(b, diff, ctx.load_constant(lo))
                               if diff else ctx.load_constant(lo))
            cur = nxt
        return cur[0]

    def _select_point(self, table: list, bits: list[Cell]) -> LazyPoint:
        """table: 2^c LazyPoints (cells) OR AffinePoints (constants)."""
        limbs_x, limbs_y = [], []
        const = isinstance(table[0], AffinePoint)
        for i in range(self.n_limbs):
            if const:
                col_x = [(pt.x >> (LIMB_BITS * i)) & ((1 << LIMB_BITS) - 1)
                         for pt in table]
                col_y = [(pt.y >> (LIMB_BITS * i)) & ((1 << LIMB_BITS) - 1)
                         for pt in table]
            else:
                col_x = [pt.x.limbs[i] for pt in table]
                col_y = [pt.y.limbs[i] for pt in table]
            limbs_x.append(self._select_limbs(col_x, bits))
            limbs_y.append(self._select_limbs(col_y, bits))
        return LazyPoint(AssignedBigUint(limbs_x), AssignedBigUint(limbs_y))

    # -- the MSM -----------------------------------------------------------------

    def msm(self, pairs, n_bits: int = N_BITS) -> NNPoint:
        """sum_i scalar_i * P_i.

        pairs: list of (scalar Cell, point) where point is an NNPoint
        (witnessed, may be the identity -- guarded) or a native
        AffinePoint (fixed base, embedded as constants; identity bases
        must be filtered by the caller: they contribute nothing).
        Returns a canonical NNPoint (never the identity; a zero MSM value
        makes the final offset subtraction unprovable -- negligible for
        Fiat-Shamir-derived scalars).

        n_bits < 254 additionally constrains every scalar < 2^n_bits
        (tests only; production callers use the full width).
        """
        ctx = self.ctx
        gen = _offset_base()  # H: unknown dlog wrt G (see _offset_base)
        W = self.window
        if self.unsound_truncate_bits is not None:
            # TEST-ONLY: swap scalars for unbound truncated witnesses
            n_bits = self.unsound_truncate_bits
            pairs = [(ctx.load_witness(s.value % (1 << n_bits)), pt)
                     for s, pt in pairs]
        n_windows = -(-n_bits // W)
        assert pairs, "empty MSM"

        digit_bits: list[list[list[Cell]]] = []  # [pt][window] -> c bits
        tables = []
        offsets = []  # native offset point per pair
        for idx, (scalar, point) in enumerate(pairs):
            off_pt = (2 * idx + 3) * gen  # distinct per-point offsets
            offsets.append(off_pt)
            if isinstance(point, AffinePoint):
                assert not point.is_identity(), "identity fixed base"
                table = [off_pt + d * point for d in range(1 << W)]
                s_eff = scalar
            else:
                # identity guard: swap in a constant point, zero the scalar
                sub = (idx + 1000003) * gen
                fq = self.fq
                sub_x, sub_y = fq.assign_constant(sub.x), fq.assign_constant(sub.y)
                px = fq.select(sub_x, point.x, point.is_inf)
                py = fq.select(sub_y, point.y, point.is_inf)
                not_inf = ctx.sub(ctx.load_constant(1), point.is_inf)
                s_eff = ctx.mul(scalar, not_inf)
                base = LazyPoint(px.big, py.big)
                table = [LazyPoint(self._const(off_pt.x), self._const(off_pt.y))]
                for _ in range((1 << W) - 1):
                    table.append(self.add_incomplete(table[-1], base))
            tables.append(table)

            bits = ctx.num_to_bits(s_eff, n_bits)
            per_win = []
            for w in range(n_windows):
                per_win.append(bits[w * W : (w + 1) * W])
            digit_bits.append(per_win)

        acc: LazyPoint | None = None
        for w in range(n_windows - 1, -1, -1):
            if acc is not None:
                for _ in range(W):
                    acc = self.dbl_incomplete(acc)
            for i in range(len(pairs)):
                bits_w = digit_bits[i][w]
                # pad the (possibly short) top window with constant 0 bits
                while len(bits_w) < W:
                    bits_w = bits_w + [ctx.load_constant(0)]
                sel = self._select_point(tables[i], bits_w)
                acc = sel if acc is None else self.add_incomplete(acc, sel)

        # subtract the accumulated constant offsets:
        # every window adds sum_i C_i once; Horner doubles by 2^WINDOW.
        r = BN254_G1.n
        k_off = 0
        for w in range(n_windows):
            k_off = (k_off * (1 << W) + 1) % r
        total_off = AffinePoint.identity(BN254_G1)
        for off_pt in offsets:
            total_off = total_off + k_off * off_pt
        neg_off = -total_off
        acc = self.add_incomplete(
            acc, LazyPoint(self._const(neg_off.x), self._const(neg_off.y)))

        # canonicalize the result for absorption / instance exposure
        fq = self.fq
        x_out = self._canonicalize(acc.x)
        y_out = self._canonicalize(acc.y)
        return NNPoint(x_out, y_out, ctx.load_constant(0))

    def _canonicalize(self, a: AssignedBigUint) -> NNElement:
        """Reduce a lazy (< 2^254) value to a proven-canonical NNElement."""
        v = a.value % Q
        out = self.fq.assign(v)
        # a == out (mod q): a - out == s*q with s in {0,1} (a < 2^254 < 2q)
        s_val = (a.value - v) // Q
        s = self.ctx.load_witness(s_val)
        self.ctx.assert_bit(s)
        sm = AssignedBigUint(
            [self.ctx.mul(s, c) for c in self.fq.m_const.limbs])
        self.big.assert_equal(a, self.big.add(out.big, sm))
        return out
