# Copy of zksnap_tpu/gadgets/ecc.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""In-circuit elliptic-curve gadget over a non-native base field.

Reference parity: halo2-ecc `EccChip` (`load_private_unchecked`,
add/double/scalar-mul) as used for secp256k1 inside the voter circuit
(voter/src/lib.rs:165-170) and by plume-halo2's `verify_plume`.

Points carry an explicit infinity flag so the group law is COMPLETE:
division-by-zero in the slope is patched with a guarded denominator and
the bogus branch is discarded by selects.  Costlier than halo2-ecc's
incomplete formulas + randomization, but sound unconditionally and easy
to reason about; windowed/incomplete fast paths can come later.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..trace.context import Cell, Context
from .nonnative import NNElement, NonNativeChip


@dataclass
class NNPoint:
    x: NNElement
    y: NNElement
    is_inf: Cell  # bit: 1 = identity


class EccGadget:
    def __init__(self, ctx: Context, fp: NonNativeChip, curve_a: int, curve_b: int):
        assert curve_a == 0
        self.ctx = ctx
        self.fp = fp
        self.b = curve_b

    # -- loading -------------------------------------------------------------

    def load_point_unchecked(self, x: int, y: int) -> NNPoint:
        """Witness a finite point without an on-curve check
        (halo2-ecc `load_private_unchecked` semantics)."""
        return NNPoint(self.fp.assign(x), self.fp.assign(y),
                       self.ctx.load_constant(0))

    def load_point_checked(self, x: int, y: int) -> NNPoint:
        p = self.load_point_unchecked(x, y)
        self.assert_on_curve(p)
        return p

    def constant_point(self, x: int, y: int) -> NNPoint:
        return NNPoint(self.fp.assign_constant(x), self.fp.assign_constant(y),
                       self.ctx.load_constant(0))

    def identity(self) -> NNPoint:
        return NNPoint(self.fp.assign_constant(0), self.fp.assign_constant(1),
                       self.ctx.load_constant(1))

    def assert_on_curve(self, p: NNPoint):
        """y^2 == x^3 + b (finite points; identity passes vacuously via
        select against an always-true equation)."""
        fp = self.fp
        lhs = fp.square(p.y)
        rhs = fp.add(fp.mul(fp.square(p.x), p.x), fp.assign_constant(self.b))
        eq = fp.is_equal(lhs, rhs)
        ok = self.ctx.add(eq, p.is_inf)  # >= 1 when on curve or identity
        nonzero = self.ctx.is_zero(ok)
        self.ctx.constrain_equal(nonzero, self.ctx.load_constant(0))

    def neg(self, p: NNPoint) -> NNPoint:
        return NNPoint(p.x, self.fp.neg(p.y), p.is_inf)

    def select(self, a: NNPoint, b: NNPoint, cond: Cell) -> NNPoint:
        fp = self.fp
        return NNPoint(fp.select(a.x, b.x, cond), fp.select(a.y, b.y, cond),
                       self.ctx.select(a.is_inf, b.is_inf, cond))

    # -- complete group law --------------------------------------------------

    def _guarded_div(self, num: NNElement, den: NNElement, bad: Cell) -> NNElement:
        """num/den, with den patched to 1 when `bad` (result discarded)."""
        fp = self.fp
        one = fp.assign_constant(1)
        den_safe = fp.select(one, den, bad)
        return fp.div(num, den_safe)

    def add(self, p: NNPoint, q: NNPoint) -> NNPoint:
        """Complete addition (identities, doubling, inverse pairs)."""
        ctx, fp = self.ctx, self.fp
        x_eq = fp.is_equal(p.x, q.x)
        y_eq = fp.is_equal(p.y, q.y)
        either_inf = ctx.add(p.is_inf, q.is_inf)  # 0, 1 or 2
        any_inf = ctx.is_zero(ctx.is_zero(either_inf))

        # generic chord slope (patched when x1 == x2 or infinities)
        bad_chord = ctx.add(x_eq, any_inf)
        bad_chord = ctx.is_zero(ctx.is_zero(bad_chord))
        lam_add = self._guarded_div(fp.sub(q.y, p.y), fp.sub(q.x, p.x),
                                    bad_chord)

        # tangent slope (patched when y1 == 0 or infinities)
        y_zero = fp.is_zero(p.y)
        bad_tan = ctx.is_zero(ctx.is_zero(ctx.add(y_zero, any_inf)))
        three_x2 = fp.mul_const(fp.square(p.x), 3)
        lam_dbl = self._guarded_div(three_x2, fp.mul_const(p.y, 2), bad_tan)

        use_dbl = ctx.mul(x_eq, y_eq)  # same point
        lam = fp.select(lam_dbl, lam_add, use_dbl)

        x3 = fp.sub(fp.sub(fp.square(lam), p.x), q.x)
        y3 = fp.sub(fp.mul(lam, fp.sub(p.x, x3)), p.y)
        res = NNPoint(x3, y3, ctx.load_constant(0))

        # P + (-P) = identity: x_eq and not y_eq (finite, y1 = -y2)
        # (y1 == y2 == 0 with x_eq means tangent vertical -> also identity
        #  unless doubling a 2-torsion point; secp/bn254 have no 2-torsion)
        opp = ctx.mul(x_eq, ctx.sub(ctx.load_constant(1), y_eq))
        res = self.select(self.identity(), res, opp)
        # identity absorption
        res = self.select(q, res, p.is_inf)
        res = self.select(p, res, q.is_inf)
        return res

    def double(self, p: NNPoint) -> NNPoint:
        return self.add(p, p)

    # -- scalar multiplication ----------------------------------------------

    def scalar_mul_bits(self, p: NNPoint, bits: list[Cell]) -> NNPoint:
        """MSB-first double-and-add with complete adds."""
        acc = self.identity()
        for b in bits:
            acc = self.add(acc, acc)
            added = self.add(acc, p)
            acc = self.select(added, acc, b)
        return acc

    def shamir_mul(self, p: NNPoint, p_bits: list[Cell],
                   q: NNPoint, q_bits: list[Cell]) -> NNPoint:
        """a*P + b*Q simultaneously (Shamir's trick): one shared doubling
        chain, per-step add of {O, P, Q, P+Q} selected by the bit pair."""
        ctx = self.ctx
        assert len(p_bits) == len(q_bits)
        pq = self.add(p, q)
        acc = self.identity()
        for bp, bq in zip(p_bits, q_bits):
            acc = self.add(acc, acc)
            both = ctx.mul(bp, bq)
            only_p = ctx.mul(bp, ctx.sub(ctx.load_constant(1), bq))
            only_q = ctx.mul(bq, ctx.sub(ctx.load_constant(1), bp))
            addend = self.select(pq, p, both)
            addend = self.select(addend, q,
                                 ctx.add(both, only_p))
            none = ctx.mul(ctx.sub(ctx.load_constant(1), bp),
                           ctx.sub(ctx.load_constant(1), bq))
            # is_inf OR none  (boolean or: a + b - a*b)
            inf_or = ctx.sub(ctx.add(addend.is_inf, none),
                             ctx.mul(addend.is_inf, none))
            addend = NNPoint(addend.x, addend.y, inf_or)
            acc = self.add(acc, addend)
        return acc
