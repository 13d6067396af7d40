# Copy of zksnap_tpu/gadgets/bigint.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""In-circuit big-unsigned-integer arithmetic (88-bit limbs) and sound
field-element comparisons.

Reference parity:
  * biguint-halo2 `BigUintChip` (`assign_integer`, `mul`, `add`,
    `assert_equal_fresh`) -- voter/src/lib.rs:31,161,185-211;
  * the carry-to-zero equality technique of halo2-ecc's CRT bigints;
  * halo2-base `check_less_than` / decomposition, used by the
    indexed-Merkle-tree gadget's value-ordering checks.

Limb width is 88 bits (LIMB_BIT_LEN, voter/src/lib.rs:37) so limb products
(< 2^176) and short convolution sums stay far below the BN254 Fr modulus
(~2^254) -- no overflow inside gate arithmetic as long as multiplications
take NORMALIZED inputs (every limb < 2^88, range-checked).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..trace.context import Cell, Context

LIMB_BITS = 88
LIMB_BASE = 1 << LIMB_BITS


@dataclass
class AssignedBigUint:
    """Normalized limb vector (each limb range-checked < 2^88)."""

    limbs: list[Cell]

    @property
    def value(self) -> int:
        return sum(c.value << (LIMB_BITS * i) for i, c in enumerate(self.limbs))

    def num_limbs(self) -> int:
        return len(self.limbs)


@dataclass
class UnnormBigUint:
    """Unnormalized limb vector (limbs bounded by `max_limb_bits`)."""

    limbs: list[Cell]
    max_limb_bits: int

    @property
    def value(self) -> int:
        return sum(c.value << (LIMB_BITS * i) for i, c in enumerate(self.limbs))


class BigUintChip:
    def __init__(self, ctx: Context):
        self.ctx = ctx

    # -- assignment ---------------------------------------------------------

    def assign(self, value: int, bit_len: int) -> AssignedBigUint:
        """Witness a nonnegative integer < 2^bit_len as 88-bit limbs."""
        assert 0 <= value < (1 << bit_len)
        n_limbs = -(-bit_len // LIMB_BITS)
        cells = []
        for i in range(n_limbs):
            limb = (value >> (LIMB_BITS * i)) & (LIMB_BASE - 1)
            c = self.ctx.load_witness(limb)
            top = bit_len - LIMB_BITS * i
            self.ctx.range_check(c, min(LIMB_BITS, max(top, 1)))
            cells.append(c)
        return AssignedBigUint(cells)

    def assign_constant(self, value: int, n_limbs: int) -> AssignedBigUint:
        cells = []
        for i in range(n_limbs):
            limb = (value >> (LIMB_BITS * i)) & (LIMB_BASE - 1)
            cells.append(self.ctx.load_constant(limb))
        return AssignedBigUint(cells)

    # -- arithmetic ----------------------------------------------------------

    def add(self, a, b) -> UnnormBigUint:
        ctx = self.ctx
        n = max(len(a.limbs), len(b.limbs))
        zero = ctx.load_constant(0)
        al = a.limbs + [zero] * (n - len(a.limbs))
        bl = b.limbs + [zero] * (n - len(b.limbs))
        out = [ctx.add(x, y) for x, y in zip(al, bl)]
        ma = getattr(a, "max_limb_bits", LIMB_BITS)
        mb = getattr(b, "max_limb_bits", LIMB_BITS)
        return UnnormBigUint(out, max(ma, mb) + 1)

    def mul(self, a: AssignedBigUint, b: AssignedBigUint) -> UnnormBigUint:
        """Schoolbook limb convolution; inputs must be normalized."""
        ctx = self.ctx
        na, nb = len(a.limbs), len(b.limbs)
        out = []
        for k in range(na + nb - 1):
            acc = ctx.load_constant(0)
            for i in range(max(0, k - nb + 1), min(na, k + 1)):
                acc = ctx.mul_add(a.limbs[i], b.limbs[k - i], acc)
            out.append(acc)
        n_terms = min(na, nb)
        return UnnormBigUint(out, 2 * LIMB_BITS + n_terms.bit_length())

    # -- equality via carry-to-zero ------------------------------------------

    def assert_equal(self, lhs, rhs):
        """Prove value(lhs) == value(rhs) as integers.

        Both operands may be unnormalized; limbs bounded by max_limb_bits
        (< 250 so carries stay small).  Technique: sequential borrow/carry
        witnesses c with (L_i - R_i + c_i) == B * c_{i+1}, range-checked,
        final carry 0 (halo2-ecc check_carry_to_zero).
        """
        ctx = self.ctx
        ml = getattr(lhs, "max_limb_bits", LIMB_BITS)
        mr = getattr(rhs, "max_limb_bits", LIMB_BITS)
        m = max(ml, mr)
        assert m + 2 < 250, "limb bound too large for carry check"
        n = max(len(lhs.limbs), len(rhs.limbs))
        zero = ctx.load_constant(0)
        ll = lhs.limbs + [zero] * (n - len(lhs.limbs))
        rl = rhs.limbs + [zero] * (n - len(rhs.limbs))

        # integer bookkeeping for witnesses (signed)
        lv = [c.value for c in ll]
        rv = [c.value for c in rl]

        carry_int = 0
        carry_cell = ctx.load_constant(0)
        # carry bound: |carry| <= 2^(m - 88 + 1); range-check shifted value
        cb = m - LIMB_BITS + 2
        for i in range(n):
            t_int = lv[i] - rv[i] + carry_int
            assert not ctx.assert_witness or t_int % LIMB_BASE == 0, \
                "assert_equal witness mismatch"
            new_carry_int = t_int // LIMB_BASE
            new_carry = ctx.load_witness(new_carry_int % ctx.p)
            # constraint: l - r + c == B * c'
            diff = ctx.sub(ll[i], rl[i])
            t = ctx.add(diff, carry_cell)
            rhs_c = ctx.scalar_mul(new_carry, LIMB_BASE)
            ctx.constrain_equal(t, rhs_c)
            # range check: c' + 2^cb in [0, 2^(cb+1))
            shifted = ctx.add_const(new_carry, 1 << cb)
            ctx.range_check(shifted, cb + 1)
            carry_int, carry_cell = new_carry_int, new_carry
        ctx.constrain_equal(carry_cell, zero)

    def mod_mul(self, a: AssignedBigUint, b: AssignedBigUint,
                m: AssignedBigUint, m_bits: int) -> AssignedBigUint:
        """(a * b) mod m with witnessed quotient/remainder.

        Proves a*b == q*m + r and 0 <= r < 2^m_bits (NOT r < m -- same
        contract as paillier-chip's mod arithmetic, which range-limits the
        remainder by bit width; canonicity of r is the caller's concern).
        """
        av, bv, mv = a.value, b.value, m.value
        q_int, r_int = divmod(av * bv, mv)
        q = self.assign(q_int, m_bits + 8)  # a*b < 2^(2*m_bits); q < 2^(m_bits+eps)
        r = self.assign(r_int, m_bits)
        lhs = self.mul(a, b)
        qm = self.mul(q, m)
        rhs = self.add(qm, r)
        self.assert_equal(lhs, rhs)
        return r


# ---------------------------------------------------------------------------
# Sound field-element comparison (full 254-bit range)
# ---------------------------------------------------------------------------

HALF_BITS = 128
HALF = 1 << HALF_BITS


def _lt_halves(ctx: Context, x: Cell, y: Cell) -> Cell:
    """x < y for x, y already range-checked < 2^128.  Returns a bit cell."""
    shifted_val = x.value + HALF - y.value  # in (0, 2^129)
    b_val = shifted_val >> HALF_BITS        # 1 iff x >= y
    rem_val = shifted_val & (HALF - 1)
    b = ctx.load_witness(b_val)
    ctx.assert_bit(b)
    rem = ctx.load_witness(rem_val)
    ctx.range_check(rem, HALF_BITS)
    # x + 2^128 - y == b*2^128 + rem
    lhs = ctx.add_const(ctx.sub(x, y), HALF)
    rhs = ctx.mul_add(b, HALF, rem)
    ctx.constrain_equal(lhs, rhs)
    # lt = 1 - b
    return ctx.sub(ctx.load_constant(1), b)


def decompose_canonical(ctx: Context, a: Cell) -> tuple[Cell, Cell]:
    """Split a field element into (hi, lo) with a == hi*2^128 + lo,
    lo < 2^128, hi < 2^126, and (hi, lo) canonical (< (p_hi, p_lo) lex).
    The canonicity check makes the decomposition unique, hence sound."""
    p = ctx.p
    lo_val = a.value & (HALF - 1)
    hi_val = a.value >> HALF_BITS
    lo = ctx.load_witness(lo_val)
    hi = ctx.load_witness(hi_val)
    ctx.range_check(lo, HALF_BITS)
    ctx.range_check(hi, p.bit_length() - HALF_BITS)
    recomposed = ctx.mul_add(hi, HALF, lo)
    ctx.constrain_equal(recomposed, a)
    # canonical: (hi, lo) < (p_hi, p_lo) lexicographically
    p_hi, p_lo = p >> HALF_BITS, p & (HALF - 1)
    p_hi_c = ctx.load_constant(p_hi)
    p_lo_c = ctx.load_constant(p_lo)
    lt_hi = _lt_halves(ctx, hi, p_hi_c)
    eq_hi = ctx.is_equal(hi, p_hi_c)
    lt_lo = _lt_halves(ctx, lo, p_lo_c)
    ok = ctx.add(lt_hi, ctx.mul(eq_hi, lt_lo))  # lt_hi + eq_hi*lt_lo
    one = ctx.load_constant(1)
    ctx.constrain_equal(ok, one)
    return hi, lo


def less_than_field(ctx: Context, a: Cell, b: Cell) -> Cell:
    """a < b as integers in [0, p), sound over the full field range."""
    a_hi, a_lo = decompose_canonical(ctx, a)
    b_hi, b_lo = decompose_canonical(ctx, b)
    lt_hi = _lt_halves(ctx, a_hi, b_hi)
    eq_hi = ctx.is_equal(a_hi, b_hi)
    lt_lo = _lt_halves(ctx, a_lo, b_lo)
    return ctx.add(lt_hi, ctx.mul(eq_hi, lt_lo))
