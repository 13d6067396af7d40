# Copy of zksnap_tpu/gadgets/nonnative.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""Non-native field arithmetic gadget (halo2-ecc FpChip/FqChip equivalent).

Reference parity: halo2-ecc's CRT bigint chips (`FpChip`, `FqChip`,
`ProperCrtUint`) used for secp256k1 arithmetic inside the BN254 circuit
(voter/src/lib.rs:163-165).  Values are 3x88-bit limb vectors kept
CANONICAL (< modulus) at every step: each operation witnesses its result
(and quotient/borrow helpers), proves the integer relation with the
carry-to-zero technique from gadgets/bigint.py, and range-proves the
result below the modulus.  Canonical-everywhere costs a small constant
factor but makes equality checks plain limb equality and keeps soundness
reasoning local.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..trace.context import Cell, Context
from .bigint import LIMB_BITS, AssignedBigUint, BigUintChip, UnnormBigUint


@dataclass
class NNElement:
    """Canonical non-native field element: AssignedBigUint < modulus."""

    big: AssignedBigUint

    @property
    def value(self) -> int:
        return self.big.value

    @property
    def limbs(self):
        return self.big.limbs


class NonNativeChip:
    def __init__(self, ctx: Context, big: BigUintChip, modulus: int):
        self.ctx = ctx
        self.big = big
        self.m = modulus
        self.m_bits = modulus.bit_length()
        self.n_limbs = -(-self.m_bits // LIMB_BITS)
        self.m_const = big.assign_constant(modulus, self.n_limbs)
        self.m_minus_1 = big.assign_constant(modulus - 1, self.n_limbs)

    # -- assignment ----------------------------------------------------------

    def _check_canonical(self, a: AssignedBigUint):
        """Prove a <= m-1 by witnessing diff = m-1-a and proving
        a + diff == m-1."""
        diff_val = self.m - 1 - a.value
        assert diff_val >= 0, "non-canonical witness"
        diff = self.big.assign(diff_val, self.m_bits)
        self.big.assert_equal(self.big.add(a, diff), self.m_minus_1)

    def assign(self, value: int) -> NNElement:
        value %= self.m
        a = self.big.assign(value, self.m_bits)
        self._check_canonical(a)
        return NNElement(a)

    def assign_constant(self, value: int) -> NNElement:
        return NNElement(self.big.assign_constant(value % self.m, self.n_limbs))

    def _result(self, value: int) -> NNElement:
        a = self.big.assign(value, self.m_bits)
        self._check_canonical(a)
        return NNElement(a)

    # -- arithmetic ----------------------------------------------------------

    def add(self, a: NNElement, b: NNElement) -> NNElement:
        tot = a.value + b.value
        s_val, r_val = divmod(tot, self.m)
        r = self._result(r_val)
        s = self.ctx.load_witness(s_val)
        self.ctx.assert_bit(s)
        # a + b == s*m + r  (s*m via bit-select of the constant)
        sm = [self.ctx.mul(s, c) for c in self.m_const.limbs]
        rhs = self.big.add(AssignedBigUint(sm), r.big)
        self.big.assert_equal(self.big.add(a.big, b.big), rhs)
        return r

    def sub(self, a: NNElement, b: NNElement) -> NNElement:
        r_val = (a.value - b.value) % self.m
        s_val = (b.value + r_val - a.value) // self.m
        r = self._result(r_val)
        s = self.ctx.load_witness(s_val)
        self.ctx.assert_bit(s)
        # a + s*m == b + r
        sm = [self.ctx.mul(s, c) for c in self.m_const.limbs]
        lhs = self.big.add(a.big, AssignedBigUint(sm))
        rhs = self.big.add(b.big, r.big)
        self.big.assert_equal(lhs, rhs)
        return r

    def neg(self, a: NNElement) -> NNElement:
        return self.sub(self.assign_constant(0), a)

    def mul(self, a: NNElement, b: NNElement) -> NNElement:
        q_val, r_val = divmod(a.value * b.value, self.m)
        q = self.big.assign(q_val, self.m_bits)
        r = self._result(r_val)
        lhs = self.big.mul(a.big, b.big)
        rhs = self.big.add(self.big.mul(q, self.m_const), r.big)
        self.big.assert_equal(lhs, rhs)
        return r

    def square(self, a: NNElement) -> NNElement:
        return self.mul(a, a)

    def div(self, y: NNElement, x: NNElement) -> NNElement:
        """y / x with witnessed result; REQUIRES x != 0 (callers guard)."""
        x_inv = pow(x.value, -1, self.m)
        t_val = y.value * x_inv % self.m
        t = self._result(t_val)
        # t * x == q*m + y
        q_val = (t_val * x.value - y.value) // self.m
        q = self.big.assign(q_val, self.m_bits)
        lhs = self.big.mul(t.big, x.big)
        rhs = self.big.add(self.big.mul(q, self.m_const), y.big)
        self.big.assert_equal(lhs, rhs)
        return t

    def mul_const(self, a: NNElement, k: int) -> NNElement:
        return self.mul(a, self.assign_constant(k))

    # -- predicates / selection ----------------------------------------------

    def assert_equal(self, a: NNElement, b: NNElement):
        for x, y in zip(a.limbs, b.limbs):
            self.ctx.constrain_equal(x, y)

    def is_equal(self, a: NNElement, b: NNElement) -> Cell:
        """1 if equal (canonical reps -> limb equality), else 0."""
        acc = self.ctx.load_constant(1)
        for x, y in zip(a.limbs, b.limbs):
            acc = self.ctx.mul(acc, self.ctx.is_equal(x, y))
        return acc

    def is_zero(self, a: NNElement) -> Cell:
        acc = self.ctx.load_constant(1)
        for x in a.limbs:
            acc = self.ctx.mul(acc, self.ctx.is_zero(x))
        return acc

    def select(self, a: NNElement, b: NNElement, cond: Cell) -> NNElement:
        """cond ? a : b (limb-wise)."""
        return NNElement(AssignedBigUint(
            [self.ctx.select(x, y, cond) for x, y in zip(a.limbs, b.limbs)]
        ))
