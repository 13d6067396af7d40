# Copy of zksnap_tpu/gadgets/paillier_gadget.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""In-circuit Paillier operations.

Reference parity: paillier-chip (`PaillierChip::{construct, add, encrypt}`,
`EncryptionPublicKeyAssigned`) -- voter/src/lib.rs:32,162,213-216 and
state_transition.rs:109,151-155.

`add` (homomorphic tally update, live in the reference's state-transition
circuit) is ciphertext multiplication mod n^2.  `encrypt` (g^m * r^n mod
n^2) is provided for completeness; the reference keeps the voter-side
encryption check commented out (voter/src/lib.rs:244-248).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..trace.context import Context
from .bigint import AssignedBigUint, BigUintChip


@dataclass
class EncryptionPublicKeyAssigned:
    n: AssignedBigUint
    g: AssignedBigUint


class PaillierChip:
    def __init__(self, ctx: Context, big: BigUintChip, enc_bits: int = 176):
        self.ctx = ctx
        self.big = big
        self.enc_bits = enc_bits

    def _n_squared(self, pk: EncryptionPublicKeyAssigned) -> AssignedBigUint:
        """Normalized n^2 with an equality proof against the limb product."""
        n2_val = pk.n.value * pk.n.value
        n2 = self.big.assign(n2_val, 2 * self.enc_bits)
        self.big.assert_equal(self.big.mul(pk.n, pk.n), n2)
        return n2

    def add(self, pk: EncryptionPublicKeyAssigned, c1: AssignedBigUint,
            c2: AssignedBigUint) -> AssignedBigUint:
        """Homomorphic add: c1 * c2 mod n^2 (paillier-chip `add`)."""
        n2 = self._n_squared(pk)
        return self.big.mod_mul(c1, c2, n2, 2 * self.enc_bits)

    def encrypt(self, pk: EncryptionPublicKeyAssigned, m: AssignedBigUint,
                r: AssignedBigUint) -> AssignedBigUint:
        """g^m * r^n mod n^2 by square-and-multiply over witness exponent
        bits (costly: ~2*enc_bits mod_muls; the reference circuit keeps this
        check disabled, voter/src/lib.rs:244-248)."""
        ctx, big = self.ctx, self.big
        n2 = self._n_squared(pk)
        m_bits2 = 2 * self.enc_bits

        def pow_mod(base: AssignedBigUint, exp: AssignedBigUint,
                    exp_bits: int) -> AssignedBigUint:
            # decompose exponent limbs into bits
            bits = []
            for limb in exp.limbs:
                bits.extend(ctx.num_to_bits(limb, 88))
            bits = bits[:exp_bits]
            acc = big.assign(1, 1)
            for bit in reversed(bits):
                acc = big.mod_mul(acc, acc, n2, m_bits2)
                mult = big.mod_mul(acc, base, n2, m_bits2)
                # select limb-wise
                sel_limbs = []
                zero = ctx.load_constant(0)
                nl = max(len(acc.limbs), len(mult.limbs))
                al = acc.limbs + [zero] * (nl - len(acc.limbs))
                ml = mult.limbs + [zero] * (nl - len(mult.limbs))
                for a_c, m_c in zip(al, ml):
                    sel_limbs.append(ctx.select(m_c, a_c, bit))
                acc = AssignedBigUint(sel_limbs)
            return acc

        gm = pow_mod(pk.g, m, m_bits2)
        rn = pow_mod(r, pk.n, self.enc_bits)
        return big.mod_mul(gm, rn, n2, m_bits2)
