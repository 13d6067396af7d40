# Copy of zksnap_tpu/gadgets/merkle.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""In-circuit Merkle membership verification.

Reference parity: voter/src/merkletree/mod.rs (`dual_mux` :10-26,
`verify_membership_proof` :28-44): conditional-swap via two mul_adds per
level + Poseidon root recomputation, final copy-constraint against the root.
"""

from __future__ import annotations

from ..trace.context import Cell, Context
from .poseidon_gadget import PoseidonGadget


def dual_mux(ctx: Context, a: Cell, b: Cell, switch: Cell) -> tuple[Cell, Cell]:
    """switch == 1 -> (a, b); switch == 0 -> (b, a)."""
    ctx.assert_bit(switch)
    a_sub_b = ctx.sub(a, b)
    b_sub_a = ctx.sub(b, a)
    left = ctx.mul_add(a_sub_b, switch, b)    # (a-b)*s + b
    right = ctx.mul_add(b_sub_a, switch, a)   # (b-a)*s + a
    return left, right


def verify_membership_proof(
    ctx: Context,
    hasher: PoseidonGadget,
    root: Cell,
    leaf: Cell,
    proof: list[Cell],
    helper: list[Cell],
):
    computed = ctx.load_witness(leaf.value)
    ctx.constrain_equal(leaf, computed)
    for sibling, h in zip(proof, helper):
        left, right = dual_mux(ctx, computed, sibling, h)
        computed = hasher.hash_fix_len_array([left, right])
    ctx.constrain_equal(computed, root)
