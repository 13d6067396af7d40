# Copy of zksnap_tpu/gadgets/imt.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""In-circuit indexed-Merkle-tree insertion.

Reference parity: indexed-merkle-tree-halo2 (`insert_leaf`,
`IndexedMerkleTreeLeaf`), used by the state-transition circuit at
state_transition.rs:203-217.  The IMT stores a sorted linked list in leaf
slots {val, next_val, next_idx}; leaf digest = Poseidon(val, next_val,
next_idx); empty slots hold Poseidon(0,0,0).

`insert_leaf` proves one insertion:
  1. low_leaf is a member of old_root (path given by low_leaf_proof);
  2. ordering: low_leaf.val < new_leaf.val, and either
     is_new_leaf_largest (then low_leaf.next_val == 0) or
     new_leaf.val < low_leaf.next_val;
  3. the new leaf inherits the low leaf's successor:
     new_leaf.next_val == low_leaf.next_val,
     new_leaf.next_idx == low_leaf.next_idx;
  4. interim root: low leaf replaced by {val, new_leaf.val, new_leaf_index};
  5. slot new_leaf_index held the empty digest in the interim tree
     (verified with new_leaf_proof), and inserting the new leaf's digest on
     the same path yields new_root;
  6. new_leaf_index is consistent with new_leaf_proof's helper bits.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..hash.poseidon import hash_fixed_native
from ..trace.context import Cell, Context
from .bigint import less_than_field
from .merkle import dual_mux
from .poseidon_gadget import PoseidonGadget


@dataclass
class AssignedIMTLeaf:
    val: Cell
    next_val: Cell
    next_idx: Cell


def _compute_root(ctx: Context, hasher: PoseidonGadget, leaf: Cell,
                  proof: list[Cell], helper: list[Cell]) -> Cell:
    computed = leaf
    for sibling, h in zip(proof, helper):
        left, right = dual_mux(ctx, computed, sibling, h)
        computed = hasher.hash_fix_len_array([left, right])
    return computed


def insert_leaf(
    ctx: Context,
    hasher: PoseidonGadget,
    old_root: Cell,
    low_leaf: AssignedIMTLeaf,
    low_leaf_proof: list[Cell],
    low_leaf_proof_helper: list[Cell],
    new_root: Cell,
    new_leaf: AssignedIMTLeaf,
    new_leaf_index: Cell,
    new_leaf_proof: list[Cell],
    new_leaf_proof_helper: list[Cell],
    is_new_leaf_largest: Cell,
):
    one = ctx.load_constant(1)
    zero = ctx.load_constant(0)

    # 1. low leaf in old tree
    low_hash = hasher.hash_fix_len_array(
        [low_leaf.val, low_leaf.next_val, low_leaf.next_idx])
    root0 = _compute_root(ctx, hasher, low_hash, low_leaf_proof,
                          low_leaf_proof_helper)
    ctx.constrain_equal(root0, old_root)

    # 2. ordering
    ctx.assert_bit(is_new_leaf_largest)
    lt_low = less_than_field(ctx, low_leaf.val, new_leaf.val)
    ctx.constrain_equal(lt_low, one)
    # if largest: low.next_val == 0 ; else new.val < low.next_val
    b = is_new_leaf_largest
    prod = ctx.mul(b, low_leaf.next_val)
    ctx.constrain_equal(prod, zero)
    lt_next = less_than_field(ctx, new_leaf.val, low_leaf.next_val)
    not_b = ctx.sub(one, b)
    cond = ctx.mul(not_b, ctx.sub(one, lt_next))
    ctx.constrain_equal(cond, zero)

    # 3. successor inheritance
    ctx.constrain_equal(new_leaf.next_val, low_leaf.next_val)
    ctx.constrain_equal(new_leaf.next_idx, low_leaf.next_idx)

    # 4. interim root with updated low leaf {val, new.val, new_leaf_index}
    new_low_hash = hasher.hash_fix_len_array(
        [low_leaf.val, new_leaf.val, new_leaf_index])
    interim_root = _compute_root(ctx, hasher, new_low_hash, low_leaf_proof,
                                 low_leaf_proof_helper)

    # 5. empty slot at new_leaf_index in the interim tree, then insert
    empty_digest = hash_fixed_native([0, 0, 0])
    empty = ctx.load_constant(empty_digest)
    root_empty = _compute_root(ctx, hasher, empty, new_leaf_proof,
                               new_leaf_proof_helper)
    ctx.constrain_equal(root_empty, interim_root)
    new_hash = hasher.hash_fix_len_array(
        [new_leaf.val, new_leaf.next_val, new_leaf.next_idx])
    root1 = _compute_root(ctx, hasher, new_hash, new_leaf_proof,
                          new_leaf_proof_helper)
    ctx.constrain_equal(root1, new_root)

    # 6. index consistency: helper bit = 1 when node is a LEFT child, i.e.
    # index bit is 0; so new_leaf_index == sum (1-helper_i) * 2^i
    acc = ctx.load_constant(0)
    for i, h in enumerate(new_leaf_proof_helper):
        bit = ctx.sub(one, h)
        acc = ctx.mul_add(bit, 1 << i, acc)
    ctx.constrain_equal(acc, new_leaf_index)
