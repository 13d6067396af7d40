# Copy of zksnap_tpu/circuits/state_transition.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""State-transition circuit: per-round aggregator step.

Reference parity: aggregator/src/state_transition.rs:98-248
(`state_transition_circuit`, `StateTransitionCircuit`).  Constraints:
  * Poseidon-hash the compressed nullifier and pin it to the IMT new leaf
    value (:114-116, :168-169);
  * homomorphically add the 5 incoming ciphertexts to the previous tally
    (paillier mul mod n^2, :151-155);
  * insert the nullifier hash into the indexed Merkle tree (:203-217);
  * expose 70 public instances: n(2) g(2) prev(20) incoming(20) aggr(20)
    nullifier(4) old_root(1) new_root(1)  (:219-247, :298-300).
"""

from __future__ import annotations

from ..natives.inputs import ENC_BIT_LEN, StateTransitionInput
from ..trace.context import Cell, Context
from ..gadgets.bigint import BigUintChip
from ..gadgets.imt import AssignedIMTLeaf, insert_leaf
from ..gadgets.paillier_gadget import EncryptionPublicKeyAssigned, PaillierChip
from ..gadgets.poseidon_gadget import PoseidonGadget

LIMB_BIT_LEN = 88
NUM_INSTANCE = 70


def load_point_unchecked(ctx: Context, x: int, y: int) -> tuple[list[Cell], list[Cell]]:
    """halo2-ecc `load_private_unchecked` equivalent: 3x88-bit CRT limbs per
    coordinate, range-checked, no on-curve check."""
    def limbs_of(v):
        out = []
        for i in range(3):
            limb = (v >> (88 * i)) & ((1 << 88) - 1)
            c = ctx.load_witness(limb)
            ctx.range_check(c, 88 if i < 2 else 80)  # 256 = 88+88+80
            out.append(c)
        return out

    return limbs_of(x), limbs_of(y)


def compress_nullifier(ctx: Context, x_limbs: list[Cell],
                       y_limbs: list[Cell]) -> list[Cell]:
    """voter/src/lib.rs:122-149: [tag(2|3), x limb 0..2] with tag from y
    parity (big_is_even on the least-significant 88-bit limb)."""
    y0 = y_limbs[0]
    b_val = y0.value & 1
    h_val = y0.value >> 1
    b = ctx.load_witness(b_val)
    ctx.assert_bit(b)
    h = ctx.load_witness(h_val)
    ctx.range_check(h, 87)
    recomposed = ctx.mul_add(h, 2, b)
    ctx.constrain_equal(recomposed, y0)
    # tag = select(2, 3, is_even) ; is_even = 1 - b
    is_even = ctx.sub(ctx.load_constant(1), b)
    two, three = ctx.load_constant(2), ctx.load_constant(3)
    tag = ctx.select(two, three, is_even)
    return [tag] + list(x_limbs)


def state_transition_circuit(ctx: Context, inp: StateTransitionInput,
                             public_inputs: list[Cell]):
    hasher = PoseidonGadget(ctx)
    big = BigUintChip(ctx)
    paillier = PaillierChip(ctx, big, ENC_BIT_LEN)

    x_limbs, y_limbs = load_point_unchecked(ctx, inp.nullifier.x, inp.nullifier.y)
    compressed = compress_nullifier(ctx, x_limbs, y_limbs)
    nullifier_hash = hasher.hash_fix_len_array(compressed)

    n_a = big.assign(inp.pk_enc.n, ENC_BIT_LEN)
    g_a = big.assign(inp.pk_enc.g, ENC_BIT_LEN)
    pk = EncryptionPublicKeyAssigned(n_a, g_a)

    incoming = [big.assign(v, ENC_BIT_LEN * 2) for v in inp.incoming_vote]
    prev = [big.assign(v, ENC_BIT_LEN * 2) for v in inp.prev_vote]

    # Step 1: aggregate the votes
    aggr = [paillier.add(pk, x, y) for x, y in zip(incoming, prev)]

    # Step 2: update the nullifier tree
    t = inp.nullifier_tree
    low = AssignedIMTLeaf(
        ctx.load_witness(t.low_leaf.val),
        ctx.load_witness(t.low_leaf.next_val),
        ctx.load_witness(t.low_leaf.next_idx),
    )
    old_root = ctx.load_witness(t.old_root)
    new_root = ctx.load_witness(t.new_root)

    new_val = ctx.load_witness(t.new_leaf.val)
    ctx.constrain_equal(new_val, nullifier_hash)  # :168-169
    new = AssignedIMTLeaf(
        new_val,
        ctx.load_witness(t.new_leaf.next_val),
        ctx.load_witness(t.new_leaf.next_idx),
    )
    new_leaf_index = ctx.load_witness(t.new_leaf_index)
    is_largest = ctx.load_witness(t.is_new_leaf_largest)

    low_proof = [ctx.load_witness(v) for v in t.low_leaf_proof]
    low_helper = [ctx.load_witness(v) for v in t.low_leaf_proof_helper]
    new_proof = [ctx.load_witness(v) for v in t.new_leaf_proof]
    new_helper = [ctx.load_witness(v) for v in t.new_leaf_proof_helper]

    insert_leaf(
        ctx, hasher, old_root, low, low_proof, low_helper,
        new_root, new, new_leaf_index, new_proof, new_helper, is_largest,
    )

    # public instance layout (state_transition.rs:219-247)
    public_inputs.extend(pk.n.limbs)
    public_inputs.extend(pk.g.limbs)
    for enc in prev:
        public_inputs.extend(enc.limbs)
    for enc in incoming:
        public_inputs.extend(enc.limbs)
    for enc in aggr:
        public_inputs.extend(enc.limbs)
    public_inputs.extend(compressed)
    public_inputs.append(old_root)
    public_inputs.append(new_root)

    for c in public_inputs:
        ctx.expose_public(c)


def expected_instances(inp: StateTransitionInput) -> list[int]:
    """Host-side mirror of the 70-cell instance layout (for tests and the
    recursion layer)."""
    from ..natives.paillier import paillier_add

    def limbs(v, n):
        return [(v >> (88 * i)) & ((1 << 88) - 1) for i in range(n)]

    from ..natives.inputs import compress_native_nullifier

    out = []
    out += limbs(inp.pk_enc.n, 2)
    out += limbs(inp.pk_enc.g, 2)
    for v in inp.prev_vote:
        out += limbs(v, 4)
    for v in inp.incoming_vote:
        out += limbs(v, 4)
    for x, y in zip(inp.incoming_vote, inp.prev_vote):
        out += limbs(paillier_add(inp.pk_enc.n, x, y), 4)
    out += compress_native_nullifier(inp.nullifier)
    out += [inp.nullifier_tree.old_root, inp.nullifier_tree.new_root]
    return out
