# Copy of zksnap_tpu/circuits/voter.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""Voter circuit: the client-side proof.

Reference parity: voter/src/lib.rs:151-293 (`voter_circuit`,
`VoterCircuit`).  The reference's LIVE constraints are:
  * proposal-id 2-byte decomposition (:255-272);
  * nullifier compression (:274 -> 122-149);
  * PLUME verification (:276-283);
  * 30 public instances: n(2) g(2) vote_enc(20) nullifier(4)
    membership_root(1) proposal_id(1)  (:237-292, :344-346).
The membership check, vote-wellformedness check and Paillier re-encryption
check exist in the reference but are commented out (:218-234, :243-248).
Here they are implemented and gated by flags (default True -- they are
clearly intended; parity tests against the reference-as-is can disable
them, SURVEY.md "hard parts").

PLUME verification runs on the in-circuit secp256k1 + SHA-256 gadget
stack (gadgets/plume_gadget.py) and is ON by default (proven at k=21 on
TPU, runs/voter_plume_k21_r3b.log); `check_plume=False` opts out for
small-k shapes (tests, wrapper children).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..natives.inputs import ENC_BIT_LEN, VoterCircuitInput, bytes_le_chunks_to_fr
from ..trace.context import Cell, Context
from ..gadgets.bigint import BigUintChip
from ..gadgets.merkle import verify_membership_proof
from ..gadgets.paillier_gadget import EncryptionPublicKeyAssigned, PaillierChip
from ..gadgets.poseidon_gadget import PoseidonGadget
from .state_transition import compress_nullifier, load_point_unchecked

NUM_INSTANCE = 30


@dataclass
class VoterFlags:
    check_membership: bool = True
    check_vote_wellformed: bool = True
    check_encryption: bool = False  # heavy (pow_mod); reference keeps it off
    # PLUME is the reference's only heavyweight LIVE constraint
    # (voter/src/lib.rs:276-283) and is proven here end-to-end at k=21
    # (runs/voter_plume_k21_r3b.log) -- ON by default; tests and the
    # small-k wrapper children opt out explicitly (the PLUME gadget needs
    # ~15.5M advice cells, far beyond k<=15 shapes).
    check_plume: bool = True


def voter_circuit(ctx: Context, inp: VoterCircuitInput,
                  public_inputs: list[Cell],
                  flags: VoterFlags | None = None):
    flags = flags or VoterFlags()
    hasher = PoseidonGadget(ctx)
    big = BigUintChip(ctx)
    paillier = PaillierChip(ctx, big, ENC_BIT_LEN)

    # assign inputs
    if flags.check_plume:
        from ..gadgets.plume_gadget import make_plume_chips

        chips = make_plume_chips(ctx)
        pk_pt = chips.ecc.load_point_unchecked(inp.pk_voter.x, inp.pk_voter.y)
        null_pt = chips.ecc.load_point_unchecked(inp.nullifier.x, inp.nullifier.y)
        pk_x, pk_y = pk_pt.x.limbs, pk_pt.y.limbs
        null_x, null_y = null_pt.x.limbs, null_pt.y.limbs
    else:
        pk_x, pk_y = load_point_unchecked(ctx, inp.pk_voter.x, inp.pk_voter.y)
        null_x, null_y = load_point_unchecked(ctx, inp.nullifier.x, inp.nullifier.y)
    membership_root = ctx.load_witness(inp.membership_root)
    leaf = hasher.hash_fix_len_array(pk_x + pk_y)
    membership_proof = [ctx.load_witness(v) for v in inp.membership_proof]
    membership_helper = [ctx.load_witness(v) for v in inp.membership_proof_helper]
    proposal_id = ctx.load_witness(inp.proposal_id)
    n_a = big.assign(inp.pk_enc.n, ENC_BIT_LEN)
    g_a = big.assign(inp.pk_enc.g, ENC_BIT_LEN)
    pk_enc = EncryptionPublicKeyAssigned(n_a, g_a)
    vote_fe = [ctx.load_witness(v) for v in inp.vote]
    vote_big = [big.assign(v, ENC_BIT_LEN * 2) for v in inp.vote]
    vote_enc_big = [big.assign(v, ENC_BIT_LEN * 2) for v in inp.vote_enc]
    r_big = [big.assign(v, ENC_BIT_LEN) for v in inp.r_enc]

    # 1. membership (reference :219-227, commented out there)
    if flags.check_membership:
        verify_membership_proof(ctx, hasher, membership_root, leaf,
                                membership_proof, membership_helper)

    # vote wellformedness (reference :230-234, commented out there)
    if flags.check_vote_wellformed:
        for v in vote_fe:
            ctx.assert_bit(v)
        total = ctx.sum(vote_fe)
        one = ctx.load_constant(1)
        ctx.constrain_equal(total, one)

    # PK_ENC n, g
    public_inputs.extend(pk_enc.n.limbs)
    public_inputs.extend(pk_enc.g.limbs)

    # 2. encryption correctness (reference :244-248, commented out there)
    for i in range(len(inp.vote)):
        if flags.check_encryption:
            enc = paillier.encrypt(pk_enc, vote_big[i], r_big[i])
            big.assert_equal(vote_enc_big[i], enc)
        public_inputs.extend(vote_enc_big[i].limbs)

    # 3. nullifier: proposal-id byte decomposition (reference :255-272)
    message = [
        ctx.load_witness((inp.proposal_id >> (8 * i)) & 0xFF) for i in range(2)
    ]
    acc = ctx.load_zero()
    for i in range(2):
        acc = ctx.mul_add(message[i], 1 << (8 * i), acc)
    ctx.constrain_equal(acc, proposal_id)

    compressed = compress_nullifier(ctx, null_x, null_y)

    if flags.check_plume:
        from ..gadgets.plume_gadget import PlumeInput, verify_plume

        plume_inp = PlumeInput(
            nullifier=null_pt,
            s=chips.fq.assign(inp.s_nullifier),
            c=chips.fq.assign(inp.c_nullifier),
            pk=pk_pt,
            message=message,
        )
        verify_plume(chips, plume_inp)

    # NULLIFIER, MERKLE_ROOT, PROPOSAL_ID
    public_inputs.extend(compressed)
    public_inputs.append(membership_root)
    public_inputs.append(proposal_id)

    for c in public_inputs:
        ctx.expose_public(c)


def expected_instances(inp: VoterCircuitInput) -> list[int]:
    """Host mirror of the 30-cell instance layout."""
    from ..natives.inputs import compress_native_nullifier

    def limbs(v, n):
        return [(v >> (88 * i)) & ((1 << 88) - 1) for i in range(n)]

    out = []
    out += limbs(inp.pk_enc.n, 2)
    out += limbs(inp.pk_enc.g, 2)
    for v in inp.vote_enc:
        out += limbs(v, 4)
    out += compress_native_nullifier(inp.nullifier)
    out += [inp.membership_root, inp.proposal_id]
    return out
