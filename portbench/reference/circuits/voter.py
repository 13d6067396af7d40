"""The voter's 30 public instances from its inputs (frozen copy of
zksnap_tpu_torch/circuits/voter.py `expected_instances`): the Paillier
key's n and g in two 88-bit limbs each, the five encrypted votes in four
limbs each, the compressed nullifier (tag, three 11-byte chunks of x),
the membership root and the proposal id."""

from __future__ import annotations

from ...natives.inputs import compress_native_nullifier


def _limbs(v: int, count: int) -> list[int]:
    return [(v >> (88 * i)) & ((1 << 88) - 1) for i in range(count)]


def expected_instances(config: dict, inp) -> list[int]:
    out = _limbs(inp.pk_enc.n, 2) + _limbs(inp.pk_enc.g, 2)
    for v in inp.vote_enc:
        out += _limbs(v, 4)
    out += compress_native_nullifier(inp.nullifier)
    out += [inp.membership_root, inp.proposal_id]
    return out
