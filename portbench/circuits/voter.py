"""The voter circuit of zksnap_tpu_torch.circuits.voter, with the
configuration's `flags` (VoterFlags) and `lookup_bits`; its inputs from
the benchmark's frozen copy of the input generator."""

from __future__ import annotations

import random

from ..natives.inputs import generate_random_voter_circuit_inputs


def make_inputs(config: dict, seed: int):
    return generate_random_voter_circuit_inputs(random.Random(seed))


def synthesize(config: dict, inputs):
    from zksnap_tpu_torch.circuits.voter import VoterFlags, voter_circuit
    from zksnap_tpu_torch.trace import Context

    ctx = Context(lookup_bits=config["lookup_bits"])
    pub = []
    voter_circuit(ctx, inputs, pub, VoterFlags(**config["flags"]))
    return ctx, [c.value for c in pub]
