"""A small arithmetic chain on the program's trace Context: per term a
product added on (a gate with copies), a range-checked witness added on
(the lookup), a constant offset, one public instance.  `terms` sets the
size; it exercises every kind of constraint the voter has at K=7."""

from __future__ import annotations

import random

from ..natives.poseidon import FR_P


def make_inputs(config: dict, seed: int) -> dict:
    rng = random.Random(seed)
    n, bits = config["terms"], config["lookup_bits"]
    return {"x": [rng.randrange(FR_P) for _ in range(n)],
            "y": [rng.randrange(FR_P) for _ in range(n)],
            "r": [rng.randrange(1 << bits) for _ in range(n)]}


def synthesize(config: dict, inputs: dict):
    from zksnap_tpu_torch.trace import Context

    ctx = Context(lookup_bits=config["lookup_bits"])
    acc = ctx.load_constant(config["offset"])
    for x, y, r in zip(inputs["x"], inputs["y"], inputs["r"]):
        acc = ctx.mul_add(ctx.load_witness(x), ctx.load_witness(y), acc)
        rc = ctx.load_witness(r)
        ctx.range_check(rc, config["lookup_bits"])
        acc = ctx.add(acc, rc)
    ctx.expose_public(acc)
    return ctx, [acc.value]
