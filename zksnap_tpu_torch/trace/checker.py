# Copy of zksnap_tpu/trace/checker.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""Constraint checker: the MockProver equivalent.

Reference parity: halo2_proofs `MockProver::run(...).verify()` as used by
every reference test (voter_tests/src/lib.rs:239-240,
state_transition.rs:341-342) and as the pre-flight inside gen_proof
(wrapper.rs:117-123).  Checks constraint satisfiability without any crypto:
gate equations, copy constraints, constant bindings, range lookups and
instance layout, with precise error reporting.

Copy / constant / lookup checks are fully vectorized over the trace
builder's limb arrays; the gate equation (exact 254-bit arithmetic) runs
chunked -- gather 4 limb rows per gate, convert once per chunk, evaluate
with python ints -- so a 97M-cell wrapper trace checks in ~a minute
instead of the former hours.
"""

from __future__ import annotations

import numpy as np

from .context import Context, u16_rows_to_ints

_CHUNK = 1 << 15


class ConstraintError(AssertionError):
    pass


def check(ctx: Context, instances: list[int] | None = None) -> dict:
    """Verify every recorded constraint over the witness; returns stats.

    Raises ConstraintError with the first failing site otherwise.
    """
    p = ctx.p
    adv = ctx.advice.limbs()

    # -- gates: a[g] + a[g+1]*a[g+2] == a[g+3], exact, chunked ---------------
    gates = ctx.gate_offsets.array()
    for s in range(0, len(gates), _CHUNK):
        g = gates[s : s + _CHUNK]
        ops = [u16_rows_to_ints(adv[g + off]) for off in range(4)]
        for t in range(len(g)):
            if (ops[0][t] + ops[1][t] * ops[2][t] - ops[3][t]) % p:
                gi = int(g[t])
                raise ConstraintError(
                    f"gate at offset {gi}: {ops[0][t]} + "
                    f"{ops[1][t]}*{ops[2][t]} != {ops[3][t]}")

    # -- copies: limb rows must match exactly --------------------------------
    copies = ctx.copies.pairs()
    if len(copies):
        bad = (adv[copies[:, 0]] != adv[copies[:, 1]]).any(axis=1)
        if bad.any():
            i, j = (int(v) for v in copies[int(np.flatnonzero(bad)[0])])
            raise ConstraintError(
                f"copy ({i},{j}): {ctx.advice[i]} != {ctx.advice[j]}")

    # -- constants: cell value must equal the recorded constant --------------
    cidx = ctx.const_idx.array()
    if len(cidx):
        cvals = ctx.const_vals.limbs()
        bad = (adv[cidx] != cvals).any(axis=1)
        if bad.any():
            t = int(np.flatnonzero(bad)[0])
            i = int(cidx[t])
            want = u16_rows_to_ints(cvals[t : t + 1])[0]
            raise ConstraintError(f"constant at {i}: {ctx.advice[i]} != {want}")

    # -- lookups: value in [0, 2^lookup_bits) --------------------------------
    lidx = ctx.lookups.array()
    if len(lidx):
        rows = adv[lidx]
        vals = rows[:, 0].astype(np.int64) | (rows[:, 1].astype(np.int64) << 16)
        bad = (vals >= (1 << ctx.lookup_bits)) | (rows[:, 2:] != 0).any(axis=1)
        if bad.any():
            i = int(lidx[int(np.flatnonzero(bad)[0])])
            raise ConstraintError(
                f"lookup at {i}: {ctx.advice[i]} not in "
                f"[0, 2^{ctx.lookup_bits})")

    if instances is not None:
        got = [c.value for c in ctx.instance]
        if got != [v % p for v in instances]:
            raise ConstraintError(
                f"instance mismatch: circuit exposes {len(got)} values; "
                f"first diff at "
                f"{next((k for k, (x, y) in enumerate(zip(got, instances)) if x != y % p), 'len')}"
            )

    return ctx.stats()
