# Copy of zksnap_tpu/gadgets/poseidon_gadget.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""In-circuit Poseidon hasher gadget.

Reference parity: halo2-base `PoseidonHasher::<F,T,RATE>` +
`hash_fix_len_array` (voter/src/lib.rs:159-175, state_transition.rs:105-116,
merkletree/mod.rs:41).  Shares its spec (constants, absorb schedule,
padding) with the native sponge in hash/poseidon.py, so in-circuit hashes
equal native hashes -- the invariant the reference protocol relies on.
"""

from __future__ import annotations

from ..hash.poseidon import CAP_TAG, PoseidonSpec, default_spec
from ..trace.context import Cell, Context


class PoseidonGadget:
    def __init__(self, ctx: Context, spec: PoseidonSpec | None = None):
        self.ctx = ctx
        self.spec = spec or default_spec()
        assert self.spec.F.p == ctx.p

    def _sbox(self, x: Cell) -> Cell:
        ctx = self.ctx
        x2 = ctx.mul(x, x)
        x4 = ctx.mul(x2, x2)
        return ctx.mul(x4, x)

    def permute(self, state: list[Cell]) -> list[Cell]:
        """Public full permutation (used by the transcript gadget sponge)."""
        return self._permute(state)

    def _permute(self, state: list[Cell]) -> list[Cell]:
        ctx, spec = self.ctx, self.spec
        t, half_f = spec.t, spec.r_f // 2
        r = 0

        def mds_row(s, i):
            acc = ctx.load_constant(0)
            for j in range(t):
                acc = ctx.mul_add(s[j], spec.mds[i][j], acc)
            return acc

        s = state
        for phase, rounds in ((0, half_f), (1, spec.r_p), (2, half_f)):
            for _ in range(rounds):
                s = [ctx.add_const(s[i], spec.rc[r][i]) for i in range(t)]
                if phase == 1:
                    s = [self._sbox(s[0])] + s[1:]
                else:
                    s = [self._sbox(v) for v in s]
                s = [mds_row(s, i) for i in range(t)]
                r += 1
        return s

    def hash_fix_len_array(self, inputs: list[Cell]) -> Cell:
        """Fresh sponge; same schedule as hash/poseidon.py hash_fixed_*."""
        ctx, spec = self.ctx, self.spec
        rate = spec.rate
        state = [ctx.load_constant(CAP_TAG % ctx.p)] + [
            ctx.load_constant(0) for _ in range(spec.t - 1)
        ]
        buf = list(inputs)
        while len(buf) >= rate:
            chunk, buf = buf[:rate], buf[rate:]
            state = self._absorb(state, chunk)
        tail = buf + [ctx.load_constant(1)]
        state = self._absorb(state, tail)
        return state[1]

    def _absorb(self, state: list[Cell], chunk: list[Cell]) -> list[Cell]:
        ctx = self.ctx
        new_state = list(state)
        for i, v in enumerate(chunk):
            new_state[i + 1] = ctx.add(state[i + 1], v)
        return self._permute(new_state)
