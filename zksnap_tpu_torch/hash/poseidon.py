# Copy of zksnap_tpu/hash/poseidon.py (host parts only): jax-free; goes once zksnap_tpu imports jax lazily.
"""Poseidon hash: host-side sponge oracle + batched TPU permutation.

Mirrors the pse-poseidon sponge used natively throughout the reference
(voter_tests/src/lib.rs:146-187, aggregator/src/utils.rs:110-150) and the
halo2-base `PoseidonHasher` gadget used in-circuit (voter/src/lib.rs:159-175).
The reference's protocol correctness relies on the native sponge and the
in-circuit hasher agreeing; we keep ALL spec choices (permutation schedule,
initial capacity tag, padding rule) in this one module so both our native
oracle and the circuit gadget share them.

Spec (T=3, RATE=2, R_F=8, R_P=57 over BN254 Fr, grain-generated constants):
  * permutation: R_F/2 full rounds, R_P partial rounds (sbox on cell 0 only),
    R_F/2 full rounds; each round: state += rc[round]; sbox; state = MDS@state.
  * sponge: state starts as [CAP_TAG, 0, 0] with CAP_TAG = 2^64; update()
    buffers elements and absorbs full RATE-chunks by adding into
    state[1..1+RATE] then permuting; squeeze() pads the trailing buffer with
    a single 1, absorbs, and returns state[1]; squeeze_and_reset() then
    restores the initial state.
"""

from __future__ import annotations

import functools


from ..fields.field import PrimeField, bn254_fr
from .grain import generate_poseidon_params

T = 3
RATE = 2
R_F = 8
R_P = 57
CAP_TAG = 1 << 64  # initial capacity element (domain tag)


class PoseidonSpec:
    """Constants + permutation for one (field, t, rate, r_f, r_p) shape."""

    def __init__(self, field: PrimeField, t: int = T, rate: int = RATE,
                 r_f: int = R_F, r_p: int = R_P, secure_mds: int = 0):
        self.F = field
        self.t, self.rate, self.r_f, self.r_p = t, rate, r_f, r_p
        rc, mds, mds_inv = generate_poseidon_params(
            field.p, t, rate, r_f, r_p, secure_mds
        )
        self.rc = rc            # [(r_f+r_p)][t] python ints
        self.mds = mds          # [t][t] python ints
        self.mds_inv = mds_inv

    # ---- host-side (python ints) -----------------------------------------

    def permute_native(self, state: list[int]) -> list[int]:
        p = self.F.p
        t, half_f = self.t, self.r_f // 2
        rc, mds = self.rc, self.mds

        def sbox(x):
            x2 = x * x % p
            return x2 * x2 % p * x % p

        def apply_mds(s):
            return [sum(mds[i][j] * s[j] for j in range(t)) % p for i in range(t)]

        s = list(state)
        r = 0
        for _ in range(half_f):
            s = [(v + rc[r][i]) % p for i, v in enumerate(s)]
            s = apply_mds([sbox(v) for v in s])
            r += 1
        for _ in range(self.r_p):
            s = [(v + rc[r][i]) % p for i, v in enumerate(s)]
            s[0] = sbox(s[0])
            s = apply_mds(s)
            r += 1
        for _ in range(half_f):
            s = [(v + rc[r][i]) % p for i, v in enumerate(s)]
            s = apply_mds([sbox(v) for v in s])
            r += 1
        return s


@functools.cache
def default_spec() -> PoseidonSpec:
    """The protocol-wide spec: BN254 Fr, T=3, RATE=2, R_F=8, R_P=57."""
    return PoseidonSpec(bn254_fr())


class PoseidonNative:
    """Host-side duplex sponge over python ints (pse-poseidon equivalent:
    `Poseidon::<Fr,3,2>::new(8,57)` / update / squeeze_and_reset)."""

    def __init__(self, spec: PoseidonSpec | None = None):
        self.spec = spec or default_spec()
        self.reset()

    def reset(self):
        self.state = [CAP_TAG % self.spec.F.p] + [0] * (self.spec.t - 1)
        self.absorbing: list[int] = []

    def update(self, elements):
        buf = self.absorbing + [e % self.spec.F.p for e in elements]
        self.absorbing = []
        rate = self.spec.rate
        while len(buf) >= rate:
            chunk, buf = buf[:rate], buf[rate:]
            self._absorb_chunk(chunk)
        self.absorbing = buf

    def _absorb_chunk(self, chunk):
        p = self.spec.F.p
        for i, v in enumerate(chunk):
            self.state[i + 1] = (self.state[i + 1] + v) % p
        self.state = self.spec.permute_native(self.state)

    def squeeze(self) -> int:
        last = self.absorbing + [1]
        self.absorbing = []
        rate = self.spec.rate
        while len(last) > rate:  # only when absorbing had rate-? (defensive)
            chunk, last = last[:rate], last[rate:]
            self._absorb_chunk(chunk)
        self._absorb_chunk(last)
        return self.state[1]

    def squeeze_and_reset(self) -> int:
        out = self.squeeze()
        self.reset()
        return out


def hash_fixed_native(inputs, spec: PoseidonSpec | None = None) -> int:
    """One-shot fixed-length hash (halo2-base `hash_fix_len_array` semantics
    = fresh sponge, update(inputs), squeeze)."""
    h = PoseidonNative(spec)
    h.update(list(inputs))
    return h.squeeze()
