# Frozen copy of the host sponge of zksnap_tpu_torch/hash/poseidon.py for the benchmark.
"""Poseidon over BN254 Fr on python ints: the sponge that the voter's
inputs and the proof transcript use.

Spec (T=3, RATE=2, R_F=8, R_P=57, grain-generated constants): R_F/2 full
rounds, R_P partial rounds (sbox on cell 0 only), R_F/2 full rounds; each
round adds its constants, applies the sbox x^5 and the MDS matrix.  The
sponge starts as [2^64, 0, 0]; update() absorbs full RATE chunks into
state[1..]; squeeze() pads the buffer with a single 1, absorbs it and
returns state[1]; squeeze_and_reset() then restores the initial state.
"""

from __future__ import annotations

import functools

from .grain import generate_poseidon_params

FR_P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
T = 3
RATE = 2
R_F = 8
R_P = 57
CAP_TAG = 1 << 64


class PoseidonSpec:
    def __init__(self, p: int = FR_P, t: int = T, rate: int = RATE,
                 r_f: int = R_F, r_p: int = R_P):
        self.p = p
        self.t, self.rate, self.r_f, self.r_p = t, rate, r_f, r_p
        self.rc, self.mds, _ = generate_poseidon_params(p, t, rate, r_f, r_p)

    def permute(self, state: list[int]) -> list[int]:
        p, t, half_f = self.p, self.t, self.r_f // 2
        rc, mds = self.rc, self.mds

        def sbox(x):
            x2 = x * x % p
            return x2 * x2 % p * x % p

        def apply_mds(s):
            return [sum(mds[i][j] * s[j] for j in range(t)) % p
                    for i in range(t)]

        s = list(state)
        r = 0
        for _ in range(half_f):
            s = apply_mds([sbox((v + rc[r][i]) % p) for i, v in enumerate(s)])
            r += 1
        for _ in range(self.r_p):
            s = [(v + rc[r][i]) % p for i, v in enumerate(s)]
            s[0] = sbox(s[0])
            s = apply_mds(s)
            r += 1
        for _ in range(half_f):
            s = apply_mds([sbox((v + rc[r][i]) % p) for i, v in enumerate(s)])
            r += 1
        return s


@functools.cache
def default_spec() -> PoseidonSpec:
    return PoseidonSpec()


class PoseidonNative:
    """Duplex sponge (pse-poseidon's `Poseidon::<Fr,3,2>::new(8,57)`)."""

    def __init__(self, spec: PoseidonSpec | None = None):
        self.spec = spec or default_spec()
        self.reset()

    def reset(self):
        self.state = [CAP_TAG % self.spec.p] + [0] * (self.spec.t - 1)
        self.absorbing: list[int] = []

    def update(self, elements):
        buf = self.absorbing + [e % self.spec.p for e in elements]
        rate = self.spec.rate
        while len(buf) >= rate:
            chunk, buf = buf[:rate], buf[rate:]
            self._absorb_chunk(chunk)
        self.absorbing = buf

    def _absorb_chunk(self, chunk):
        p = self.spec.p
        for i, v in enumerate(chunk):
            self.state[i + 1] = (self.state[i + 1] + v) % p
        self.state = self.spec.permute(self.state)

    def squeeze(self) -> int:
        last = self.absorbing + [1]
        self.absorbing = []
        rate = self.spec.rate
        while len(last) > rate:
            chunk, last = last[:rate], last[rate:]
            self._absorb_chunk(chunk)
        self._absorb_chunk(last)
        return self.state[1]

    def squeeze_and_reset(self) -> int:
        out = self.squeeze()
        self.reset()
        return out
