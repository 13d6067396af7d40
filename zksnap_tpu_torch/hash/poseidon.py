# Copy of zksnap_tpu/hash/poseidon.py (its device path the port's own): jax-free; goes once zksnap_tpu imports jax lazily.
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

import numpy as np
import torch

from ..fields.common import int_to_limbs
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

    # ---- device-side (batched Montgomery limb tensors) -------------------

    @functools.cached_property
    def rc_mont(self):
        """[r_f+r_p, t, 16] int32 round constants, Montgomery form (numpy;
        `permute` copies them to the state's device)."""
        return np.stack([
            np.stack([int_to_limbs(c * self.F.R % self.F.p) for c in row])
            for row in self.rc
        ])

    @functools.cached_property
    def mds_mont(self):
        return np.stack([
            np.stack([int_to_limbs(c * self.F.R % self.F.p) for c in row])
            for row in self.mds
        ])

    def permute(self, state):
        """Batched permutation: state [..., t, 16] Montgomery -> same shape,
        on the state's device.  The rounds run one after another, each as
        a few batched field operations (kernels K1 and K2 on the card)
        over the whole batch."""
        F = self.F
        t, half_f = self.t, self.r_f // 2
        rc = torch.from_numpy(self.rc_mont).to(state.device)
        mds = torch.from_numpy(self.mds_mont).to(state.device)

        def sbox(x):
            x2 = F.square(x)
            return F.mul(F.square(x2), x)

        def apply_mds(s):
            # s: [..., t, 16]; out[i] = sum_j mds[i][j]*s[j]
            prods = F.mul(mds, s[..., None, :, :])  # [..., t, t, 16]
            acc = prods[..., 0, :]
            for j in range(1, t):
                acc = F.add(acc, prods[..., j, :])
            return acc

        def full_round(s, rc_row):
            s = F.add(s, rc_row)
            return apply_mds(sbox(s))

        def partial_round(s, rc_row):
            s = F.add(s, rc_row)
            s0 = sbox(s[..., 0:1, :])
            s = torch.cat([s0, s[..., 1:, :]], dim=-2)
            return apply_mds(s)

        s = state
        for r in range(half_f):
            s = full_round(s, rc[r])
        for r in range(half_f, half_f + self.r_p):
            s = partial_round(s, rc[r])
        for r in range(half_f + self.r_p, self.r_f + self.r_p):
            s = full_round(s, rc[r])
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


def hash_fixed_batched(inputs, spec: PoseidonSpec | None = None):
    """Batched fixed-length hash on the device of `inputs`.

    inputs: [..., n, 16] Montgomery limb tensor (n elements per hash).
    Returns [..., 16].  Same absorb/pad schedule as the native sponge.
    """
    spec = spec or default_spec()
    return _hash_fixed_impl(inputs, spec)


def _hash_fixed_impl(inputs, spec: PoseidonSpec):
    F = spec.F
    dev = inputs.device
    n = inputs.shape[-2]
    batch = tuple(inputs.shape[:-2])
    state = torch.stack([
        F.const_t(CAP_TAG, dev), F.const_t(0, dev), F.const_t(0, dev)
    ]).expand(batch + (spec.t, inputs.shape[-1]))
    rate = spec.rate
    pos = 0
    while n - pos >= rate:
        chunk = inputs[..., pos : pos + rate, :]
        state = _absorb(F, state, chunk, rate)
        state = spec.permute(state)
        pos += rate
    # trailing chunk + 1-padding
    tail = [inputs[..., i, :] for i in range(pos, n)]
    tail.append(F.one_t(dev).expand(batch + (inputs.shape[-1],)))
    tail_arr = torch.stack(tail, dim=-2)
    state = _absorb(F, state, tail_arr, len(tail))
    state = spec.permute(state)
    return state[..., 1, :]


def _absorb(F, state, chunk, width):
    parts = [state[..., 0, :]]
    for i in range(width):
        parts.append(F.add(state[..., i + 1, :], chunk[..., i, :]))
    for i in range(width + 1, state.shape[-2]):
        parts.append(state[..., i, :])
    return torch.stack(parts, dim=-2)
