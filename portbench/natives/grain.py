# Frozen copy of zksnap_tpu_torch/hash/grain.py for the benchmark: program changes do not move it.
"""Grain-LFSR generation of Poseidon round constants and MDS matrices.

Implements the parameter generation of the Poseidon reference implementation
(`generate_parameters_grain.sage`), which the Rust stack used by the
reference repo follows (pse-poseidon natively, halo2-base's
`OptimizedPoseidonSpec` in-circuit; see the reference's voter/src/lib.rs:40-43
and aggregator/src/wrapper.rs:46-52 for the T=3/RATE=2/R_F=8/R_P=57 shape).

Generation pipeline (all bits MSB-first):
 1. 80-bit LFSR state seeded from (field=1, sbox=0, n, t, R_F, R_P, 30x1).
 2. 160 warm-up clockings are discarded.
 3. Output stream is self-shrunk: emit bit pairs, keep the 2nd iff the 1st is 1.
 4. Round constants: (R_F+R_P)*t field draws of n bits with full-redraw
    rejection sampling (value must be < p).
 5. MDS: continue the same stream; x_vec, y_vec of t draws each *without*
    rejection (reduced mod p); Cauchy matrix M[i][j] = 1/(x_i + y_j).
    `secure_mds` earlier candidate (x,y) pairs are skipped (0 in the
    reference, wrapper.rs:52).

Everything here is host-side python-int math, computed once and cached.
"""

from __future__ import annotations

import functools


class GrainLFSR:
    def __init__(self, n_bits: int, t: int, r_f: int, r_p: int):
        bits = []

        def push(value: int, width: int):
            for i in reversed(range(width)):
                bits.append((value >> i) & 1)

        push(1, 2)       # field: prime
        push(0, 4)       # sbox: x^alpha
        push(n_bits, 12)
        push(t, 12)
        push(r_f, 10)
        push(r_p, 10)
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._clock()

    def _clock(self) -> int:
        s = self.state
        new_bit = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new_bit)
        return new_bit

    def next_bit(self) -> int:
        """Self-shrunk output bit."""
        while True:
            b1 = self._clock()
            b2 = self._clock()
            if b1:
                return b2

    def random_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.next_bit()
        return v

    def field_element(self, n_bits: int, p: int) -> int:
        """Rejection-sampled draw < p (full redraw on failure)."""
        while True:
            v = self.random_bits(n_bits)
            if v < p:
                return v

    def field_element_no_reject(self, n_bits: int, p: int) -> int:
        return self.random_bits(n_bits) % p


@functools.cache
def generate_poseidon_params(
    p: int, t: int, rate: int, r_f: int, r_p: int, secure_mds: int = 0
):
    """-> (round_constants [(r_f+r_p)][t], mds [t][t], mds_inv [t][t]) as ints."""
    n_bits = p.bit_length()
    grain = GrainLFSR(n_bits, t, r_f, r_p)
    round_constants = [
        [grain.field_element(n_bits, p) for _ in range(t)]
        for _ in range(r_f + r_p)
    ]
    for _ in range(secure_mds + 1):
        xs = [grain.field_element_no_reject(n_bits, p) for _ in range(t)]
        ys = [grain.field_element_no_reject(n_bits, p) for _ in range(t)]
    mds = [[pow((xs[i] + ys[j]) % p, -1, p) for j in range(t)] for i in range(t)]
    # invert MDS over GF(p) (gauss-jordan) for decomposition/testing uses
    mds_inv = _matrix_inverse(mds, p)
    return round_constants, mds, mds_inv


def _matrix_inverse(m, p):
    t = len(m)
    aug = [[m[i][j] % p for j in range(t)] + [1 if i == j else 0 for j in range(t)]
           for i in range(t)]
    for col in range(t):
        piv = next(r for r in range(col, t) if aug[r][col] % p != 0)
        aug[col], aug[piv] = aug[piv], aug[col]
        inv_p = pow(aug[col][col], -1, p)
        aug[col] = [v * inv_p % p for v in aug[col]]
        for r in range(t):
            if r != col and aug[r][col]:
                f = aug[r][col]
                aug[r] = [(a - f * b) % p for a, b in zip(aug[r], aug[col])]
    return [row[t:] for row in aug]
