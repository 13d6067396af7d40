# Frozen copy of zksnap_tpu_torch/natives/paillier.py for the benchmark: program changes do not move it.
"""Native Paillier encryption (mirror of paillier-chip's natives).

Reference: `paillier_enc_native` / `paillier_add_native` from the
paillier-chip crate, used at voter_tests/src/lib.rs:143 and
aggregator/src/utils.rs:43-49,337-341.

  enc(n, g, m, r) = g^m * r^n  mod n^2
  add(n, c1, c2)  = c1 * c2    mod n^2   (homomorphic plaintext addition)
"""

from __future__ import annotations


def paillier_enc(n: int, g: int, m: int, r: int) -> int:
    n2 = n * n
    return pow(g, m, n2) * pow(r, n, n2) % n2


def paillier_add(n: int, c1: int, c2: int) -> int:
    n2 = n * n
    return c1 * c2 % n2
