# Copy of zksnap_tpu/natives/plume.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""PLUME V1 deterministic nullifiers (native mirror).

Reference: voter_tests/src/lib.rs:25-119 (`compress_point`, `hash_to_curve`,
`verify_nullifier`, `gen_test_nullifier`).  The scheme:

  pk = g^sk;  H = hash_to_curve(message || compress(pk));  N = H^sk
  r random;   c = SHA256(compress(g) || compress(pk) || compress(H) ||
                          compress(N) || compress(g^r) || compress(H^r))
  s = r + sk*c (mod n)
  verify: recompute H; check c == SHA256(..., g^s * pk^-c, H^s * N^-c)
"""

from __future__ import annotations

import hashlib

from ..curves.native import SECP256K1, AffinePoint, secp_generator

DST = b"QUUX-V01-CS02-with-secp256k1_XMD:SHA-256_SSWU_RO_"
N_ORDER = SECP256K1.n


def compress_point(point: AffinePoint) -> bytes:
    """33-byte SEC1 compression: tag (2 even / 3 odd y) || x big-endian.

    Reference voter_tests/src/lib.rs:25-34."""
    assert not point.is_identity()
    tag = 3 if point.y % 2 == 1 else 2
    return bytes([tag]) + point.x.to_bytes(32, "big")


def plume_hash_to_curve(message: bytes, compressed_pk: bytes) -> AffinePoint:
    from .hash_to_curve import hash_to_curve

    return hash_to_curve(message + compressed_pk, DST)


def _challenge(pk: AffinePoint, htc: AffinePoint, nullifier: AffinePoint,
               g_term: AffinePoint, h_term: AffinePoint) -> int:
    g = secp_generator()
    digest = hashlib.sha256(
        compress_point(g)
        + compress_point(pk)
        + compress_point(htc)
        + compress_point(nullifier)
        + compress_point(g_term)
        + compress_point(h_term)
    ).digest()
    # reference reverses the BE digest then reads LE => big-endian int, mod n
    return int.from_bytes(digest, "big") % N_ORDER


def gen_nullifier(sk: int, message: bytes, r: int) -> tuple[AffinePoint, int, int]:
    """-> (nullifier, s, c).  Reference `gen_test_nullifier` (r supplied
    explicitly instead of OsRng so tests are deterministic)."""
    g = secp_generator()
    pk = sk * g
    compressed_pk = compress_point(pk)
    htc = plume_hash_to_curve(message, compressed_pk)
    nullifier = sk * htc
    g_r = r * g
    h_r = r * htc
    c = _challenge(pk, htc, nullifier, g_r, h_r)
    s = (r + sk * c) % N_ORDER
    return nullifier, s, c


def verify_nullifier(message: bytes, nullifier: AffinePoint, pk: AffinePoint,
                     s: int, c: int) -> bool:
    """Reference `verify_nullifier` (voter_tests/src/lib.rs:57-86)."""
    g = secp_generator()
    compressed_pk = compress_point(pk)
    htc = plume_hash_to_curve(message, compressed_pk)
    h_s_n_c = s * htc - c * nullifier
    g_s_pk_c = s * g - c * pk
    return _challenge(pk, htc, nullifier, g_s_pk_c, h_s_n_c) == c
