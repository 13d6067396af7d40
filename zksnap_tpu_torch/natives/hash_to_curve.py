# Copy of zksnap_tpu/natives/hash_to_curve.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""RFC 9380 hash-to-curve for secp256k1: suite secp256k1_XMD:SHA-256_SSWU_RO_.

Native mirror of the k256 `hash_from_bytes::<ExpandMsgXmd<Sha256>>` call in
voter_tests/src/lib.rs:36-55 (the PLUME hash-to-curve), including the same
DST ("QUUX-V01-CS02-with-secp256k1_XMD:SHA-256_SSWU_RO_",
voter_tests/src/lib.rs:39).

Pipeline: expand_message_xmd(SHA-256) -> 2 field draws -> simplified SWU on
the 3-isogenous curve E' (Z=-11) -> 3-isogeny map to secp256k1 -> point add.
Constants from RFC 9380 section 8.7 / appendix E.1.
"""

from __future__ import annotations

import hashlib

from ..curves.native import SECP256K1, AffinePoint

P = SECP256K1.p

# E': y^2 = x^3 + A'x + B' (3-isogenous to secp256k1), RFC 9380 8.7
ISO_A = 0x3F8731ABDD661ADCA08A5558F0F5D272E953D363CB6F0E5D405447C01A444533
ISO_B = 1771
Z = (-11) % P

# 3-isogeny map E' -> secp256k1, RFC 9380 E.1
K1 = [
    0x8E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38DAAAAA8C7,
    0x7D3D4C80BC321D5B9F315CEA7FD44C5D595D2FC0BF63B92DFFF1044F17C6581,
    0x534C328D23F234E6E2A413DECA25CAECE4506144037C40314ECBD0B53D9DD262,
    0x8E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38E38DAAAAA88C,
]
K2 = [
    0xD35771193D94918A9CA34CCBB7B640DD86CD409542F8487D9FE6B745781EB49B,
    0xEDADC6F64383DC1DF7C4B2D51B54225406D36B641F5E41BBC52A56612A8C6D14,
]
K3 = [
    0x4BDA12F684BDA12F684BDA12F684BDA12F684BDA12F684BDA12F684B8E38E23C,
    0xC75E0C32D5CB7C0FA9D0A54B12A0A6D5647AB046D686DA6FDFFC90FC201D71A3,
    0x29A6194691F91A73715209EF6512E576722830A201BE2018A765E85A9ECEE931,
    0x2F684BDA12F684BDA12F684BDA12F684BDA12F684BDA12F684BDA12F38E38D84,
]
K4 = [
    0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFF93B,
    0x7A06534BB8BDB49FD5E9E6632722C2989467C1BFC8E8D978DFB425D2685C2573,
    0x6484AA716545CA2CF3A70C3FA8FE337E0A3D21162F0D6299A7BF8192BFD2A76F,
]


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 section 5.3.1 with SHA-256."""
    b_in_bytes = 32
    s_in_bytes = 64
    ell = -(-len_in_bytes // b_in_bytes)
    assert ell <= 255 and len_in_bytes <= 65535 and len(dst) <= 255
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(s_in_bytes)
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    msg_prime = z_pad + msg + l_i_b_str + b"\x00" + dst_prime
    b0 = hashlib.sha256(msg_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    bs = [b1]
    for i in range(2, ell + 1):
        prev = bs[-1]
        xored = bytes(a ^ b for a, b in zip(b0, prev))
        bs.append(hashlib.sha256(xored + bytes([i]) + dst_prime).digest())
    return b"".join(bs)[:len_in_bytes]


def hash_to_field(msg: bytes, dst: bytes, count: int = 2) -> list[int]:
    """RFC 9380 section 5.2: m=1, L=48 for this suite."""
    L = 48
    uniform = expand_message_xmd(msg, dst, count * L)
    return [
        int.from_bytes(uniform[i * L : (i + 1) * L], "big") % P
        for i in range(count)
    ]


def _sqrt(a: int) -> int | None:
    """Square root mod P (p % 4 == 3 for secp256k1)."""
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a % P else None


def map_to_curve_sswu(u: int) -> tuple[int, int]:
    """Simplified SWU onto E' (RFC 9380 section 6.6.2)."""
    A, B = ISO_A, ISO_B
    tv1 = (Z * Z * pow(u, 4, P) + Z * u * u) % P
    if tv1 == 0:
        x1 = B * pow(Z * A % P, -1, P) % P
    else:
        x1 = (-B % P) * pow(A, -1, P) % P * (1 + pow(tv1, -1, P)) % P
    gx1 = (pow(x1, 3, P) + A * x1 + B) % P
    y1 = _sqrt(gx1)
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = Z * u * u % P * x1 % P
        gx2 = (pow(x2, 3, P) + A * x2 + B) % P
        y2 = _sqrt(gx2)
        assert y2 is not None
        x, y = x2, y2
    if (u % 2) != (y % 2):  # sgn0 matching
        y = (-y) % P
    return x, y


def iso_map(x: int, y: int) -> tuple[int, int]:
    """3-isogeny E' -> secp256k1 (RFC 9380 E.1)."""
    x_num = (K1[3] * pow(x, 3, P) + K1[2] * x * x + K1[1] * x + K1[0]) % P
    x_den = (x * x + K2[1] * x + K2[0]) % P
    y_num = (K3[3] * pow(x, 3, P) + K3[2] * x * x + K3[1] * x + K3[0]) % P
    y_den = (pow(x, 3, P) + K4[2] * x * x + K4[1] * x + K4[0]) % P
    xo = x_num * pow(x_den, -1, P) % P
    yo = y * y_num % P * pow(y_den, -1, P) % P
    return xo, yo


def hash_to_curve(msg: bytes, dst: bytes) -> AffinePoint:
    """Full RO suite: two SSWU points added on the target curve."""
    u0, u1 = hash_to_field(msg, dst, 2)
    q0 = AffinePoint(SECP256K1, *iso_map(*map_to_curve_sswu(u0)))
    q1 = AffinePoint(SECP256K1, *iso_map(*map_to_curve_sswu(u1)))
    r = q0 + q1  # h_eff = 1, no cofactor clearing
    assert r.on_curve()
    return r
