"""The proof's Fiat-Shamir transcript, read side (frozen copy of
zksnap_tpu_torch/prover/transcript.py): Poseidon (T=3, RATE=2) over BN254
Fr.  A scalar is 32 bytes little-endian and absorbed as one element; a
point is x || y, 32 bytes each little-endian (the identity as 0, 0), and
absorbed as six elements, the 88-bit limbs of x then of y.  Public
instances are absorbed first and are not in the stream."""

from __future__ import annotations

from ..natives.curve import BN254_G1, AffinePoint
from ..natives.poseidon import FR_P, PoseidonNative

_LIMB = 88
_MASK = (1 << _LIMB) - 1


def _limbs(v: int) -> list[int]:
    return [(v >> (_LIMB * i)) & _MASK for i in range(3)]


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.sponge = PoseidonNative()

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("proof stream truncated")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def done(self) -> bool:
        return self.pos == len(self.data)

    def absorb_scalar(self, s: int):
        self.sponge.update([s % FR_P])

    def point(self) -> AffinePoint:
        x = int.from_bytes(self._take(32), "little")
        y = int.from_bytes(self._take(32), "little")
        if x == 0 and y == 0:
            pt = AffinePoint.identity(BN254_G1)
        else:
            q = BN254_G1.p
            if x >= q or y >= q:
                raise ValueError("point coordinate out of range")
            if (y * y - (x * x * x + BN254_G1.b)) % q:
                raise ValueError("point not on the curve")
            pt = AffinePoint(BN254_G1, x, y)
        self.sponge.update(_limbs(x) + _limbs(y))
        return pt

    def scalar(self) -> int:
        s = int.from_bytes(self._take(32), "little")
        if s >= FR_P:
            raise ValueError("scalar out of range")
        self.absorb_scalar(s)
        return s

    def challenge(self) -> int:
        return self.sponge.squeeze()
