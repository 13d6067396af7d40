# Copy of zksnap_tpu/prover/transcript.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""Poseidon Fiat-Shamir transcript over a byte wire format.

Reference parity: snark-verifier's `PoseidonTranscript<NativeLoader, _>`
(wrapper.rs:59-60,127-128) -- Poseidon over BN254 Fr with T=3/RATE=2/
R_F=8/R_P=57, proofs as plain byte streams (halo2's
`Blake2bWrite`-replacement transcript emits bytes; we do the same).

Wire format (documented, pinned by tests/test_serialize.py vectors):
  * scalar: 32 bytes, little-endian canonical Fr value;
  * point: 64 bytes, x || y as 32-byte little-endian canonical Fq
    values; the identity is encoded as x = y = 0 (not a curve point,
    reserved).
The stream carries NO tags -- the verifier knows the shape from the
verifying key (same as halo2, where the transcript is read by type).

Absorption rule (the part the in-circuit verifier replays):
  * scalar: absorbed as one Fr element;
  * point: absorbed as SIX Fr elements -- the 88-bit limb decomposition
    (LimbsEncoding<3,88>, wrapper.rs:56) of x then of y, least-significant
    limb first.  Limb absorption keeps every absorbed element < 2^88 and
    lets the recursion circuit absorb non-native coordinates limb-by-limb
    without a mod-Fr reduction gadget.
  * public instances are absorbed (binding) but NOT written to the stream
    -- the verifier supplies them.
"""

from __future__ import annotations

from ..curves.native import BN254_G1, AffinePoint
from ..fields.field import bn254_fr
from ..hash.poseidon import PoseidonNative

FR = bn254_fr()

ENC_LIMB_BITS = 88
ENC_LIMBS = 3
_ENC_MASK = (1 << ENC_LIMB_BITS) - 1


def fe_to_limbs(v: int) -> list[int]:
    """LimbsEncoding<3,88> of a (<=254-bit) field element, LSB limb first."""
    return [(v >> (ENC_LIMB_BITS * i)) & _ENC_MASK for i in range(ENC_LIMBS)]


class ByteReader:
    """Cursor over a proof byte stream."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("proof stream truncated")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def done(self) -> bool:
        return self.pos == len(self.data)


class Transcript:
    def __init__(self):
        self.sponge = PoseidonNative()
        self.buf = bytearray()

    # -- absorption (shared) --------------------------------------------------

    def absorb_scalar(self, s: int):
        """Bind a scalar the verifier already knows (e.g. instances)."""
        self.sponge.update([s % FR.p])

    def absorb_point(self, p: AffinePoint):
        """Bind a point the verifier recomputes (e.g. accumulator fold)."""
        x, y = (0, 0) if p.is_identity() else (p.x, p.y)
        self.sponge.update(fe_to_limbs(x) + fe_to_limbs(y))

    # -- prover side ----------------------------------------------------------

    def write_point(self, p: AffinePoint):
        x, y = (0, 0) if p.is_identity() else (p.x, p.y)
        self.buf += int(x).to_bytes(32, "little")
        self.buf += int(y).to_bytes(32, "little")
        self.absorb_point(p)

    def write_scalar(self, s: int):
        self.buf += (s % FR.p).to_bytes(32, "little")
        self.absorb_scalar(s)

    # -- verifier side ---------------------------------------------------------

    def read_point(self, stream: ByteReader) -> AffinePoint:
        x = int.from_bytes(stream.take(32), "little")
        y = int.from_bytes(stream.take(32), "little")
        if x == 0 and y == 0:
            p = AffinePoint.identity(BN254_G1)
        else:
            q = BN254_G1.p
            if x >= q or y >= q:
                raise ValueError("point coordinate out of range")
            if (y * y - (x * x * x + BN254_G1.b)) % q != 0:
                raise ValueError("point not on curve")
            p = AffinePoint(BN254_G1, x, y)
        self.absorb_point(p)
        return p

    def read_scalar(self, stream: ByteReader) -> int:
        s = int.from_bytes(stream.take(32), "little")
        if s >= FR.p:
            raise ValueError("scalar out of range")
        self.absorb_scalar(s)
        return s

    # -- shared ----------------------------------------------------------------

    def challenge(self) -> int:
        return self.sponge.squeeze()

    def proof(self) -> bytes:
        return bytes(self.buf)
