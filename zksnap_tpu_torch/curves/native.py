# Copy of zksnap_tpu/curves/native.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""Host-side short-Weierstrass curve arithmetic over python ints.

The native mirror of halo2curves' `Secp256k1Affine` / bn256 `G1Affine` group
ops used by the reference's input generators and native verifiers
(voter_tests/src/lib.rs:57-119, aggregator/src/utils.rs).  Device-side
batched kernels live in curves/jacobian.py.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CurveParams:
    name: str
    p: int          # base field modulus
    n: int          # group order (scalar field modulus)
    a: int
    b: int
    gx: int
    gy: int


SECP256K1 = CurveParams(
    name="secp256k1",
    p=2**256 - 2**32 - 977,
    n=115792089237316195423570985008687907852837564279074904382605163141518161494337,
    a=0,
    b=7,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)

BN254_G1 = CurveParams(
    name="bn254_g1",
    p=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    n=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    a=0,
    b=3,
    gx=1,
    gy=2,
)


class AffinePoint:
    """Immutable affine point; None coords = identity."""

    __slots__ = ("curve", "x", "y")

    def __init__(self, curve: CurveParams, x: int | None, y: int | None):
        self.curve = curve
        self.x = x
        self.y = y

    @classmethod
    def identity(cls, curve: CurveParams) -> "AffinePoint":
        return cls(curve, None, None)

    @classmethod
    def generator(cls, curve: CurveParams) -> "AffinePoint":
        return cls(curve, curve.gx, curve.gy)

    def is_identity(self) -> bool:
        return self.x is None

    def on_curve(self) -> bool:
        if self.is_identity():
            return True
        p, a, b = self.curve.p, self.curve.a, self.curve.b
        return (self.y * self.y - (self.x**3 + a * self.x + b)) % p == 0

    def __eq__(self, other) -> bool:
        return (self.x, self.y) == (other.x, other.y)

    def __neg__(self) -> "AffinePoint":
        if self.is_identity():
            return self
        return AffinePoint(self.curve, self.x, (-self.y) % self.curve.p)

    def __add__(self, other: "AffinePoint") -> "AffinePoint":
        if self.is_identity():
            return other
        if other.is_identity():
            return self
        p = self.curve.p
        if self.x == other.x:
            if (self.y + other.y) % p == 0:
                return AffinePoint.identity(self.curve)
            # doubling
            lam = (3 * self.x * self.x + self.curve.a) * pow(2 * self.y, -1, p) % p
        else:
            lam = (other.y - self.y) * pow(other.x - self.x, -1, p) % p
        x3 = (lam * lam - self.x - other.x) % p
        y3 = (lam * (self.x - x3) - self.y) % p
        return AffinePoint(self.curve, x3, y3)

    def __sub__(self, other: "AffinePoint") -> "AffinePoint":
        return self + (-other)

    def __mul__(self, k: int) -> "AffinePoint":
        k %= self.curve.n
        result = AffinePoint.identity(self.curve)
        addend = self
        while k:
            if k & 1:
                result = result + addend
            addend = addend + addend
            k >>= 1
        return result

    __rmul__ = __mul__

    def __repr__(self):
        if self.is_identity():
            return f"AffinePoint({self.curve.name}, identity)"
        return f"AffinePoint({self.curve.name}, x={hex(self.x)}, y={hex(self.y)})"


def secp_generator() -> AffinePoint:
    return AffinePoint.generator(SECP256K1)


def bn254_generator() -> AffinePoint:
    return AffinePoint.generator(BN254_G1)
