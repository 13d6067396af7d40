"""Batched short-Weierstrass group ops in Jacobian coordinates (a = 0),
PyTorch port of zksnap_tpu/curves/jacobian.py.

Points are three Montgomery limb tensors (X, Y, Z), each [..., 16]; Z == 0
encodes the identity, (1:1:0) is the canonical one.  Every group
operation is one launch of kernel K3 (curves/fused.py `point`) on a CUDA
tensor, its plain version on a CPU tensor.

Formula source: EFD dbl-2009-l and add-2007-bl for a = 0 curves.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..fields.common import N_LIMBS
from ..fields.field import PrimeField, bn254_fq, secp256k1_fp
from .fused import point
from .native import BN254_G1, SECP256K1, AffinePoint, CurveParams


@dataclass(frozen=True)
class JacPoint:
    """Three coordinate tensors, each [..., 16] int32."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return self.x.shape[:-1]

    @property
    def device(self):
        return self.x.device


class CurveOps:
    """Batched group law for one curve over its base field."""

    kinds = ("add", "madd", "dbl")
    b3 = 0

    def __init__(self, params: CurveParams, F: PrimeField):
        assert params.a == 0
        self.params = params
        self.F = F

    # -- constructors -------------------------------------------------------

    def identity(self, shape=(), device="cuda") -> JacPoint:
        z = torch.zeros(shape + (N_LIMBS,), dtype=torch.int32, device=device)
        one = self.F.one_t(device).expand(shape + (N_LIMBS,))
        return JacPoint(one, one, z)

    def from_affine_host(self, pts: list[AffinePoint],
                         device="cuda") -> JacPoint:
        """Host affine points -> device batch (identity-safe)."""
        F = self.F
        xs = [0 if p.is_identity() else p.x for p in pts]
        ys = [1 if p.is_identity() else p.y for p in pts]
        zs = [0 if p.is_identity() else 1 for p in pts]
        return JacPoint(F.to_mont(xs, device), F.to_mont(ys, device),
                        F.to_mont(zs, device))

    def to_affine_host(self, p: JacPoint) -> list[AffinePoint]:
        """Jacobian batch -> host affine points (python ints)."""
        F = self.F
        xs, ys, zs = F.from_mont(p.x), F.from_mont(p.y), F.from_mont(p.z)
        if isinstance(xs, int):
            xs, ys, zs = [xs], [ys], [zs]
        q = self.params.p
        out = []
        for x, y, z in zip(xs, ys, zs):
            if z == 0:
                out.append(AffinePoint.identity(self.params))
            else:
                zinv = pow(z, -1, q)
                zi2 = zinv * zinv % q
                out.append(AffinePoint(self.params, x * zi2 % q,
                                       y * zi2 % q * zinv % q))
        return out

    # -- group law ----------------------------------------------------------

    def is_identity(self, p: JacPoint):
        return self.F.is_zero(p.z)

    def _op(self, kind: str, *pts: JacPoint) -> JacPoint:
        arrays = [c for pt in pts for c in (pt.x, pt.y, pt.z)]
        return JacPoint(*point(kind, arrays, self.F.p, self.b3))

    def double(self, p: JacPoint) -> JacPoint:
        """Identity doubles to identity (Z stays 0)."""
        return self._op(self.kinds[2], p)

    def add(self, p: JacPoint, q: JacPoint) -> JacPoint:
        """Complete addition (P == Q, P == -Q, identities)."""
        return self._op(self.kinds[0], p, q)

    def madd(self, p: JacPoint, q: JacPoint) -> JacPoint:
        """Mixed complete add: q.z MUST be 0 (identity) or Montgomery 1."""
        return self._op(self.kinds[1], p, q)

    def normalize(self, p: JacPoint) -> JacPoint:
        """Batched Jacobian -> affine-or-identity (z in {0, mont 1}), one
        batch inversion (zeros map to zeros)."""
        F = self.F
        bs = p.batch_shape
        z = p.z.reshape(-1, N_LIMBS)
        zinv = F.batch_inv(z)
        zi2 = F.square(zinv)
        x = F.mul(p.x.reshape(-1, N_LIMBS), zi2)
        y = F.mul(p.y.reshape(-1, N_LIMBS), F.mul(zi2, zinv))
        return _affine_out(F, x, y, z, bs)

    def neg(self, p: JacPoint) -> JacPoint:
        return JacPoint(p.x, self.F.neg(p.y), p.z)

    def select(self, cond, p: JacPoint, q: JacPoint) -> JacPoint:
        F = self.F
        return JacPoint(F.select(cond, p.x, q.x), F.select(cond, p.y, q.y),
                        F.select(cond, p.z, q.z))

    def scalar_mul(self, p: JacPoint, k_bits) -> JacPoint:
        """Double-and-add over a [..., nbits] bool/0-1 tensor, MSB first."""
        acc = self.identity(p.batch_shape, p.device)
        for i in range(k_bits.shape[-1]):
            acc = self.double(acc)
            added = self.add(acc, p)
            acc = self.select(k_bits[..., i].to(torch.bool), added, acc)
        return acc

    def generator(self, shape=(), device="cuda") -> JacPoint:
        F = self.F
        full = shape + (N_LIMBS,)
        return JacPoint(F.const_t(self.params.gx, device).expand(full),
                        F.const_t(self.params.gy, device).expand(full),
                        F.one_t(device).expand(full))


def _affine_out(F, x, y, z, bs) -> JacPoint:
    """(x, y) plus z in {0 for identities, mont 1} reshaped to bs."""
    inf = F.is_zero(z)
    one = F.one_t(z.device).expand(z.shape)
    zout = torch.where(inf[..., None], torch.zeros_like(z), one)
    return JacPoint(x.reshape(*bs, N_LIMBS), y.reshape(*bs, N_LIMBS),
                    zout.reshape(*bs, N_LIMBS))


@functools.cache
def bn254_ops() -> CurveOps:
    return CurveOps(BN254_G1, bn254_fq())


@functools.cache
def secp_ops() -> CurveOps:
    return CurveOps(SECP256K1, secp256k1_fp())
