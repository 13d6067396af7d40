"""Batched group ops in homogeneous projective coordinates with the
Renes-Costello-Batina COMPLETE formulas (a = 0), PyTorch port of
zksnap_tpu/curves/proj.py -- the MSM's coordinate system.

Identity is (0 : 1 : 0); affine points embed as (x : y : 1), exactly as
in the Jacobian encoding, so SRS point sets serve both.  The group ops are
the padd / pmadd / pdbl kinds of kernel K3.
"""

from __future__ import annotations

import functools

import torch

from ..fields.common import N_LIMBS
from ..fields.field import PrimeField, bn254_fq, secp256k1_fp
from .jacobian import CurveOps, JacPoint, _affine_out
from .native import BN254_G1, SECP256K1, AffinePoint, CurveParams


class ProjOps(CurveOps):
    """CurveOps with the RCB complete projective group law."""

    kinds = ("padd", "pmadd", "pdbl")

    def __init__(self, params: CurveParams, F: PrimeField):
        super().__init__(params, F)
        self.b3 = 3 * params.b

    def identity(self, shape=(), device="cuda") -> JacPoint:
        z = torch.zeros(shape + (N_LIMBS,), dtype=torch.int32, device=device)
        one = self.F.one_t(device).expand(shape + (N_LIMBS,))
        return JacPoint(torch.zeros_like(z), one, z)

    def to_affine_host(self, p: JacPoint) -> list[AffinePoint]:
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
                out.append(AffinePoint(self.params, x * zinv % q,
                                       y * zinv % q))
        return out

    def normalize(self, p: JacPoint) -> JacPoint:
        """Projective -> affine-or-identity (z in {0, mont 1})."""
        F = self.F
        bs = p.batch_shape
        # canonicalise z so every identity is detected (a missed zero
        # would poison the batch inversion); the kernels are canonical
        # already, this keeps the JAX package's contract
        z = F.canon(p.z.reshape(-1, N_LIMBS))
        zinv = F.batch_inv(z)
        x = F.mul(p.x.reshape(-1, N_LIMBS), zinv)
        y = F.mul(p.y.reshape(-1, N_LIMBS), zinv)
        return _affine_out(F, x, y, z, bs)


@functools.cache
def bn254_proj_ops() -> ProjOps:
    return ProjOps(BN254_G1, bn254_fq())


@functools.cache
def secp_proj_ops() -> ProjOps:
    """secp256k1's RCB ops (b3 = 21): on CUDA tensors every group
    operation is a launch of K3's padd, pmadd or pdbl kind at secp256k1's
    modulus, on CPU tensors its plain version; its points are made on the
    card unless a call names another device."""
    return ProjOps(SECP256K1, secp256k1_fp())
