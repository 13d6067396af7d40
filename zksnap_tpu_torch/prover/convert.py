"""Carry state across from the JAX package: an SRS from the shared .npz
arrays, a proving key from a JAX `ProvingKey`'s fixed coefficients.

Both packages keep the same integer limb values (uint32 there, int32
here), so conversion is `np.asarray(x).astype(np.int32)`; a key's fixed
coefficients at rest (uint16 there, int16 bit patterns here) go through
`pack_poly`, and a JAX `LazyFixedCoeffs` becomes the port's, built from
the same host sources.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..curves.native import BN254_G1, AffinePoint
from . import pairing as pr
from .keygen import Layout
from .plonk import LazyFixedCoeffs, ProvingKey, VerifyingKey
from .poly_device import pack_poly
from .srs import SRS, srs_from_arrays


def _g2(pt):
    """A G2 point (pair of Fq2 with .a/.b) as the port's pairing type."""
    x, y = pt
    return (pr.Fq2(int(x.a), int(x.b)), pr.Fq2(int(y.a), int(y.b)))


def srs_from_numpy(arrays: dict, tau_g2, g2, device="cuda") -> SRS:
    """arrays: x, y, z, lx, ly, lz, each [n, 16] uint32 (the .npz format
    of both packages); tau_g2, g2: G2 points of either package."""
    return srs_from_arrays(arrays, _g2(tau_g2), _g2(g2), device)


def _affine(pt) -> AffinePoint:
    if pt.is_identity():
        return AffinePoint.identity(BN254_G1)
    return AffinePoint(BN254_G1, int(pt.x), int(pt.y))


def pk_from_numpy(fixed_coeffs, layout, vk, srs: SRS) -> ProvingKey:
    """A port ProvingKey from a JAX key's parts: `fixed_coeffs` maps each
    fixed column name to its [n, 16] Montgomery coefficients as numpy
    (any unsigned width; uint16 is the JAX at-rest form), or is the JAX
    key's `LazyFixedCoeffs`; `layout` and `vk` are the JAX host objects.
    Tensors land on the device of `srs`, in the port's at-rest form."""
    dev = srs.g1.x.device
    if isinstance(fixed_coeffs, dict):
        coeffs = {name: pack_poly(torch.from_numpy(
            np.asarray(v).astype(np.int32)).to(dev))
            for name, v in fixed_coeffs.items()}
    else:
        # the JAX provider holds the attributes a Layout gives the port's
        coeffs = LazyFixedCoeffs(fixed_coeffs, fixed_coeffs.k, dev)
    lay = Layout(**{f.name: getattr(layout, f.name)
                    for f in dataclasses.fields(Layout)})
    fields = {f.name: getattr(vk, f.name)
              for f in dataclasses.fields(VerifyingKey)}
    fields["commitments"] = {k: _affine(p) for k, p in vk.commitments.items()}
    return ProvingKey(vk=VerifyingKey(**fields), layout=lay, srs=srs,
                      fixed_coeffs=coeffs)
