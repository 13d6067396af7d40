"""Batched Jacobian point add and double: kernels K8 and K7 (PyTorch port
of zksnap_tpu/curves/pallas_point.py).

`point_add_batch(p, q, p_int, n0)` and `point_dbl_batch(p, p_int, n0)`
run the complete Jacobian add (add-2007-bl with the doubling fallback and
identity selects) and dbl-2009-l, one point per element (kernel K8,
`jac_add_kernel` / `jac_dbl_kernel` in csrc/pallas_point.cu).
`point_add_staged(p, q, p_int, n0)` computes the same add in three
launches, as the TPU does (kernel K7): stage A writes the six cross
products, K8's dbl kernel doubles P, stage B combines them.

Coordinates are tuples (x, y, z) of [..., 16] int32 Montgomery limb
tensors of one shape (z == 0 is the identity); the results are canonical.
The JAX functions' `block` and `interpret` arguments describe the TPU's
tiling and its CPU emulation, and are dropped: the kernels take the
port's [n, 16] rows as they are.  The kernels' 32-bit Montgomery constant
comes from `p_int` (as K1's does); the JAX package's 16-bit `n0` is still
taken and must be -p^-1 mod 2^16.

Each entry point dispatches on the tensors' device: a CUDA tensor
launches the kernels or raises, a CPU tensor runs the plain version.  The
plain versions are curves/fused.py's plain Jacobian `add` and `dbl`
bodies: the function is the same (the TPU kernels use the formulas and
selects of the JAX fused.py bodies, which those bodies translate), and
the tests hold them to the JAX outputs.  K7's plain version is K8's add:
the staged split does not change the value.  `.launches` on each entry point
counts its own kernels' launches: `point_add_staged` two a call (stages
A and B), its doubling counted by `point_dbl_batch`.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields.common import LIMB_BITS, N_LIMBS
from .fused import _device_of, point_plain


def _check_n0(p_int: int, n0: int):
    want = (-pow(p_int, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
    if int(n0) != want:
        raise ValueError(f"n0 = {n0} is not -p^-1 mod 2^{LIMB_BITS} "
                         f"({want}) for this modulus")


def _check(coords, p_int: int, n0: int):
    """The arguments every entry point takes: n0 against p, coordinates
    [..., 16] of one shape."""
    _check_n0(p_int, n0)
    shape = coords[0].shape
    if any(c.shape != shape for c in coords) or shape[-1:] != (N_LIMBS,):
        raise ValueError("point coordinates must be [..., 16] tensors of one "
                         f"shape, got {[tuple(c.shape) for c in coords]}")


def _rows(coords):
    """Coordinate tensors of one shape -> ([n, 16] contiguous rows, batch
    shape, n)."""
    batch = coords[0].shape[:-1]
    n = 1
    for d in batch:
        n *= int(d)
    return [c.reshape(n, N_LIMBS).contiguous() for c in coords], batch, n


def _empty(n: int, count: int, device):
    return [torch.empty((n, N_LIMBS), dtype=torch.int32, device=device)
            for _ in range(count)]


def _out(rows, batch):
    return tuple(r.reshape(*batch, N_LIMBS) for r in rows)


def point_add_batch_plain(p_coords, q_coords, p_int: int, n0: int):
    """The plain PyTorch version of K8's add (any device)."""
    coords = list(p_coords) + list(q_coords)
    _check(coords, p_int, n0)
    return point_plain("add", coords, p_int)


def point_dbl_batch_plain(p_coords, p_int: int, n0: int):
    """The plain PyTorch version of K8's dbl (any device)."""
    _check(list(p_coords), p_int, n0)
    return point_plain("dbl", list(p_coords), p_int)


def _launch_dbl(ins, n: int, p_int: int):
    from .. import kernels

    outs = _empty(n, 3, ins[0].device)
    with kernels.on_device(*ins, *outs) as stream:
        err = kernels.library().zk_jac_dbl(
            *[kernels.rows(a, n) for a in ins],
            *[kernels.rows(o, n) for o in outs], n, kernels.mod_ptr(p_int),
            stream)
    kernels.check(err, "zk_jac_dbl")
    point_dbl_batch.launches += 1
    return outs


def point_add_batch(p_coords, q_coords, p_int: int, n0: int):
    """P + Q, complete, over (x, y, z) coordinate tensors (kernel K8)."""
    coords = list(p_coords) + list(q_coords)
    if _device_of(coords).type == "cpu":
        return point_add_batch_plain(p_coords, q_coords, p_int, n0)
    from .. import kernels

    _check(coords, p_int, n0)
    ins, batch, n = _rows(coords)
    outs = _empty(n, 3, ins[0].device)
    with kernels.on_device(*ins, *outs) as stream:
        err = kernels.library().zk_jac_add(
            *[kernels.rows(a, n) for a in ins],
            *[kernels.rows(o, n) for o in outs], n, kernels.mod_ptr(p_int),
            stream)
    kernels.check(err, "zk_jac_add")
    point_add_batch.launches += 1
    return _out(outs, batch)


point_add_batch.launches = 0


def point_dbl_batch(p_coords, p_int: int, n0: int):
    """2P over (x, y, z) coordinate tensors (kernel K8)."""
    if _device_of(list(p_coords)).type == "cpu":
        return point_dbl_batch_plain(p_coords, p_int, n0)
    _check(list(p_coords), p_int, n0)
    ins, batch, n = _rows(list(p_coords))
    return _out(_launch_dbl(ins, n, p_int), batch)


point_dbl_batch.launches = 0


def _pointers(tensors, n: int):
    from .. import kernels

    return (ctypes.c_void_p * len(tensors))(
        *[kernels.rows(t, n) for t in tensors])


def point_add_staged(p_coords, q_coords, p_int: int, n0: int):
    """P + Q in three launches: stage A (cross products), K8's dbl of P,
    stage B (combine and selects) (kernel K7)."""
    coords = list(p_coords) + list(q_coords)
    if _device_of(coords).type == "cpu":
        return point_add_batch_plain(p_coords, q_coords, p_int, n0)
    from .. import kernels

    _check(coords, p_int, n0)
    ins, batch, n = _rows(coords)
    lib, mod = kernels.library(), kernels.mod_ptr(p_int)
    cross = _empty(n, 6, ins[0].device)  # u1, u2, s1, s2, z1z1, z2z2
    with kernels.on_device(*ins, *cross) as stream:
        err = lib.zk_staged_add_a(_pointers(ins, n), _pointers(cross, n), n,
                                  mod, stream)
    kernels.check(err, "zk_staged_add_a")
    point_add_staged.launches += 1
    dbl = _launch_dbl(ins[:3], n, p_int)
    outs = _empty(n, 3, ins[0].device)
    with kernels.on_device(*cross, *ins, *dbl, *outs) as stream:
        err = lib.zk_staged_add_b(_pointers(cross + ins + dbl, n),
                                  _pointers(outs, n), n, mod, stream)
    kernels.check(err, "zk_staged_add_b")
    point_add_staged.launches += 1
    return _out(outs, batch)


point_add_staged.launches = 0
