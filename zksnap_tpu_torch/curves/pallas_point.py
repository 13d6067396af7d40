"""Batched Jacobian point add and double: kernels K8 and K7 (PyTorch port
of zksnap_tpu/curves/pallas_point.py).

`point_add_batch(p, q, p_int, n0)` and `point_dbl_batch(p, p_int, n0)`
run the complete Jacobian add (add-2007-bl with the doubling fallback and
identity selects) and dbl-2009-l, one point per element (kernel K8).
`point_add_staged(p, q, p_int, n0)` computes the same add (kernel K7).
The TPU splits it into three launches (stage A's cross products, K8's
dbl, stage B's combine and selects) only to keep each kernel body inside
Mosaic's size budget; the split computes nothing of its own.  On the H100
all three entry points launch K3's point kernel (curves/fused.py `point`,
csrc/point.cu), whose Jacobian `add` and `dbl` kinds have these bodies:
the inlined formulas of csrc/point_inline.cuh, one thread a point, the
doubling fallback only in the blocks that need it.  K7 is one launch of
that add.

Coordinates are tuples (x, y, z) of [..., 16] int32 Montgomery limb
tensors of one shape (z == 0 is the identity); the results are canonical.
The JAX functions' `block` and `interpret` arguments describe the TPU's
tiling and its CPU emulation, and are dropped: the kernel takes the
port's [n, 16] rows as they are.  The kernel's 32-bit Montgomery constant
comes from `p_int` (as K1's does); the JAX package's 16-bit `n0` is still
taken and must be -p^-1 mod 2^16.

Each entry point dispatches on the tensors' device through `point`: a
CUDA tensor launches the kernel or raises, a CPU tensor runs the plain
version, curves/fused.py's plain Jacobian `add` and `dbl` bodies (the
TPU kernels use the formulas and selects of the JAX fused.py bodies,
which those bodies translate; the tests hold them to the JAX outputs).
K7's plain version is K8's add: the staged split does not change the
value.  `.launches` on each entry point counts the kernel launches made
for it, one a call on the card; `point.launches` counts them too.
"""

from __future__ import annotations

from ..fields.common import LIMB_BITS, N_LIMBS
from . import fused


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


def point_add_batch_plain(p_coords, q_coords, p_int: int, n0: int):
    """The plain PyTorch version of K8's add (any device)."""
    coords = list(p_coords) + list(q_coords)
    _check(coords, p_int, n0)
    return fused.point_plain("add", coords, p_int)


def point_dbl_batch_plain(p_coords, p_int: int, n0: int):
    """The plain PyTorch version of K8's dbl (any device)."""
    _check(list(p_coords), p_int, n0)
    return fused.point_plain("dbl", list(p_coords), p_int)


def _point(entry, kind: str, coords, p_int: int, n0: int):
    """K3's Jacobian `kind` over `coords` for the entry point `entry`,
    whose count takes the launches that `point` made."""
    _check(coords, p_int, n0)
    before = fused.point.launches
    out = fused.point(kind, coords, p_int)
    entry.launches += fused.point.launches - before
    return out


def point_add_batch(p_coords, q_coords, p_int: int, n0: int):
    """P + Q, complete, over (x, y, z) coordinate tensors (kernel K8)."""
    return _point(point_add_batch, "add", list(p_coords) + list(q_coords),
                  p_int, n0)


point_add_batch.launches = 0


def point_dbl_batch(p_coords, p_int: int, n0: int):
    """2P over (x, y, z) coordinate tensors (kernel K8)."""
    return _point(point_dbl_batch, "dbl", list(p_coords), p_int, n0)


point_dbl_batch.launches = 0


def point_add_staged(p_coords, q_coords, p_int: int, n0: int):
    """P + Q, complete (kernel K7): on the TPU three staged launches, here
    one launch of the same fused add as `point_add_batch`."""
    return _point(point_add_staged, "add", list(p_coords) + list(q_coords),
                  p_int, n0)


point_add_staged.launches = 0
