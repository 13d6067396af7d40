"""Mesh-sharded MSM (PyTorch port of zksnap_tpu/parallel/sharded.py).

  * `sharded_msm` -- points and scalars split over the devices of a mesh
    axis; each shard runs a full local Pippenger on its device, the
    partial sums are gathered on the first device of the mesh and
    combined there by a halving tree of group adds.  The exchange is one
    point a shard.
  * the four-step NTT lives in poly/ntt.py.

Each shard's work is issued from this one controller on its own device
(`parallel.Mesh`), so on a mesh of distinct cards the shards' kernels
run side by side, and on a virtual mesh (one card named four times) one
after another through the same kernels.
"""

from __future__ import annotations

import torch

from ..curves.jacobian import CurveOps, JacPoint
from ..msm.pippenger import msm_impl


def shard_partials(ops: CurveOps, shards, scalars, c: int, n_windows: int,
                   window_group: int | None = None) -> list:
    """One local Pippenger a shard: `shards` is a list of (device,
    JacPoint) with the shard's points on its device, `scalars` the
    [n, 16] canonical scalars split evenly among them in order."""
    m = scalars.shape[0] // len(shards)
    signed = n_windows * c > ops.F.bits
    return [msm_impl(ops, pts, scalars[d * m:(d + 1) * m].to(dev), c,
                     n_windows, window_group=window_group, signed=signed)
            for d, (dev, pts) in enumerate(shards)]


def combine_partials(ops: CurveOps, parts: list, device) -> JacPoint:
    """The shards' partial sums gathered on `device` and summed by the
    halving tree of the JAX package (a shard's identity partial takes
    part like any other)."""
    acc = JacPoint(*(torch.stack([getattr(p, a).to(device) for p in parts])
                     for a in ("x", "y", "z")))
    m = len(parts)
    while m > 1:
        half = m // 2
        acc = ops.add(
            JacPoint(acc.x[:half], acc.y[:half], acc.z[:half]),
            JacPoint(acc.x[half:m], acc.y[half:m], acc.z[half:m]),
        )
        m = half
    return JacPoint(acc.x[0], acc.y[0], acc.z[0])


def sharded_msm(ops: CurveOps, pts: JacPoint, scalars, mesh, axis: str = "x",
                c: int = 8, scalar_bits: int | None = None):
    """MSM over a 1-d mesh: local Pippenger + gather + combine.

    pts and scalars must split evenly on their leading axis over the
    mesh size.  Returns a JacPoint on the first device of the mesh.

    `scalar_bits`: a caller-known bound on the scalars' bit length; the
    window count shrinks proportionally.  Defaults to the full field
    width.
    """
    devs = mesh.axis_devices(axis)
    n = scalars.shape[0]
    ndev = len(devs)
    if n % ndev:
        raise ValueError(f"{n} scalars over {ndev} devices")
    bits = scalar_bits or ops.F.bits
    n_windows = -(-bits // c)
    m = n // ndev
    shards = [(dev, JacPoint(*(getattr(pts, a)[d * m:(d + 1) * m].to(dev)
                               for a in ("x", "y", "z"))))
              for d, dev in enumerate(devs)]
    parts = shard_partials(ops, shards, scalars, c, n_windows)
    return combine_partials(ops, parts, devs[0])
