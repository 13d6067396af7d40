"""The port's batched Jacobian point kernels K7 and K8
(zksnap_tpu_torch.curves.pallas_point) against the JAX package.

The JAX functions (zksnap_tpu/curves/pallas_point.py) run only as Pallas
kernels, minutes of CPU in interpret mode, so their outputs on a seeded
batch of 8 BN254 G1 points with the edge cases (P = inf, Q = inf, both inf,
P = Q, P = -Q) are frozen in tests/vectors/torch_port_v1.json
(`scripts/gen_torch_port_vectors.py pallas_point`).  Here the port's entry
points run their plain versions on the CPU: they must give the frozen
canonical integers, the staged add must equal the fused one, and both
must agree with the python-int oracle on more points, with the edge
cases inside every warp's worth of ordinary rows.  All three entry
points reach K3's `point` with its Jacobian kinds, and each counts the
launches made for it.  Tolerance: none -- integers.
"""

import json
import os
import random

import pytest
import torch

from zksnap_tpu_torch.curves import fused
from zksnap_tpu_torch.curves import pallas_point as pp
from zksnap_tpu_torch.curves.native import BN254_G1, AffinePoint
from zksnap_tpu_torch.fields import bn254_fq

torch.set_num_threads(1)
DEV = "cpu"

F = bn254_fq()
VECTORS = os.path.join(os.path.dirname(__file__), "vectors",
                       "torch_port_v1.json")


def _frozen():
    with open(VECTORS) as f:
        return json.load(f)["pallas_point"]


def _coords(rows):
    """[[x1, y1, z1, x2, y2, z2], ...] ints -> (P, Q) Montgomery tensors."""
    cols = [F.to_mont([int(r[i]) for r in rows], DEV) for i in range(6)]
    return tuple(cols[:3]), tuple(cols[3:])


def _ints(out):
    vals = [F.from_mont(c) for c in out]
    return [[str(vals[i][j]) for i in range(3)] for j in range(len(vals[0]))]


# name: (call, the frozen JAX output it must give)
ENTRY = {
    "add": (lambda p, q: pp.point_add_batch(p, q, F.p, F.n0), "add"),
    "staged": (lambda p, q: pp.point_add_staged(p, q, F.p, F.n0), "staged"),
    "dbl": (lambda p, q: pp.point_dbl_batch(p, F.p, F.n0), "dbl"),
    "point_add": (lambda p, q: fused.point("add", list(p) + list(q), F.p),
                  "add"),
}


@pytest.mark.parametrize("name", sorted(ENTRY))
def test_matches_frozen_jax(name):
    """Each entry point, and K3's Jacobian add that they launch, gives the
    JAX kernel's canonical output, the edge rows included."""
    v = _frozen()
    assert v["field"] == "bn254_fq" and v["n"] == len(v["inputs"]) == 8
    p, q = _coords(v["inputs"])
    call, key = ENTRY[name]
    assert _ints(call(p, q)) == v[key]


# rows of half a warp of K3's Jacobian kinds (one thread a point)
MIX_ROWS = 16


def _oracle_rows(rng, n):
    """n random (P, Q) Jacobian pairs (n a multiple of MIX_ROWS), and the
    host points they encode: in every MIX_ROWS rows the edge cases
    (P = inf, Q = inf, both inf, P == Q, P == -Q) sit at random places
    among ordinary pairs."""
    g = AffinePoint.generator(BN254_G1)
    pool = [rng.randrange(1, BN254_G1.n) * g for _ in range(5)]
    ident = AffinePoint.identity(BN254_G1)
    pairs = []
    for _ in range(n // MIX_ROWS):
        warp = [(rng.choice(pool), rng.choice(pool))
                for _ in range(MIX_ROWS)]
        a, b = rng.sample(pool, 2)
        edges = [(ident, a), (b, ident), (ident, ident), (a, a), (b, -b)]
        for slot, pair in zip(rng.sample(range(MIX_ROWS), len(edges)),
                              edges):
            warp[slot] = pair
        pairs += warp
    q = BN254_G1.p

    def enc(pt):
        lam = rng.randrange(1, q)
        l2, l3 = lam * lam % q, lam * lam * lam % q
        if pt.is_identity():
            return [l2, l3, 0]
        return [l2 * pt.x % q, l3 * pt.y % q, lam]

    return [enc(a) + enc(b) for a, b in pairs], pairs


def _affine(out):
    from zksnap_tpu_torch.curves.jacobian import JacPoint, bn254_ops

    return bn254_ops().to_affine_host(JacPoint(*out))


def test_staged_equals_batch_and_oracle():
    rows, pairs = _oracle_rows(random.Random(31), 3 * MIX_ROWS)
    p, q = _coords(rows)
    fused_add = pp.point_add_batch(p, q, F.p, F.n0)
    for other in (pp.point_add_staged(p, q, F.p, F.n0),
                  fused.point("add", list(p) + list(q), F.p)):
        for a, b in zip(fused_add, other):
            assert torch.equal(a, b)
    assert _affine(fused_add) == [a + b for a, b in pairs]
    dbl = pp.point_dbl_batch(p, F.p, F.n0)
    assert _affine(dbl) == [a + a for a, _ in pairs]


def test_entry_points_launch_the_point_kernel(monkeypatch):
    """Each entry point reaches K3's `point` with the Jacobian kind of
    its function, and its count takes the launch `point` made: one a
    call, K7's too."""
    calls = []

    def launching_point(kind, arrays, p, b3=0):
        calls.append((kind, len(arrays), p))
        launching_point.launches += 1
        return fused.point_plain(kind, arrays, p, b3)

    launching_point.launches = 0
    monkeypatch.setattr(fused, "point", launching_point)
    rows, _ = _oracle_rows(random.Random(34), MIX_ROWS)
    p, q = _coords(rows)
    entries = ((pp.point_add_batch, lambda: pp.point_add_batch(
                    p, q, F.p, F.n0), ("add", 6, F.p)),
               (pp.point_dbl_batch, lambda: pp.point_dbl_batch(
                    p, F.p, F.n0), ("dbl", 3, F.p)),
               (pp.point_add_staged, lambda: pp.point_add_staged(
                    p, q, F.p, F.n0), ("add", 6, F.p)))
    for entry, call, want in entries:
        before = entry.launches
        for i in range(2):
            calls.clear()
            out = call()
            assert calls == [want]
            assert entry.launches == before + i + 1
        assert all(c.shape == (MIX_ROWS, 16) for c in out)
    assert launching_point.launches == 6


def test_batch_shape_and_cpu_dispatch():
    """[..., 16] batches keep their shape; a CPU tensor runs the plain
    version and launches nothing."""
    rows, pairs = _oracle_rows(random.Random(32), MIX_ROWS)
    p, q = _coords(rows)
    p3 = tuple(c.reshape(2, 8, 16) for c in p)
    q3 = tuple(c.reshape(2, 8, 16) for c in q)
    counts = (pp.point_add_batch.launches, pp.point_dbl_batch.launches,
              pp.point_add_staged.launches)
    for fn in (lambda: pp.point_add_batch(p3, q3, F.p, F.n0),
               lambda: pp.point_add_staged(p3, q3, F.p, F.n0),
               lambda: pp.point_dbl_batch(p3, F.p, F.n0)):
        out = fn()
        assert all(c.shape == (2, 8, 16) and c.dtype == torch.int32
                   for c in out)
    assert (pp.point_add_batch.launches, pp.point_dbl_batch.launches,
            pp.point_add_staged.launches) == counts
    flat = pp.point_add_batch(p, q, F.p, F.n0)
    got = pp.point_add_batch(p3, q3, F.p, F.n0)
    for a, b in zip(flat, got):
        assert torch.equal(a, b.reshape(MIX_ROWS, 16))


def test_bad_arguments_raise():
    rows, _ = _oracle_rows(random.Random(33), MIX_ROWS)
    p, q = _coords(rows)
    with pytest.raises(ValueError, match="n0"):
        pp.point_add_batch(p, q, F.p, F.n0 ^ 1)
    with pytest.raises(ValueError, match="n0"):
        pp.point_dbl_batch(p, F.p, 0)
    with pytest.raises(ValueError):
        pp.point_add_staged(p, tuple(c[:3] for c in q), F.p, F.n0)
