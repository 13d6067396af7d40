"""The port's batched Jacobian point kernels K7 and K8
(zksnap_tpu_torch.curves.pallas_point) against the JAX package.

The JAX functions (zksnap_tpu/curves/pallas_point.py) run only as Pallas
kernels, minutes of CPU in interpret mode, so their outputs on a seeded
batch of 8 BN254 G1 points with the edge cases (P = inf, Q = inf, both inf,
P = Q, P = -Q) are frozen in tests/vectors/torch_port_v1.json
(`scripts/gen_torch_port_vectors.py pallas_point`).  Here the port's entry
points run their plain versions on the CPU: they must give the frozen
canonical integers, the staged add must equal the fused one, and both
must agree with the python-int oracle on more points.  Tolerance: none --
integers.
"""

import json
import os
import random

import pytest
import torch

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


ENTRY = {
    "add": lambda p, q: pp.point_add_batch(p, q, F.p, F.n0),
    "staged": lambda p, q: pp.point_add_staged(p, q, F.p, F.n0),
    "dbl": lambda p, q: pp.point_dbl_batch(p, F.p, F.n0),
}


@pytest.mark.parametrize("name", sorted(ENTRY))
def test_matches_frozen_jax(name):
    """Each entry point gives the JAX kernel's canonical output, the edge
    rows included."""
    v = _frozen()
    assert v["field"] == "bn254_fq" and v["n"] == len(v["inputs"]) == 8
    p, q = _coords(v["inputs"])
    assert _ints(ENTRY[name](p, q)) == v[name]


def _oracle_rows(rng, n):
    """n random (P, Q) Jacobian pairs with the edge cases first, and the
    host points they encode."""
    g = AffinePoint.generator(BN254_G1)
    pool = [rng.randrange(1, BN254_G1.n) * g for _ in range(5)]
    ident = AffinePoint.identity(BN254_G1)
    pairs = [(ident, pool[0]), (pool[1], ident), (ident, ident),
             (pool[2], pool[2]), (pool[3], -pool[3])]
    while len(pairs) < n:
        pairs.append((rng.choice(pool), rng.choice(pool)))
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
    rows, pairs = _oracle_rows(random.Random(31), 24)
    p, q = _coords(rows)
    fused = pp.point_add_batch(p, q, F.p, F.n0)
    staged = pp.point_add_staged(p, q, F.p, F.n0)
    for a, b in zip(fused, staged):
        assert torch.equal(a, b)
    assert _affine(fused) == [a + b for a, b in pairs]
    dbl = pp.point_dbl_batch(p, F.p, F.n0)
    assert _affine(dbl) == [a + a for a, _ in pairs]


def test_batch_shape_and_cpu_dispatch():
    """[..., 16] batches keep their shape; a CPU tensor runs the plain
    version and launches nothing."""
    rows, pairs = _oracle_rows(random.Random(32), 6)
    p, q = _coords(rows)
    p3 = tuple(c.reshape(2, 3, 16) for c in p)
    q3 = tuple(c.reshape(2, 3, 16) for c in q)
    counts = (pp.point_add_batch.launches, pp.point_dbl_batch.launches,
              pp.point_add_staged.launches)
    for fn in (lambda: pp.point_add_batch(p3, q3, F.p, F.n0),
               lambda: pp.point_add_staged(p3, q3, F.p, F.n0),
               lambda: pp.point_dbl_batch(p3, F.p, F.n0)):
        out = fn()
        assert all(c.shape == (2, 3, 16) and c.dtype == torch.int32
                   for c in out)
    assert (pp.point_add_batch.launches, pp.point_dbl_batch.launches,
            pp.point_add_staged.launches) == counts
    flat = pp.point_add_batch(p, q, F.p, F.n0)
    got = pp.point_add_batch(p3, q3, F.p, F.n0)
    for a, b in zip(flat, got):
        assert torch.equal(a, b.reshape(6, 16))


def test_bad_arguments_raise():
    rows, _ = _oracle_rows(random.Random(33), 6)
    p, q = _coords(rows)
    with pytest.raises(ValueError, match="n0"):
        pp.point_add_batch(p, q, F.p, F.n0 ^ 1)
    with pytest.raises(ValueError, match="n0"):
        pp.point_dbl_batch(p, F.p, 0)
    with pytest.raises(ValueError):
        pp.point_add_staged(p, tuple(c[:3] for c in q), F.p, F.n0)
