"""The port's `poly_device` functions that the prover does not call --
`coset_extended_evals`, `coset_interpolate` (with its sharded branch),
`pow_series_traced`, `batch_eval` and `rlc` -- against the JAX
package's (zksnap_tpu/prover/poly_device.py) on the same seeded inputs
at K = 7, with the extended domain at ext_log 2 and 3.

The JAX NTTs and the barycentric sum cost 10-30 s of XLA compile each,
or minutes eagerly, so their outputs are frozen (`poly_extra`,
scripts/gen_torch_port_vectors.py: the sha256 of the output limbs, the
evaluations' integers), and so are `pow_series_traced`'s and `rlc`'s,
which take 10-20 s eagerly.  The port's functions run the plain versions
of K1 and K2 (CPU tensors).  Tolerance: none -- the same canonical limbs
or integers.
"""

import hashlib
import json
import os
import random
import sys

import numpy as np
import pytest
import torch

from zksnap_tpu_torch.fields import bn254_fr
from zksnap_tpu_torch.parallel import make_mesh
from zksnap_tpu_torch.prover import poly_device as pd

torch.set_num_threads(1)
DEV = "cpu"
K = 7
FR = bn254_fr()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def frozen():
    """The frozen JAX outputs and the seeded inputs they were made from
    (scripts/gen_torch_port_vectors.py `poly_extra_inputs`)."""
    with open(os.path.join(ROOT, "tests", "vectors",
                           "torch_port_v1.json")) as f:
        v = json.load(f)["poly_extra"]
    assert v["k"] == K
    rng = random.Random(v["seed"])
    n = 1 << K
    inp = {"ext": {e: [rng.randrange(FR.p) for _ in range(n)]
                   for e in (2, 3)},
           "polys": [[rng.randrange(FR.p) for _ in range(n)]
                     for _ in range(3)],
           "x": rng.randrange(FR.p),
           "coefs": [rng.randrange(FR.p) for _ in range(3)],
           "base": rng.randrange(FR.p)}
    inp["polys"] = FR.to_mont([x for r in inp["polys"] for x in r],
                              DEV).reshape(3, n, 16)
    return v, inp


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        t.numpy(), dtype="<u4").tobytes()).hexdigest()


@pytest.mark.parametrize("ext_log", [2, 3])
def test_coset_extended_evals_and_interpolate(frozen, ext_log):
    """coset_extended_evals and coset_interpolate give the JAX limbs; the
    round trip gives the zero-padded coefficients."""
    v, inp = frozen
    vals = FR.to_mont(inp["ext"][ext_log], DEV)
    ext = pd.coset_extended_evals(vals, K, ext_log)
    back = pd.coset_interpolate(ext, K, ext_log)
    assert ext.shape == (1 << (K + ext_log), 16)
    assert _sha(ext) == v[f"coset_extended_evals_{ext_log}"]
    assert _sha(back) == v[f"coset_interpolate_{ext_log}"]
    assert torch.equal(back[: 1 << K], pd.evals_to_coeffs(vals, K))
    assert not back[1 << K:].any()


@pytest.mark.parametrize("ndev", [2, 4])
def test_coset_interpolate_sharded(ndev):
    """Under `prover_mesh` (a CPU mesh naming the CPU ndev times) the
    interpolation runs the four-step iNTT and gives the one device's
    limbs."""
    ext_log = 3
    rng = random.Random(43)
    vals = FR.to_mont([rng.randrange(FR.p) for _ in range(1 << K)], DEV)
    ext = pd.coset_extended_evals(vals, K, ext_log)
    one = pd.coset_interpolate(ext, K, ext_log)
    mesh = make_mesh((ndev,), ("x",), [torch.device(DEV)] * ndev)
    with pd.prover_mesh(mesh):
        assert pd._mesh_for(1 << (K + ext_log)) is not None
        got = pd.coset_interpolate(ext, K, ext_log)
    assert torch.equal(got, one)


@pytest.mark.parametrize("n", [1, 2, 5, 128])
def test_pow_series_traced(frozen, n):
    v, inp = frozen
    got = pd.pow_series_traced(FR.const_t(inp["base"], DEV), n)
    assert got.shape == (n, 16)
    assert _sha(got) == v[f"pow_series_traced_{n}"]
    assert FR.from_mont(got.reshape(n, 16)) == [pow(inp["base"], i, FR.p)
                                                 for i in range(n)]


def test_batch_eval(frozen):
    """Barycentric evaluation of evaluation-form polys at a point off
    the domain: the JAX integers, and the coefficient form's values."""
    v, inp = frozen
    got = pd.batch_eval(inp["polys"], inp["x"], K)
    assert [str(x) for x in got] == v["batch_eval"]
    coeffs = [pd.evals_to_coeffs(p, K) for p in inp["polys"]]
    assert got == pd.eval_coeffs_list(coeffs, inp["x"], K)


def test_rlc(frozen):
    """The JAX limbs, and those of `rlc_list` over the same polys."""
    v, inp = frozen
    got = pd.rlc(inp["polys"], inp["coefs"], K)
    assert _sha(got) == v["rlc"]
    assert torch.equal(got, pd.rlc_list(list(inp["polys"]), inp["coefs"], K))


@pytest.mark.slow
def test_poly_extra_vectors_are_live_jax():
    """The frozen outputs are what the JAX functions give now."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import gen_torch_port_vectors as gen

    v = json.load(open(os.path.join(ROOT, "tests", "vectors",
                                    "torch_port_v1.json")))["poly_extra"]
    assert gen.part_poly_extra()["poly_extra"] == v


def test_chip_smoke_plain_path_swap():
    """chip_smoke.py holds the five functions on the card to their plain
    path by swapping K1's and K2's wrappers for their plain versions
    inside fields/field.py: the swap gives the same limbs and is undone
    on leaving."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from zksnap_tpu_torch.fields import field

    fns, _, _ = chip_smoke.poly_five(4, torch.device(DEV), 7)
    want = {name: fn() for name, fn in fns.items()}
    saved = field.mont_mul, field.mont_addsub
    with chip_smoke.plain_field():
        assert field.mont_mul is not saved[0]
        got = {name: fn() for name, fn in fns.items()}
    assert (field.mont_mul, field.mont_addsub) == saved
    assert all(chip_smoke.same_result(got[k], want[k]) for k in want)
