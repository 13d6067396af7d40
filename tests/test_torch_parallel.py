"""The port's mesh layer against the JAX package, on virtual CPU meshes.

A virtual mesh names the CPU device several times (`make_mesh` over
`[torch.device("cpu")] * 8`), the counterpart of the 8 virtual CPU
devices of tests/conftest.py.  Held here: the four-step layout
permutations (equal to the JAX ones), `four_step_ntt` (its output equal
to the frozen JAX one, tests/vectors/torch_port_v1.json part `four_step`,
and after the output permutation to the port's single-device NTT),
`sharded_msm` on tests/test_sharded.py's inputs (the host oracle), the
prover's sharded commit and NTTs under `prover_mesh` (their single-device
results) with `_mesh_for`'s refusals, `protocol_mesh`, `initialize` (none
without configuration; a 2-process gloo group from the env contract),
the scaling harness, `warm_prove`'s task names (the JAX package's), and
the kernel wrappers' device check.  Tolerance: none -- integers, bytes,
or points compared as affine points.
"""

import ast
import hashlib
import json
import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from zksnap_tpu.poly.ntt import four_step_input_perm as jax_input_perm
from zksnap_tpu.poly.ntt import four_step_output_perm as jax_output_perm
from zksnap_tpu_torch import kernels
from zksnap_tpu_torch.curves.jacobian import JacPoint, bn254_ops
from zksnap_tpu_torch.curves.native import (BN254_G1, AffinePoint,
                                            bn254_generator)
from zksnap_tpu_torch.fields.common import ints_to_limbs
from zksnap_tpu_torch.fields.field import bn254_fr
from zksnap_tpu_torch.parallel import (chip_submesh, initialize, make_mesh,
                                       protocol_mesh, scaling_efficiency,
                                       sharded_msm)
from zksnap_tpu_torch.poly.domain import domain
from zksnap_tpu_torch.poly.ntt import (_ntt_impl, four_step_input_perm,
                                       four_step_ntt, four_step_output_perm)
from zksnap_tpu_torch.prover import poly_device as pd
from zksnap_tpu_torch.prover.warmup import warm_prove

torch.set_num_threads(1)

DEV = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = bn254_fr()


def cpu_mesh(ndev: int):
    return make_mesh((ndev,), ("x",), [torch.device(DEV)] * ndev)


def affine(ops, pt):
    return ops.to_affine_host(JacPoint(pt.x[None], pt.y[None],
                                       pt.z[None]))[0]


@pytest.mark.parametrize("k,ndev", [(4, 2), (6, 4), (6, 8), (9, 2), (9, 4),
                                    (9, 8), (12, 16)])
def test_four_step_perms_match_jax(k, ndev):
    """Exact: the index arrays are the JAX package's."""
    assert np.array_equal(four_step_input_perm(k, ndev),
                          jax_input_perm(k, ndev))
    assert np.array_equal(four_step_output_perm(k, ndev),
                          jax_output_perm(k, ndev))


@pytest.mark.parametrize("inverse", [False, True],
                         ids=["forward", "inverse"])
@pytest.mark.parametrize("ndev", [2, 4])
def test_four_step_ntt_matches_jax_and_single(ndev, inverse):
    """Exact: the raw output's limbs hash to the frozen JAX output's, and
    in natural order they are the single-device NTT's (the inverse before
    its n^-1 scale, as four_step_ntt leaves it)."""
    with open(os.path.join(ROOT, "tests", "vectors",
                           "torch_port_v1.json")) as f:
        v = json.load(f)["four_step"]
    k = v["k"]
    rng = random.Random(v["seed"])
    x = F.to_mont([rng.randrange(F.p) for _ in range(1 << k)], device=DEV)
    inp = torch.from_numpy(four_step_input_perm(k, ndev))
    y = four_step_ntt(x[inp], k, cpu_mesh(ndev), inverse=inverse)
    digest = hashlib.sha256(y.numpy().astype("<u4").tobytes()).hexdigest()
    assert digest == v["sha256"][f"{ndev}_{'inverse' if inverse else 'forward'}"]
    dom = domain(k)
    tw = dom.twiddles_inv(DEV) if inverse else dom.twiddles(DEV)
    natural = y[torch.from_numpy(four_step_output_perm(k, ndev))]
    assert torch.equal(natural, _ntt_impl(x, tw, k, F))


def test_batched_ntt_is_a_row_of_single_ntts():
    """Exact: `_ntt_impl` over a [b, n, 16] batch transforms each row as
    the unbatched call does (the four-step NTT's length-n1 transforms)."""
    rng = random.Random(7)
    k = 3
    x = F.to_mont([rng.randrange(F.p) for _ in range(5 << k)],
                  device=DEV).reshape(5, 1 << k, 16)
    tw = domain(k).twiddles(DEV)
    got = _ntt_impl(x, tw, k, F)
    for i in range(5):
        assert torch.equal(got[i], _ntt_impl(x[i], tw, k, F))


def test_sharded_msm_matches_oracle():
    """tests/test_sharded.py's inputs (n = 64, c = 6, a mesh of 8): the
    sharded MSM equals the host oracle's sum, as an affine point."""
    rng = random.Random(20260817)  # tests/conftest.py's `rng`
    ops = bn254_ops()
    g = bn254_generator()
    n = 64
    pts = [rng.randrange(1, BN254_G1.n) * g for _ in range(n)]
    scalars = [rng.randrange(BN254_G1.n) for _ in range(n)]
    want = AffinePoint.identity(BN254_G1)
    for k, p in zip(scalars, pts):
        want = want + k * p
    P = ops.from_affine_host(pts, device=DEV)
    out = sharded_msm(ops, P, torch.from_numpy(ints_to_limbs(scalars)),
                      cpu_mesh(8), c=6)
    assert out.x.device == torch.device(DEV)
    assert affine(ops, out) == want


def test_protocol_mesh_and_scaling_harness(monkeypatch):
    """tests/test_sharded.py's harness check: the ("host", "chip") mesh
    folds 8 devices at 4 a host, `initialize()` is False with no
    configuration, the scaling harness returns sane rows for 1, 2 and 4
    shards, and the chip submesh drives the sharded MSM.  The scalars
    are below 2^8, so the MSM takes `scalar_bits=8` (two windows)."""
    for var in ("ZKSNAP_COORDINATOR", "ZKSNAP_NUM_PROCESSES",
                "ZKSNAP_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize(device=DEV) is False
    assert not torch.distributed.is_initialized()
    pm = protocol_mesh(chips_per_host=4, devices=[torch.device(DEV)] * 8)
    assert pm.n_hosts == 2 and pm.chips_per_host == 4
    assert pm.mesh.shape == {"host": 2, "chip": 4}

    ops = bn254_ops()
    n = 32
    g = bn254_generator()
    pts = [((i % 7) + 1) * g for i in range(n)]
    scalars = [2 * i + 1 for i in range(n)]
    want = AffinePoint.identity(BN254_G1)
    for k, p in zip(scalars, pts):
        want = want + k * p
    P = ops.from_affine_host(pts, device=DEV)
    s = torch.from_numpy(ints_to_limbs(scalars))
    results = []

    def work(nc, mesh):
        out = sharded_msm(ops, P, s, mesh, c=6, scalar_bits=8)
        results.append(affine(ops, out))

    rows = scaling_efficiency(work, [1, 2, 4], cpu_mesh)
    assert [r["n"] for r in rows] == [1, 2, 4]
    assert all(r["seconds"] >= 0 for r in rows)
    assert rows[0]["speedup"] == 1.0 and rows[0]["efficiency"] == 1.0
    assert all(pt == want for pt in results) and len(results) == 6

    sub = chip_submesh(pm)
    assert sub.shape == {"x": 8}
    work(8, sub)
    assert results[-1] == want


def test_mesh_for_refusals():
    """`_mesh_for` shards only when ndev > 1, ndev divides n and
    n >= ndev^2, as the JAX package's does."""
    assert pd._mesh_for(128) is None
    for ndev, n in ((1, 128), (3, 128), (16, 128), (4, 8)):
        with pd.prover_mesh(cpu_mesh(ndev)):
            assert pd._mesh_for(n) is None, (ndev, n)
    mesh = cpu_mesh(8)
    with pd.prover_mesh(mesh):
        assert pd._mesh_for(128) == (mesh, "x")
        with pd.prover_mesh(cpu_mesh(3)):
            assert pd._mesh_for(128) is None
        assert pd._mesh_for(64) == (mesh, "x")
    assert pd._mesh_for(128) is None


def test_prover_mesh_commit_and_ntts():
    """At K=7 (n = 128): under `prover_mesh` the commit (a mesh of 2, over
    128 seeded multiples of the generator standing in for an SRS) equals
    the single-device commit as an affine point, and `evals_to_coeffs`,
    `coeffs_to_evals` and `coset_evals` (a mesh of 8) equal the
    single-device results exactly, on the device of their inputs; the
    int16 at-rest form goes in as well."""
    k, n = 7, 128
    rng = random.Random(11)
    ops = bn254_ops()
    g = bn254_generator()
    basis = ops.from_affine_host(
        [rng.randrange(1, BN254_G1.n) * g for _ in range(n)], device=DEV)
    x = F.to_mont([rng.randrange(F.p) for _ in range(n)], device=DEV)
    s_pows = pd.pow_series_uncached(rng.randrange(F.p), n, DEV)
    scalars = pd.mont_to_canonical(x)
    want_c = affine(ops, pd.commit_evals(basis, scalars))
    want = [pd.evals_to_coeffs(x, k), pd.coeffs_to_evals(x, k),
            pd.coset_evals(pd.pack_poly(x), s_pows, k)]
    with pd.prover_mesh(cpu_mesh(2)):
        assert affine(ops, pd.commit_evals(basis, scalars)) == want_c
    with pd.prover_mesh(cpu_mesh(8)):
        got = [pd.evals_to_coeffs(x, k), pd.coeffs_to_evals(x, k),
               pd.coset_evals(pd.pack_poly(x), s_pows, k)]
    for g_, w_ in zip(got, want):
        assert g_.device == x.device
        assert torch.equal(g_, w_)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_GLOO_RANK = r"""
import sys, torch
import torch.distributed as dist
torch.set_num_threads(1)
from zksnap_tpu_torch.parallel import initialize
assert initialize(device="cpu") is True
rank, world = dist.get_rank(), dist.get_world_size()
t = torch.tensor([rank + 1])
dist.all_reduce(t)
parts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
dist.all_gather(parts, torch.tensor([10 * rank]))
dist.destroy_process_group()
print("rank", rank, "of", world, int(t), [int(p) for p in parts])
"""


def test_initialize_gloo_two_processes():
    """Two processes with the env contract (ZKSNAP_COORDINATOR,
    ZKSNAP_NUM_PROCESSES, ZKSNAP_PROCESS_ID) join one gloo group through
    `initialize(device="cpu")` and reduce and gather over it."""
    port = _free_port()
    env = dict(os.environ, ZKSNAP_COORDINATOR=f"localhost:{port}",
               ZKSNAP_NUM_PROCESSES="2", OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_RANK], cwd=ROOT,
                              env=dict(env, ZKSNAP_PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(out.strip())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert outs == ["rank 0 of 2 3 [0, 10]", "rank 1 of 2 3 [0, 10]"]


def _jax_warm_tasks() -> list:
    """The task names of zksnap_tpu/prover/warmup.py's `warm_prove`, read
    from its `tasks = [(name, fn), ...]` list."""
    with open(os.path.join(ROOT, "zksnap_tpu", "prover", "warmup.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "tasks"):
            return [elt.elts[0].value for elt in node.value.elts]
    raise AssertionError("no tasks list in the JAX warm_prove")


def test_warm_prove_task_names():
    """`warm_prove` at K=7 runs and times every task the JAX one names."""
    times = warm_prove(chip_smoke.build_fixed_circuit(), 7, device=DEV)
    assert sorted(times) == sorted(_jax_warm_tasks())
    assert len(_jax_warm_tasks()) == 11
    assert all(t >= 0 for t in times.values())


def test_on_device_refuses_cpu_and_mixed_devices():
    """The kernel wrappers' launch context takes the operands of one CUDA
    device only: CPU operands and operands on two devices raise."""
    cpu = torch.zeros(16, dtype=torch.int32)
    meta = torch.empty(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2 devices"):
        with kernels.on_device(cpu, meta):
            pass
    with pytest.raises(ValueError, match="CUDA"):
        with kernels.on_device(cpu, cpu):
            pass
