"""The port's field layer (zksnap_tpu_torch.fields) against the JAX package.

Every operation of the port's `PrimeField`, and the plain versions of
kernels K1 (Montgomery multiply) and K2 (modular add / sub) that its CPU
tensors run, is held to `zksnap_tpu.fields.field` and to the Pallas
kernels `mont_mul_batch` / `mont_addsub_batch` (interpret mode on the
CPU, as tests/test_pallas_kernels.py runs them) on the same inputs, for
all four moduli.  Tolerance: none -- integers, compared mod p.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksnap_tpu.fields import common as jcommon
from zksnap_tpu.fields import field as jfield
from zksnap_tpu.fields.pallas_mont import mont_addsub_batch, mont_mul_batch
from zksnap_tpu_torch.fields import common as tcommon
from zksnap_tpu_torch.fields import field as tfield
from zksnap_tpu_torch.fields import pallas_mont as tpm

torch.set_num_threads(1)
DEV = "cpu"

FIELDS = ["bn254_fr", "bn254_fq", "secp256k1_fp", "secp256k1_fq"]


def _pair(name):
    return getattr(tfield, name)(), getattr(jfield, name)()


def _t(x) -> torch.Tensor:
    """JAX or numpy limbs -> the port's int32 tensor."""
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def _j(t: torch.Tensor):
    """The port's int32 tensor -> JAX uint32 limbs."""
    return jnp.asarray(t.numpy().astype(np.uint32))


def _values(p: int, rng: random.Random, n: int = 24):
    edge = [0, 1, p - 1, p - 2, 2]
    return edge + [rng.randrange(p) for _ in range(n - len(edge))]


@pytest.mark.parametrize("name", FIELDS)
def test_field_ops_match_jax(name):
    TF, JF = _pair(name)
    assert (TF.p, TF.R, TF.n0, TF.generator, TF.two_adicity) == (
        JF.p, JF.R, JF.n0, JF.generator, JF.two_adicity)
    rng = random.Random(1)
    p = TF.p
    xs = _values(p, rng)
    ys = list(reversed(_values(p, rng)))
    ta, tb = TF.to_mont(xs, DEV), TF.to_mont(ys, DEV)
    ja, jb = JF.to_mont(xs), JF.to_mont(ys)
    assert np.array_equal(ta.numpy(), np.asarray(ja).astype(np.int32))

    cases = {
        "mul": (TF.mul(ta, tb), JF.mul(ja, jb),
                [x * y % p for x, y in zip(xs, ys)]),
        "add": (TF.add(ta, tb), JF.add(ja, jb),
                [(x + y) % p for x, y in zip(xs, ys)]),
        "sub": (TF.sub(ta, tb), JF.sub(ja, jb),
                [(x - y) % p for x, y in zip(xs, ys)]),
        "neg": (TF.neg(ta), JF.neg(ja), [-x % p for x in xs]),
        "square": (TF.square(ta), JF.square(ja), [x * x % p for x in xs]),
        "canon": (TF.canon(ta), JF.canon(ja), xs),
    }
    for op, (got, ref, want) in cases.items():
        assert TF.from_mont(got) == JF.from_mont(ref) == want, op
        assert int(got.max()) <= 0xFFFF and int(got.min()) >= 0, op
    assert TF.from_mont(TF.pow_const(ta, 65537)) == [
        pow(x, 65537, p) for x in xs]
    # the results are canonical: bit-equal to the oracle's limbs
    assert np.array_equal(TF.mul(ta, tb).numpy(),
                          TF.to_mont(cases["mul"][2], DEV).numpy())
    narrow = TF.mont_reduce_narrow(ta)
    assert tcommon.limbs_to_ints(narrow) == xs
    assert tcommon.limbs_to_ints(narrow) == jcommon.limbs_to_ints(
        JF.mont_reduce_narrow(ja))


@pytest.mark.parametrize("name", FIELDS)
def test_inverses_match_jax(name):
    """inv and batch_inv (zeros map to zeros) against the oracle; the
    JAX package's batch_inv takes seconds to compile per modulus, so it
    is held to the port's on the prover's field, BN254 Fr."""
    TF, JF = _pair(name)
    rng = random.Random(2)
    p = TF.p
    for n in (1, 37):
        xs = [rng.randrange(1, p) for _ in range(n)]
        for i in range(0, n, 4):
            xs[i] = 0
        ta = TF.to_mont(xs, DEV)
        want = [pow(x, -1, p) if x else 0 for x in xs]
        got = TF.batch_inv(ta)
        assert TF.from_mont(got) == want
    assert TF.from_mont(TF.inv(ta[:5])) == want[:5]
    if name == "bn254_fr":
        assert np.array_equal(
            got.numpy(), _t(JF.batch_inv(JF.to_mont(xs))).numpy())


@pytest.mark.parametrize("name", FIELDS)
def test_kernels_match_pallas_interpret(name):
    """K1 / K2 (their plain versions on a CPU tensor) against the Pallas
    kernels, bit for bit: both return canonical values.  The interpreted
    multiply takes some ten seconds a call, so it runs on the two moduli
    tests/test_pallas_kernels.py covers: BN254 Fr and secp256k1 Fp, whose
    REDC needs the carry past 2^256."""
    TF, JF = _pair(name)
    rng = random.Random(3)
    xs = _values(TF.p, rng)
    ys = _values(TF.p, rng)
    ta, tb = TF.to_mont(xs, DEV), TF.to_mont(ys, DEV)
    ja, jb = _j(ta), _j(tb)
    if name in ("bn254_fr", "secp256k1_fp"):
        assert np.array_equal(
            tpm.mont_mul(ta, tb, TF.p).numpy(),
            _t(mont_mul_batch(ja, jb, JF.p, JF.n0)).numpy())
    for mode in ("add", "sub"):
        assert np.array_equal(
            tpm.mont_addsub(ta, tb, TF.p, mode).numpy(),
            _t(mont_addsub_batch(ja, jb, JF.p, mode)).numpy()), mode


def test_broadcasting_matches_jax():
    """Broadcast operands, as `FR.mul(total, y[None, :])` in the prover
    and tests/test_pallas_kernels.py's test_pallas_broadcast use them."""
    TF, JF = _pair("bn254_fr")
    rng = random.Random(4)
    xs = [rng.randrange(TF.p) for _ in range(24)]
    y = rng.randrange(TF.p)
    a = TF.to_mont(xs, DEV).reshape(3, 8, 16)
    row = TF.to_mont(xs[:8], DEV)                # [8, 16]
    one = TF.to_mont(y, DEV)                     # [16]
    for u, v in [(a, one), (one[None], a), (a, row), (row[:, None], row)]:
        for op in ("mul", "sub"):
            got = getattr(TF, op)(u, v)
            ref = getattr(JF, op)(_j(u), _j(v))
            assert got.shape == tuple(ref.shape), op
            assert TF.from_mont(got.reshape(-1, 16)) == JF.from_mont(
                ref.reshape(-1, 16)), op
    assert TF.from_mont(TF.mul(a, one).reshape(-1, 16)) == [
        x * y % TF.p for x in xs]


@pytest.mark.parametrize("name", ["bn254_fr", "secp256k1_fp"])
def test_redc_matches_jax(name):
    """REDC of the JAX package's wide product columns."""
    TF, JF = _pair(name)
    rng = random.Random(5)
    xs, ys = _values(TF.p, rng), _values(TF.p, rng)
    cols = jcommon.mul_wide(JF.to_mont(xs), JF.to_mont(ys))
    got = TF.mont_redc(torch.from_numpy(np.asarray(cols).astype(np.int64)))
    assert TF.from_mont(got) == [x * y % TF.p for x, y in zip(xs, ys)]
    assert np.array_equal(got.numpy(), _t(JF.mont_redc(cols)).numpy())


def test_limb_helpers_match_jax():
    rng = random.Random(6)
    xs = [0, 1, (1 << 256) - 1] + [rng.randrange(1 << 256) for _ in range(9)]
    p = tfield.SECP_P
    assert np.array_equal(tcommon.ints_to_limbs(xs),
                          jcommon.ints_to_limbs(xs).astype(np.int32))
    assert np.array_equal(tcommon.ints_to_limbs_fast(xs, p),
                          jcommon.ints_to_limbs_fast(xs, p).astype(np.int32))
    for x in xs[:4]:
        assert np.array_equal(tcommon.int_to_limbs(x),
                              jcommon.int_to_limbs(x).astype(np.int32))
    arr = torch.from_numpy(tcommon.ints_to_limbs(xs))
    assert tcommon.limbs_to_ints(arr) == xs == jcommon.limbs_to_ints(
        jcommon.ints_to_limbs(xs))
    assert tcommon.limbs_to_int(arr[5]) == xs[5]


def test_wrappers_dispatch_on_device():
    """A CPU tensor runs the plain version and launches nothing; a tensor
    on any other device than the CPU or a GPU, or operands on two
    devices, raise."""
    F = tfield.bn254_fr()
    a = F.to_mont([3, 4], DEV)
    before = (tpm.mont_mul.launches, tpm.mont_addsub.launches)
    F.mul(a, a)
    F.add(a, a)
    assert (tpm.mont_mul.launches, tpm.mont_addsub.launches) == before
    meta = torch.empty((2, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tpm.mont_mul(meta, meta, F.p)
    with pytest.raises(ValueError):
        tpm.mont_addsub(a, meta, F.p, "add")
