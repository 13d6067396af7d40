"""The port's experiment modules (zksnap_tpu_torch.experiments) against the
JAX experiment scripts, on the CPU, where every wrapper runs its plain
version.

  K11 (exp_vpu_rates): the live JAX kernels in interpret mode, on the same
      numpy inputs: every chain bit-exact (f32fma's cast too, at a chain
      long enough to reach inf), i8dot bit-exact, bf16dot within
      chip_smoke.BF16_TOL of max |acc| (the f32 sums run in another order);
      chip_smoke's reading of a chain's bound from its compiled loop.
  K9 (exp_mul_variants): the script's `mul_b` under jax.disable_jit() and
      the python-int oracle, for variants A, B, C and a chain.
  K10 (exp_mul_mxu): the six variants' JAX outputs frozen in
      tests/vectors/torch_port_v1.json (`exp_mul`; the live calls take
      3-16 s each) and the oracle; `-m slow` recomputes them live.

The scripts are loaded from scripts/ with importlib; they are not edited.
"""

import base64
import functools
import importlib.util
import json
import os
import random
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from zksnap_tpu_torch.experiments import exp_mul_mxu as tmx
from zksnap_tpu_torch.experiments import exp_mul_variants as tmv
from zksnap_tpu_torch.experiments import exp_vpu_rates as tvr
from zksnap_tpu_torch.fields.common import ints_to_limbs, limbs_to_ints

torch.set_num_threads(1)
DEV = "cpu"
ROOT = os.path.join(os.path.dirname(__file__), "..")


@functools.cache
def _script(name: str):
    """scripts/<name>.py loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _ints(limbs) -> list:
    """[16, n] limbs -> n python ints."""
    return limbs_to_ints(np.ascontiguousarray(np.asarray(limbs).T)
                         .astype(np.int32))


# ------------------------------------------------------------------ K11


def _chain_inputs(W: int, seed: int):
    """[16, W] uint32: rows 0-7 over all 32 bits, rows 8-15 below 2^16 (the
    script's range); b's first lanes 0, 1, 2, 3 (f32fma: a fixed point,
    linear growth, growth to inf)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, (16, W), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, (16, W), dtype=np.uint32)
    a[8:] &= 0xFFFF
    b[8:] &= 0xFFFF
    b[8, :4] = [0, 1, 2, 3]
    return a, b


@pytest.mark.parametrize("kind,chain", [(k, 8) for k in tvr.CHAIN_KINDS]
                         + [("f32fma", 512)])
def test_chain_matches_jax(kind, chain):
    W = 128
    a, b = _chain_inputs(W, 11)
    want = np.asarray(_script("exp_vpu_rates").make_chain(kind, chain, W)(
        jnp.asarray(a), jnp.asarray(b)))
    got = tvr.make_chain(kind, chain, W, device=DEV)(a, b)
    assert got.dtype == torch.int32 and got.shape == (16, W)
    assert np.array_equal(_u32(got), want)
    if kind == "f32fma" and chain == 512:
        # lanes that reached +inf and -inf, cast as JAX casts them
        assert (want == 2 ** 31 - 1).any() and (want == 2 ** 31).any()


def test_f32_cast_matches_jax():
    """PyTorch's own cast on the CPU gives -2^31 for inf, -inf and NaN;
    the port's gives what JAX and CUDA give."""
    x = np.array([np.inf, -np.inf, np.nan, 2.0 ** 31, -(2.0 ** 31) - 256,
                  2.0 ** 31 - 128, 3.7, -3.7, 0.0], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    assert np.array_equal(tvr.f32_to_i32(torch.from_numpy(x)).numpy(), want)


def test_fma_f32_is_one_rounding():
    """x * y + 1 rounded once, as jitted XLA on the CPU fuses it (and the
    card's FFMA computes it), on products of every size."""
    rng = np.random.default_rng(3)
    x = (rng.integers(1, 1 << 24, 4096) * 2.0 ** rng.integers(-8, 40, 4096)
         ).astype(np.float32)
    y = rng.integers(1, 1 << 24, 4096).astype(np.float32)
    # odd products in [2^24, 2^25): a tie for float32, which the +1 breaks
    x[:2048] = 2 * rng.integers(2048, 2896, 2048) + 1
    y[:2048] = 2 * rng.integers(2048, 2896, 2048) + 1
    want = np.asarray(jax.jit(lambda x, y: x * y + jnp.float32(1.0))(
        jnp.asarray(x), jnp.asarray(y)))
    got = tvr.fma_f32(torch.from_numpy(x), torch.from_numpy(y), 1.0)
    assert np.array_equal(got.numpy(), want)
    two_roundings = (x * y) + np.float32(1.0)
    assert not np.array_equal(two_roundings, want)  # the inputs tell apart


def test_i8dot_matches_jax():
    fn, (lhs, x0) = _script("exp_vpu_rates").make_dot("i8dot", 128, 4)
    want = np.asarray(fn(lhs, x0))
    go, args = tvr.make_dot("i8dot", 128, 4, np.asarray(lhs),
                            np.asarray(x0), device=DEV)
    got = go(*args)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_bf16dot_matches_jax(monkeypatch):
    """The script calls np.bfloat16, which numpy does not have; with
    ml_dtypes' type in its place the JAX kernel runs.  The f32 sums of the
    two sides run in another order: tolerance chip_smoke.BF16_TOL of
    max |acc|."""
    import ml_dtypes

    jvr = _script("exp_vpu_rates")
    if not hasattr(np, "bfloat16"):
        with pytest.raises(AttributeError):
            jvr.make_dot("bf16dot", 8, 1)
    monkeypatch.setattr(np, "bfloat16", ml_dtypes.bfloat16, raising=False)
    fn, (lhs, x0) = jvr.make_dot("bf16dot", 128, 4)
    want = np.asarray(fn(lhs, x0))
    go, args = tvr.make_dot("bf16dot", 128, 4, np.asarray(lhs),
                            np.asarray(x0), device=DEV)
    assert args[1].dtype == torch.bfloat16
    got = go(*args).numpy()
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= chip_smoke.BF16_TOL * scale


_U32ADD_SASS = """\
		Function : _Z15op_chain_kernelILi2EEvPKjS1_Pjxi
        /*0170*/                   ISETP.GE.AND P0, PT, R8, 0x10, PT ;
        /*0180*/              @!P0 BRA 0x260 ;
        /*0190*/                   UMOV UR4, URZ ;
        /*01a0*/                   IADD3 R7, R4.reuse, R7, R4.reuse ;
        /*01b0*/                   UIADD3 UR5, UR4, 0x20, URZ ;
        /*01c0*/                   UIADD3 UR4, UR4, 0x10, URZ ;
        /*01d0*/                   IADD3 R7, R4, R7, R4 ;
        /*01e0*/                   ISETP.LT.AND P0, PT, R8, UR5, PT ;
        /*01f0*/                   IADD3 R7, R4, R7, R4 ;
        /*0200*/                   IADD3 R7, R4, R7, R4 ;
        /*0210*/                   IADD3 R7, R4, R7, R4 ;
        /*0220*/                   IADD3 R7, R4, R7, R4 ;
        /*0230*/                   IADD3 R7, R4, R7, R4 ;
        /*0240*/                   IADD3 R7, R4, R7, R4 ;
        /*0250*/              @!P0 BRA 0x1a0 ;
        /*0260*/                   ISETP.LE.AND P0, PT, R8, UR4, PT ;
        /*0270*/               @P0 BRA 0x2c0 ;
        /*0280*/                   UIADD3 UR4, UR4, 0x1, URZ ;
        /*0290*/                   IADD3 R7, R4, R7, RZ ;
        /*02a0*/                   ISETP.GT.AND P0, PT, R8, UR4, PT ;
        /*02b0*/              @!P0 BRA 0x280 ;
        /*02c0*/                   VIADD R2, R2, 0x4 ;
"""


def _loop_sass(kind_index: int, ops) -> str:
    """A chain kernel's SASS whose main loop holds `ops` (the format of
    `cuobjdump -sass`)."""
    lines = [f"\t\tFunction : _Z15op_chain_kernelILi{kind_index}EEvPKjS1_Pjxi"]
    for i, op in enumerate(list(ops) + ["VIADD R6, R6, 0x10",
                                        "ISETP.GE.AND P0, PT, R6, R8, PT",
                                        "@!P0 BRA 0x100"]):
        lines.append(f"        /*{0x100 + 16 * i:04x}*/{' ' * 19}{op} ;")
    return "\n".join(lines) + "\n"


def test_chain_loops_bound_what_the_loop_issues(monkeypatch):
    """K11's chain bounds come from the main loop of each compiled chain
    kernel: loop control left out, each pipe at its own rate, the
    remainder loop not taken for the main one."""
    import types

    u = tvr.CHAIN_UNROLL
    sass = (_loop_sass(0, ["IMAD R5, R5, R4, 0x1"] * u)
            + _loop_sass(1, ["IMAD R5, R5, R4, RZ",
                             "LOP3.LUT R5, R5, 0xffff, RZ, 0xc0, !PT"] * u)
            + _U32ADD_SASS
            + _loop_sass(3, ["SHF.R.U32.HI R0, RZ, 0x10, R5",
                             "LOP3.LUT R5, R0, 0xffff, R5, 0xc8, !PT"])
            + _loop_sass(4, ["FFMA R5, R5, R4, 1"] * u))
    monkeypatch.setattr(chip_smoke.os.path, "exists", lambda path: True)
    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=sass))
    loops = chip_smoke.chain_loops("libzk.so")
    assert loops == {"u32mul": {"IMAD": u}, "u16mul": {"IMAD": u, "LOP3": u},
                     "u32add": {"IADD3": 8},
                     "u32mask": {"LOP3": 1, "SHF": 1},
                     "f32fma": {"FFMA": u}}
    rate = {k: chip_smoke.chain_step_rate(v, u) for k, v in loops.items()}
    sm_clock = chip_smoke.SM_CLOCKS_PER_S
    assert rate["u32mul"] == rate["u16mul"] == 64 * sm_clock
    assert rate["u32add"] == rate["f32fma"] == 128 * sm_clock
    assert rate["u32mask"] == 32 * sm_clock * u  # two ALU ops a loop
    # the issue: three instructions a step at 128 lanes an SM a clock
    assert chip_smoke.chain_step_rate({"IMAD": u, "VIADD": 2 * u}, u) == \
        pytest.approx(128 / 3 * sm_clock)


# ------------------------------------------------------------------ K9


def test_mul_variants_match_jax_and_oracle():
    """Variants A, B, C against `mul_b` (eager, 2-3 s) on 64 values below
    p (edge values first) and 64 of all 16-bit limbs, where only B and C
    are the script's function; the oracle on the first 64; a chain of
    three products."""
    jmv = _script("exp_mul_variants")
    p = tmv.FQ.p
    rng = random.Random(9)
    xs = [0, 1, p - 1, p - 2] + [rng.randrange(p) for _ in range(60)]
    ys = [p - 1, 0, p - 1, 1] + [rng.randrange(p) for _ in range(60)]
    wide = np.random.default_rng(9).integers(0, 1 << 16, (2, 16, 64),
                                             dtype=np.uint32)
    wide[:, :, 0] = 0xFFFF
    a = np.concatenate([ints_to_limbs(xs).T.astype(np.uint32), wide[0]], 1)
    b = np.concatenate([ints_to_limbs(ys).T.astype(np.uint32), wide[1]], 1)
    with jax.disable_jit():
        want = np.asarray(jmv.mul_b(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(jmv.P_COL)))
    r_inv = pow(1 << 256, -1, p)
    oracle = [x * y * r_inv % p for x, y in zip(xs, ys)]
    assert _ints(want[:, :64]) == oracle
    for name in ("B", "C"):
        got = tmv.make_variant(name, device=DEV)(a, b)
        assert np.array_equal(_u32(got), want), name
    got_a = tmv.make_variant("A", device=DEV)(a[:, :64], b[:, :64])
    assert np.array_equal(_u32(got_a), want[:, :64])
    got3 = tmv.make_variant("B", 3, device=DEV)(a[:, :64], b[:, :64])
    assert _ints(_u32(got3)) == [x * y ** 3 * r_inv ** 3 % p
                                 for x, y in zip(xs, ys)]


# ------------------------------------------------------------------ K10


@functools.cache
def _exp_mul_vectors() -> dict:
    with open(os.path.join(ROOT, "tests", "vectors",
                           "torch_port_v1.json")) as f:
        return json.load(f)["exp_mul"]


def _unpack(s: str) -> np.ndarray:
    raw = zlib.decompress(base64.b64decode(s))
    return np.frombuffer(raw, "<u4").reshape(16, -1).copy()


def _oracle(a, b) -> list:
    p = tmx.FR.p
    r_inv = pow(1 << 256, -1, p)
    return [x * y * r_inv % p for x, y in zip(_ints(a), _ints(b))]


def test_mxu_tables_match_the_script():
    comps, nmat, pmat = _script("exp_mul_mxu")._mxu_tables(tmx.FR.p)
    t_comps, t_nmat, t_pmat = tmx.mxu_tables(tmx.FR.p)
    assert t_comps == comps
    assert np.array_equal(t_nmat, np.asarray(nmat.astype(jnp.float32)))
    assert np.array_equal(t_pmat, np.asarray(pmat.astype(jnp.float32)))


@pytest.mark.parametrize("variant", tmx.VARIANTS)
def test_mxu_variant_matches_frozen_jax(variant):
    """The port's plain version of each variant against the frozen JAX
    output, on 256 values below p ("small") and 256 of all 16-bit limbs
    ("wide").  Where the JAX variant is wrong the port's is held to the
    oracle instead: kar+mxu everywhere (its digit split of Karatsuba's
    signed columns), kar where its uint32 carry of a negative column
    breaks (on a few of these inputs); on wide inputs both equal base."""
    v = _exp_mul_vectors()
    a_oracle, b_oracle, _ = tmx.oracle_inputs()  # main's 256-value check
    assert np.array_equal(_unpack(v["a_small"]), _u32(a_oracle))
    assert np.array_equal(_unpack(v["b_small"]), _u32(b_oracle))
    fn = tmx.make_kernel(variant, tmx.FR.p, tmx.FR.n0, device=DEV)
    for part in ("small", "wide"):
        a, b = _unpack(v["a_" + part]), _unpack(v["b_" + part])
        frozen = _unpack(v["out"][variant][part])
        got = _u32(fn(a, b))
        if variant in ("kar", "kar+mxu"):
            base = _unpack(v["out"]["base"][part])
            assert np.array_equal(got, base), (variant, part)
            right = (frozen == base).all(0)
            assert np.array_equal(got[:, right], frozen[:, right])
            if variant == "kar+mxu" and part == "small":
                assert not right.any()  # reference fault: every value
        else:
            assert np.array_equal(got, frozen), (variant, part)
        if variant in tmx.PRODUCTS and part == "small":
            assert _ints(got) == _oracle(a, b)
    if variant == "kar":  # reference fault: wrong on some small inputs
        small = _unpack(v["out"]["kar"]["small"])
        assert _ints(small) != _oracle(_unpack(v["a_small"]),
                                       _unpack(v["b_small"]))


@pytest.mark.slow
def test_exp_mul_vectors_are_live_jax():
    """The frozen K10 outputs are what the script's kernels give now."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import gen_torch_port_vectors as gen

    assert gen.part_exp_mul()["exp_mul"] == _exp_mul_vectors()


# ------------------------------------------------------------------ mains


@pytest.mark.parametrize("module,argv,lines", [
    (tvr, ["3", "4"], ("Gop/s", "Tmac/s")),
    (tmv, ["--log-n", "6"], ("Mop/s", "B == A: True", "C == A: True")),
    (tmx, ["8", ",".join(tmx.VARIANTS)], ("Mmul/s", "(timing only)")),
], ids=["exp_vpu_rates", "exp_mul_variants", "exp_mul_mxu"])
def test_main_runs_on_the_cpu(module, argv, lines, capsys):
    """`main` of each module at a tiny size with --device cpu: the
    script's lines, and no product variant wrong."""
    res = module.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "on cpu" in out
    for line in lines:
        assert line in out
    assert "WRONG" not in out
    if module is tmx:
        assert [res[v]["ok"] for v in tmx.PRODUCTS] == [True] * 4
