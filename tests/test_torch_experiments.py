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
import re
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


def _dot_b_matrix(kind: str, lhs: np.ndarray) -> np.ndarray:
    """B [32 slots, 64 outputs] as the kernel's products read it: the
    shared-memory image (dot_b_image) through the descriptor (core
    (n // 8, k // 8 of a k step) at SBO 256 and LBO 128 bytes, row n % 8 at
    16 bytes); int8 values or bf16 bit patterns."""
    img = tvr.dot_b_image(kind, lhs)
    esz = 1 if kind == "i8dot" else 2
    B = np.zeros((32, 64), np.int64)
    for k in range(32):
        ks, kk = divmod(k, 16) if esz == 2 else (0, k)
        for n in range(64):
            at = (2048 * ks + 256 * (n // 8) + 128 * (kk * esz // 16)
                  + 16 * (n % 8) + (kk * esz) % 16)
            B[k, n] = (int(img[at].view(np.int8)) if esz == 1
                       else int(img[at]) | int(img[at + 1]) << 8)
    return B


def _bf16_value(bits) -> np.ndarray:
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def _dot_model(kind: str, lhs: np.ndarray, x0: np.ndarray,
               n_mm: int) -> np.ndarray:
    """A lane-by-lane model of csrc/exp_rates.cu's dot_chain_kernel: each
    block's 64 columns as the M rows (warp w rows 16w.., lane (g, t) rows
    g and g + 8), A's registers loaded from x0 by slot (DOT_PERM for
    i8dot) and each step assembled into A, D = A . B, D's registers read
    at their n tiles and summed, and the next A repacked from them by
    dot_a_source (int8 wrap; bf16 of y * 1e-3); every step's D added to
    the sum.  x0: int8, or bf16 bits."""
    i8 = kind == "i8dot"
    W = x0.shape[1]
    B = _dot_b_matrix(kind, lhs)
    Bv = B if i8 else _bf16_value(B)
    n_ks, per_reg = (1, 4) if i8 else (2, 2)
    perm = tvr.DOT_PERM if i8 else np.arange(32)
    acc = np.zeros((64, W), np.int64 if i8 else np.float32)
    lanes = [(w, lane >> 2, lane & 3) for w in range(4) for lane in range(32)]
    for c0 in range(0, W, 64):
        cols = {(w, g): (c0 + 16 * w + g, c0 + 16 * w + g + 8)
                for w, g, _ in lanes}
        regs = {}  # (w, g, t, ks, r, i) -> an A value (int8, or bf16 bits)
        for w, g, t in lanes:
            for ks in range(n_ks):
                for r in range(4):
                    m = cols[w, g][r & 1]
                    for i in range(per_reg):
                        slot = tvr.dot_a_slot(kind, ks, r, t, i)
                        regs[w, g, t, ks, r, i] = (
                            int(x0[perm[slot], m]) if m < W else 0)
        total = np.zeros((64, 64), acc.dtype)
        for _ in range(n_mm):
            A = np.full((64, 32), -1 << 20, np.int64)
            for (w, g, t, ks, r, i), v in regs.items():
                A[16 * w + g + 8 * (r & 1),
                  tvr.dot_a_slot(kind, ks, r, t, i)] = v
            assert (A > -1 << 20).all()  # every slot of every row once
            D = (A @ Bv if i8 else
                 _bf16_value(A).astype(np.float32) @ Bv.astype(np.float32))
            total = total + D
            for w, g, t in lanes:
                for ks in range(n_ks):
                    for r in range(4):
                        for i in range(per_reg):
                            nt, j = tvr.dot_a_source(kind, ks, r, i)
                            y = D[16 * w + g + 8 * (j >> 1),
                                  8 * nt + 2 * t + (j & 1)]
                            regs[w, g, t, ks, r, i] = (
                                ((int(y) + 128) & 255) - 128 if i8 else
                                int(tvr._bf16_bits(np.float32(y)
                                                   * np.float32(1e-3))[0]))
        valid = min(64, W - c0)
        acc[:, c0:c0 + valid] = total.T[:, :valid]
    return acc


def test_dot_perm_is_a_bijection_on_each_half():
    """DOT_PERM maps slots 0..15 onto rows 0..15 and 16..31 onto 16..31,
    and slot 4t + i of a quad's lane t is D's position {2t, 2t+1, 8+2t,
    9+2t}[i] of the same lane: what the i8dot repack reads."""
    perm = list(tvr.DOT_PERM)
    assert sorted(perm[:16]) == list(range(16))
    assert sorted(perm[16:]) == list(range(16, 32))
    for t in range(4):
        for r in range(4):
            for i in range(4):
                nt, j = tvr.dot_a_source("i8dot", 0, r, i)
                slot = tvr.dot_a_slot("i8dot", 0, r, t, i)
                assert perm[slot] == 8 * nt + 2 * t + (j & 1)
                assert (j >> 1) == (r & 1)  # the same row of the tile


@pytest.mark.parametrize("W", [64, 72])
@pytest.mark.parametrize("kind", tvr.DOT_KINDS)
def test_dot_fragment_model_matches_the_plain_version(kind, W):
    """The lane-by-lane model of the transposed chain (A repacked from D in
    registers, under DOT_PERM for i8dot and as D lies for bf16dot) is
    dot_chain_plain's i8dot bit-exact and its bf16dot within
    chip_smoke.BF16_TOL of max |acc|, at W = 64 and at 72, whose second
    tile has 56 idle rows; n_mm = 4."""
    rng = np.random.default_rng(1200 + W)
    lhs, x0 = chip_smoke.dot_sides(rng, kind, W)
    if kind == "i8dot":
        got = _dot_model(kind, lhs, x0, 4)
        want = tvr.dot_chain_plain(kind, torch.from_numpy(lhs),
                                   torch.from_numpy(x0), 4)
        assert np.array_equal(got.astype(np.int32), want.numpy())
    else:
        bits = tvr._bf16_bits(x0)
        got = _dot_model(kind, lhs, bits, 4)
        xt = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
        want = tvr.dot_chain_plain(kind, torch.from_numpy(lhs), xt,
                                   4).numpy()
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(got - want).max() <= chip_smoke.BF16_TOL * scale


@pytest.mark.parametrize("kind", tvr.DOT_KINDS)
def test_dot_b_image_unpacks_to_l(kind):
    """The kernel's B image (dot_b_image), read through the
    descriptor's core-matrix addressing, is L^T with i8dot's K rows at
    L's columns DOT_PERM (bf16dot's in order, as bf16 of L)."""
    lhs, _ = chip_smoke.dot_sides(np.random.default_rng(7), kind, 8)
    B = _dot_b_matrix(kind, lhs)
    if kind == "i8dot":
        assert np.array_equal(B, lhs[:, tvr.DOT_PERM].T.astype(np.int64))
    else:
        assert np.array_equal(B, tvr._bf16_bits(lhs).T.astype(np.int64))
    assert tvr.dot_b_image(kind, lhs).size == (2048 if kind == "i8dot"
                                               else 4096)


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


def _listing(name: str, ops) -> str:
    """`cuobjdump -sass` of one function: ops are opcodes with operands,
    or ("BRA", label) to branch back to the op at index label."""
    lines = [f"\t\tFunction : {name}"]
    for i, op in enumerate(ops):
        if isinstance(op, tuple):
            op = f"BRA 0x{0x100 + 16 * op[1]:x}"
        lines.append(f"        /*{0x100 + 16 * i:04x}*/{' ' * 19}{op} ;")
    return "\n".join(lines) + "\n"


def _dot_listing(kind: int, step) -> str:
    """A dot kernel's listing: set-up, a step outside the loop, then a
    loop of two steps."""
    name = f"_Z16dot_chain_kernelILi{kind}EEvPKN3DotIXT_EE5lhs_tEii"
    return _listing(name, ["LDG.E.U8 R4, [R2.64]"] + step + step + step
                    + [("BRA", 1 + len(step)), "STG.E [R6.64], R8", "EXIT"])


def test_dot_report_reads_a_step(monkeypatch):
    """chip_smoke.dot_report: a dot kernel's step loop read from its SASS,
    a step's tensor-core instructions and shared-memory accesses counted
    from the trip's multiply-adds (a warp's 16 columns x 64 x 32, half
    again for the sum's product, a step); require_dots holds each loop to
    no LDS/STS and each kernel to a 0-byte frame."""
    import types

    i8 = ["WARPGROUP.ARRIVE", "IGMMA.64x32x32.S8.S8 R24, R4, gdesc[UR4]",
          "IGMMA.64x64x32.S8.S8 R40, R4, gdesc[UR8], R40",
          "WARPGROUP.DEPBAR.LE gsb0, 0x1", "PRMT R4, R24, 0x40, R25"]
    bf = ["WARPGROUP.ARRIVE", "HGMMA.64x32x16.F32.BF16 R24, R4, gdesc[UR4]",
          "HGMMA.64x32x16.F32.BF16 R24, R8, gdesc[UR6], R24",
          "HGMMA.64x64x16.F32.BF16 R40, R4, gdesc[UR8], R40",
          "HGMMA.64x64x16.F32.BF16 R40, R8, gdesc[UR10], R40",
          "FMUL R4, R24, 0.001", "F2FP.BF16.F32.PACK_AB R4, R25, R24"]
    sass = _dot_listing(0, i8) + _dot_listing(1, bf)
    monkeypatch.setattr(chip_smoke.os.path, "exists", lambda path: True)
    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=sass))
    ptxas = {f"_Z16dot_chain_kernelILi{k}EEvPKN3DotIXT_EE5lhs_tEii":
             {"registers": 90, "stack_bytes": 0} for k in (0, 1)}
    rep = chip_smoke.dot_report(ptxas, "libzk.so")
    got = {re.search(r"ILi(\d)E", k).group(1): (
        r["steps_a_trip"], r["a_step"]["tensor"], r["a_step"]["LDS/STS"],
        r["a_step"]["all"]) for k, r in rep.items()}
    assert got == {"0": (2, 2, 0, 5), "1": (2, 4, 0, 7)}
    assert all(r["LDL/STL"] == 0 and r["registers"] == 90
               for r in rep.values())
    chip_smoke.require_dots(rep)
    with_lds = _dot_listing(0, i8 + ["LDS R4, [R9]"]) + _dot_listing(1, bf)
    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=with_lds))
    with pytest.raises(RuntimeError):
        chip_smoke.require_dots(chip_smoke.dot_report(ptxas, "libzk.so"))
    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=sass))
    ptxas[next(iter(ptxas))]["stack_bytes"] = 8
    with pytest.raises(RuntimeError):
        chip_smoke.require_dots(chip_smoke.dot_report(ptxas, "libzk.so"))


def test_exp_mul_report_weights_loops_and_pipes(monkeypatch):
    """K9's and K10's SASS an element (chip_smoke.exp_mul_report): B's
    product once a trip of its loop over n_muls (x4 four times), C's
    16-step loop 16 times inside it, K10's tile loop once; the issue bound
    counts IMAD.WIDE twice on the IMAD pipe, a warp's IMMA as MMA_OPS and
    a warpgroup's IGMMA.MxNxK as 2 M N K at the int8 rate;
    require_exp_mul holds every kernel to its ptxas line and to no local
    memory."""
    import types

    wide = "IMAD.WIDE.U32 R2, R3, R4, R2"
    sass = (_listing("_Z12mul16_kernelILb0EEvPKjS1_Pjxi5Mod16",
                     ["LDG.E R3, [R4]", wide, wide, "IADD3 R1, R2, R3, RZ",
                      ("BRA", 1), "STG.E [R4], R1", "EXIT", ("BRA", 7)])
            + _listing("_Z12mul16_kernelILb1EEvPKjS1_Pjxi5Mod16",
                       ["LDG.E R3, [R4]", "LDS R5, [R6]", wide,
                        ("BRA", 1), "LOP3.LUT R1, R2, 0xffff, RZ, 0xc0, !PT",
                        ("BRA", 1), "EXIT"])
            + _listing("_Z14mxu_mul_kernelILi2EEvPKjS1_Pjx5Mod16S1_",
                       ["LDG.E R3, [R4]", "IMMA.16832.U8.U8 R8, R12, R16, R8",
                        "SHFL.IDX R1, R2, R3, 0x1f", "IMAD R1, R2, R3, R4",
                        ("BRA", 1), "EXIT"])
            + _listing("_Z14mxu_mul_kernelILi3EEvPKjS1_Pjx5Mod16S1_",
                       ["IGMMA.64x32x32.U8.U8 R24, R8, gdesc[UR4], R24",
                        "IGMMA.64x64x32.U8.U8 R40, R8, gdesc[UR8], R40",
                        ("BRA", 0), "EXIT"]))
    monkeypatch.setattr(chip_smoke.os.path, "exists", lambda path: True)
    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=sass))
    ptxas = {"_Z12mul16_kernelILb0EEvPKjS1_Pjxi5Mod16":
             {"registers": 80, "stack_bytes": 0},
             "_Z12mul16_kernelILb1EEvPKjS1_Pjxi5Mod16":
             {"registers": 60, "stack_bytes": 0},
             "_Z14mxu_mul_kernelILi2EEvPKjS1_Pjx5Mod16S1_":
             {"registers": 120, "stack_bytes": 0},
             "_Z14mxu_mul_kernelILi3EEvPKjS1_Pjx5Mod16S1_":
             {"registers": 116, "stack_bytes": 0}}
    rep = chip_smoke.exp_mul_report(ptxas, "libzk.so")
    by = {chip_smoke.exp_kernel_key(k): v for k, v in rep.items()}
    b, c, mxu = by["mul16_kernel<0>"], by["mul16_kernel<1>"], \
        by["mxu_mul_kernel<2>"]
    assert b["an_element"]["B"] == {"LDG.E": 1, "IMAD.WIDE.U32": 2,
                                    "IADD3": 1, "BRA": 2, "STG.E": 1,
                                    "EXIT": 1}
    assert b["an_element"]["B x4"]["IMAD.WIDE.U32"] == 8
    assert b["an_element"]["B x40"]["IADD3"] == 40
    assert c["an_element"]["C"] == {"LDG.E": 1, "LDS": 16,
                                    "IMAD.WIDE.U32": 16, "BRA": 17,
                                    "LOP3.LUT": 1, "EXIT": 1}
    assert c["loops"] == 2 and c["LDL/STL"] == 0 and c["registers"] == 60
    clk = chip_smoke.issue_clocks(b["an_element"]["B x40"])
    assert clk["imad"] == 2 * 80 / 64 and clk["alu"] == 40 / 64
    assert clk["issue"] == (80 + 40 + 40 + 1 + 1 + 1 + 1) / 128
    ops = mxu["an_element"][""]
    assert ops["IMMA.16832.U8.U8"] == 1
    assert chip_smoke.issue_clocks(ops)["tensor"] == pytest.approx(
        chip_smoke.MMA_OPS / 32 / (chip_smoke.INT8_OPS_PER_S
                                   / chip_smoke.SM_CLOCKS_PER_S))
    wg = by["mxu_mul_kernel<3>"]["an_element"][""]
    assert wg == {"IGMMA.64x32x32.U8.U8": 1, "IGMMA.64x64x32.U8.U8": 1,
                  "BRA": 1, "EXIT": 1}
    assert chip_smoke.issue_clocks(wg)["tensor"] == pytest.approx(
        2 * 64 * (32 + 64) * 32 / 128 / (chip_smoke.INT8_OPS_PER_S
                                         / chip_smoke.SM_CLOCKS_PER_S))
    n = 1 << 18
    ib = chip_smoke.issue_bound(b["an_element"]["B x40"], n, n)
    assert ib["issue_bound_by"] == "imad"
    assert ib["issue_bound_ms"] == pytest.approx(
        clk["imad"] * n / chip_smoke.SM_CLOCKS_PER_S * 1e3)
    assert chip_smoke.issue_bound(b["an_element"]["B"], n, n * 192)[
        "issue_bound_by"] == "bytes"
    lines = {k: (v["registers"], v["stack_bytes"]) for k, v in by.items()}
    monkeypatch.setattr(chip_smoke, "EXP_MUL_PTXAS", lines)
    chip_smoke.require_exp_mul(rep)
    for key, bad in (("stack_bytes", 16), ("LDL/STL", 1), ("registers", 61)):
        c_bad = dict(c, **{key: bad})
        with pytest.raises(RuntimeError):
            chip_smoke.require_exp_mul(dict(rep, **{
                "_Z12mul16_kernelILb1EEvPKjS1_Pjxi5Mod16": c_bad}))
    with pytest.raises(RuntimeError):
        chip_smoke.require_exp_mul(dict(rep, **{
            "_Z14mxu_mul_kernelILi2EEvPKjS1_Pjx5Mod16S1_": dict(mxu, **{
                "LDL/STL": 2})}))


def test_exp_mul_ragged_runs_every_variant(monkeypatch):
    """chip_smoke.exp_mul_ragged at small sizes on the CPU (the wrappers'
    plain versions): K9's B, C and chain x4 and all six K10 variants, at
    a size 37 short of a power of two and at 100."""
    monkeypatch.setattr(chip_smoke, "EXP_N_LOG", 7)
    monkeypatch.setattr(chip_smoke, "EXP_B_LOG", 7)
    got = chip_smoke.exp_mul_ragged(torch.device("cpu"))
    assert got == {**{f"K9 {k}": [91, 100] for k in ("B", "C", "B x4")},
                   **{f"K10 {v}": [91, 100] for v in tmx.VARIANTS}}


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


# ------------------------------------------------------------------ K9/K10
# numpy models of the kernels' arithmetic order (csrc/mont16.cuh,
# csrc/exp_mul_mxu.cu), held to the plain versions and the JAX kernels


def _limb_cases(p: int, seed: int, n: int = 64) -> np.ndarray:
    """[16, n] uint64 16-bit limbs: all 0xFFFF, p - 1, 0, 1, then seeded
    values of all 16-bit limbs."""
    x = np.random.default_rng(seed).integers(0, 1 << 16, (16, n),
                                             dtype=np.uint64)
    for j, v in enumerate(((1 << 256) - 1, p - 1, 0, 1)):
        x[:, j] = [(v >> (16 * i)) & 0xFFFF for i in range(16)]
    return x


def _transcription(a, b, p):
    """The uint32 transcription of `mul_b` (conv_schoolbook, word_redc) in
    exact integers: (out, the 16 m's, the largest column it ever holds)."""
    pl = [(p >> (16 * i)) & 0xFFFF for i in range(16)]
    n0 = tmx.n0_16(p)
    cols = np.zeros((33, a.shape[1]), np.uint64)
    for i in range(16):
        prod = a[i] * b
        cols[i:i + 16] += prod & 0xFFFF
        cols[i + 1:i + 17] += prod >> 16
    top = cols.max()
    ms = []
    for i in range(16):
        m = (cols[i] * n0) & 0xFFFF
        ms.append(m)
        for j in range(16):
            prod = m * pl[j]
            cols[i + j] += prod & 0xFFFF
            cols[i + j + 1] += prod >> 16
        cols[i + 1] += cols[i] >> 16
        top = max(top, cols.max())
    carry = np.zeros_like(cols[0])
    out = []
    for i in range(16):
        tot = cols[16 + i] + carry
        top = max(top, tot.max())
        out.append(tot & 0xFFFF)
        carry = tot >> 16
    return _cond_sub(np.stack(out), carry + cols[32], pl), ms, int(top)


def _cond_sub(out, carry, pl):
    """mont16.cuh's cond_sub16: out - p limbwise mod 2^16 where carry or
    out - p borrows nothing."""
    borrow = np.zeros_like(out[0])
    d = []
    for i in range(16):
        t = (out[i] - pl[i] - borrow) & 0xFFFFFFFF
        d.append(t & 0xFFFF)
        borrow = t >> 31
    ge = (carry != 0) | (borrow == 0)
    return np.where(ge, np.stack(d), out)


def _interleaved(a, b, p):
    """mont16.cuh's order: whole products summed in 64-bit columns, REDC
    step i right after schoolbook row i on a window of 16 columns ->
    (out, the 16 m's, the largest column)."""
    pl = [(p >> (16 * i)) & 0xFFFF for i in range(16)]
    n0 = tmx.n0_16(p)
    w = np.zeros((16, a.shape[1]), np.uint64)
    ms, top = [], 0
    for i in range(16):
        t0 = w[0] + a[i] * b[0]
        m = ((t0 & 0xFFFFFFFF) * n0) & 0xFFFF
        ms.append(m)
        t0 = t0 + m * pl[0]
        assert not (t0 & 0xFFFF).any()
        new = np.zeros_like(w)
        new[0] = w[1] + a[i] * b[1] + m * pl[1] + (t0 >> 16)
        for j in range(2, 16):
            new[j - 1] = w[j] + a[i] * b[j] + m * pl[j]
        w = new
        top = max(top, int(w.max()), int(t0.max()))
    carry = np.zeros_like(w[0])
    out = []
    for k in range(16):
        v = w[k] + carry
        out.append(v & 0xFFFF)
        carry = v >> 16
    return _cond_sub(np.stack(out), carry, pl), ms, top


@pytest.mark.parametrize("field", ["fq", "fr"])
def test_whole_product_order_matches_the_transcription(field):
    """The invariant K9's and K10's products rely on: on 16-bit limbs no
    uint32 column of the transcription wraps (every column, schoolbook and
    REDC steps, stays below 2^24), so it computes in exact integers; the
    kernels' order (whole products in 64-bit columns, the REDC
    interleaved) then gives the same m's and the same bits, which are
    those of the plain version and of JAX `mul_b`."""
    p = tmv.FQ.p if field == "fq" else tmx.FR.p
    a, b = _limb_cases(p, 21), _limb_cases(p, 22)[:, ::-1].copy()
    want, ms, top = _transcription(a, b, p)
    assert top < 1 << 24
    got, ms2, top2 = _interleaved(a, b, p)
    assert top2 < 1 << 38
    assert all(np.array_equal(x, y) for x, y in zip(ms, ms2))
    assert np.array_equal(got, want)
    plain = tmv.mul_limb_major_plain(
        torch.from_numpy(a.astype(np.uint32).view(np.int32)),
        torch.from_numpy(b.astype(np.uint32).view(np.int32)), p)
    assert np.array_equal(_u32(plain), want.astype(np.uint32))
    jmv = _script("exp_mul_variants")
    if field == "fq":  # the script's modulus
        with jax.disable_jit():
            jax_out = np.asarray(jmv.mul_b(
                jnp.asarray(a.astype(np.uint32)),
                jnp.asarray(b.astype(np.uint32)),
                jnp.asarray(jmv.P_COL)))
        assert np.array_equal(jax_out, want.astype(np.uint32))


def _conv_wide(a, b):
    """Whole-product columns (csrc/exp_mul_mxu.cu conv_wide), int64."""
    n = len(a)
    cols = [np.zeros_like(a[0]) for _ in range(2 * n - 1)]
    for i in range(n):
        for j in range(n):
            cols[i + j] = cols[i + j] + a[i] * b[j]
    return cols


def _conv_kar(a, b, n=16, depth=2):
    """conv_kar on whole-product columns: every column, and every middle
    term z1 - z0 - z2, nonnegative."""
    if depth == 0 or n <= 4:
        return _conv_wide(a, b)
    h = n // 2
    z0 = _conv_kar(a[:h], b[:h], h, depth - 1)
    z2 = _conv_kar(a[h:], b[h:], h, depth - 1)
    z1 = _conv_wide([a[i] + a[h + i] for i in range(h)],
                    [b[i] + b[h + i] for i in range(h)])
    out = [np.zeros_like(a[0]) for _ in range(2 * n - 1)]
    for i in range(2 * h - 1):
        mid = z1[i] - z0[i] - z2[i]
        assert (mid >= 0).all()
        out[i] = out[i] + z0[i]
        out[i + 2 * h] = out[i + 2 * h] + z2[i]
        out[i + h] = out[i + h] + mid
    return out


def _split_columns(a, b, nc):
    """The schoolbook's split columns from whole-product sums (csrc/
    exp_mul_mxu.cu split_columns): L_k mod 2^32, H_k the high halves,
    column k = L_k - 2^16 H_k + H_{k-1} mod 2^32."""
    L = [np.zeros_like(a[0]) for _ in range(nc)]
    H = [np.zeros_like(a[0]) for _ in range(nc)]
    for i in range(16):
        ah = (a[i] << 16) & 0xFFFFFFFF
        for j in range(16):
            if i + j < nc:
                L[i + j] = (L[i + j] + a[i] * b[j]) & 0xFFFFFFFF
                H[i + j] = (H[i + j] + ((ah * b[j]) >> 32)) & 0xFFFFFFFF
    return [(L[k] - (H[k] << 16) + (H[k - 1] if k else 0)) & 0xFFFFFFFF
            for k in range(nc)]


def test_product_columns_match_the_plain_ones():
    """K10's products: Karatsuba on whole-product columns (17-bit middle
    limbs, every term nonnegative) gives the schoolbook's whole-product
    columns; the ablations' split columns from the whole-product sums and
    their high halves are conv_schoolbook's, bit for bit."""
    p = tmx.FR.p
    a = _limb_cases(p, 31).astype(np.int64)
    b = _limb_cases(p, 32)[:, ::-1].astype(np.int64)
    assert all(np.array_equal(x, y) for x, y in
               zip(_conv_kar(list(a), list(b)), _conv_wide(list(a), list(b))))
    want = tmx.conv_schoolbook(torch.from_numpy(a), torch.from_numpy(b))
    got = _split_columns(list(a), list(b), 32)
    assert np.array_equal(np.stack(got), want[:32].numpy())
    assert not want[32].any()  # no product reaches column 32


def _quad_carry(w, nd):
    """csrc/exp_mul_mxu.cu quad_carry over the four threads of a quad, w
    [4][nd] (thread t the columns nd t ..): (digits [4][nd], the carry out
    of each thread's columns)."""
    d, c = [[0] * nd for _ in range(4)], [0] * 4
    for t in range(4):
        for k in range(nd):
            v = w[t][k] + c[t]
            d[t][k], c[t] = v & 0xFFFF, v >> 16
    need = [0x10000 - d[t][0] if all(x == 0xFFFF for x in d[t][1:])
            else 0xFFFFFFFF for t in range(4)]
    cin = [0] * 4
    for r in range(1, 4):  # the three shuffles
        cin[r] = c[r - 1] + (cin[r - 1] >= need[r - 1])
    out = []
    for t in range(4):
        x = cin[t]
        for k in range(nd):
            v = d[t][k] + x
            d[t][k], x = v & 0xFFFF, v >> 16
        out.append(c[t] + x)
    return d, out


@pytest.mark.parametrize("nd", [4, 8])
def test_quad_carry_is_the_carry_pass(nd):
    """The quad's carry pass (each thread its columns, three carries
    passed along) gives a serial pass's digits and carry, on seeded
    columns below 2^30 and on runs of 0xFFFF that carry through a whole
    thread."""
    rng = random.Random(nd)
    for case in range(400):
        if case % 2:
            w = [[rng.randrange(1 << 30) for _ in range(nd)] for _ in range(4)]
        else:  # digits of 0xFFFF, a carry in at the bottom
            w = [[0xFFFF] * nd for _ in range(4)]
            w[0][0] = rng.randrange(1 << 30)
            for _ in range(rng.randrange(4)):
                w[rng.randrange(4)][rng.randrange(nd)] = rng.randrange(1 << 17)
        d, c = _quad_carry(w, nd)
        total = sum(x << (16 * i) for i, x in
                    enumerate(v for row in w for v in row))
        want = [(total >> (16 * i)) & 0xFFFF for i in range(4 * nd)]
        assert [x for row in d for x in row] == want
        assert c[3] == total >> (64 * nd)


def _mma(a_regs, b_regs):
    """mma.sync m16n8k32 u8 x u8 -> s32 from the 32 lanes' fragments (the
    PTX layouts: A row g (+8 for a1, a3), bytes 4t (+16 for a2, a3); B
    column g, bytes 4t (+16 for b1); D rows g, g + 8, columns 2t, 2t + 1)."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for r in range(4):
            for i in range(4):
                A[g + 8 * (r & 1), 4 * t + 16 * (r >> 1) + i] = (
                    int(a_regs[lane][r]) >> (8 * i)) & 0xFF
        for h in range(2):
            for i in range(4):
                B[4 * t + 16 * h + i, g] = (int(b_regs[lane][h]) >> (8 * i)) & 0xFF
    D = A @ B
    return [[int(D[g, 2 * t]), int(D[g, 2 * t + 1]), int(D[g + 8, 2 * t]),
             int(D[g + 8, 2 * t + 1])]
            for g, t in ((lane >> 2, lane & 3) for lane in range(32))]


def _tc_redc(rows, p, split):
    """csrc/exp_mul_mxu.cu tc_redc for one tile of 32 elements, lane by
    lane: rows [32][16] the lanes' digit words -> out [16][32]."""
    tab = tmx.fragment_tables(p)
    pl = [(p >> (16 * i)) & 0xFFFF for i in range(16)]
    smem = {}

    def slot(r, q):
        return r * 4 + (q ^ ((r >> 1) & 3))

    for lane in range(32):
        for q in range(4):
            for i in range(4):
                smem[slot(lane, q) * 4 + i] = rows[lane][4 * q + i]

    def word(r, w):
        return smem[slot(r, w >> 2) * 4 + (w & 3)]

    def nmat(nt, ks, h):
        r = (tmx.TAB_NMAT_SPLIT + 4 * nt + 2 * ks + h if split
             else tmx.TAB_NMAT + 2 * nt + h)
        return tab[r]

    out = [[None] * 32 for _ in range(16)]
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    for mt in range(2):
        dm = [[[0] * 4 for _ in range(32)] for _ in range(4)]
        for ks in range(2 if split else 1):
            a = [[word(16 * mt + g, 8 * ks + t), word(16 * mt + g + 8, 8 * ks + t),
                  word(16 * mt + g, 8 * ks + 4 + t),
                  word(16 * mt + g + 8, 8 * ks + 4 + t)] for g, t in lanes]
            for nt in range(4):
                b = [[nmat(nt, ks, 0)[lane], nmat(nt, ks, 1)[lane]]
                     for lane in range(32)]
                d = _mma(a, b)
                for lane in range(32):
                    for r in range(4):
                        dm[nt][lane][r] += d[lane][r]
        mw = [[[0, 0], [0, 0]] for _ in range(32)]
        for h in range(2):
            if split:
                for lane in range(32):
                    for x in range(2):
                        mw[lane][h][x] = sum(
                            (dm[(4 * x + i) >> 1][lane][2 * h + (i & 1)] & 0xFF)
                            << (8 * i) for i in range(4))
            else:
                for quad in range(0, 32, 4):
                    w = [[dm[c][quad + t][2 * h] + (dm[c][quad + t][2 * h + 1] << 8)
                          for c in range(4)] for t in range(4)]
                    d, _ = _quad_carry(w, 4)
                    for t in range(4):
                        mw[quad + t][h] = [d[t][0] | (d[t][1] << 16),
                                           d[t][2] | (d[t][3] << 16)]
        af = [[mw[(lane & ~3) | ((f >> 1) * 2 + (t >> 1))][f & 1][t & 1]
               for f in range(4)] for lane, (g, t) in enumerate(lanes)]
        dp = [_mma(af, [[tab[tmx.TAB_PMAT + 2 * nt][lane],
                         tab[tmx.TAB_PMAT + 2 * nt + 1][lane]]
                        for lane in range(32)]) for nt in range(8)]
        for h in range(2):
            for quad in range(0, 32, 4):
                g = quad >> 2
                e = 16 * mt + g + 8 * h
                if split:
                    for t in (0, 2):
                        upper = t >> 1
                        for i in range(8):
                            low = dp[i >> 1][quad + t][2 * h + (i & 1)]
                            high = dp[(8 + i) >> 1][quad + t][2 * h + (i & 1)]
                            o_low = dp[i >> 1][quad + (t ^ 2)][2 * h + (i & 1)]
                            o_high = dp[(8 + i) >> 1][quad + (t ^ 2)][2 * h + (i & 1)]
                            # the partner (t ^ 2) gives its low if it is
                            # the upper one, else its high
                            out[8 * upper + i][e] = ((high if upper else low)
                                                     ^ (o_high if upper else o_low))
                    continue
                w = []
                for t in range(4):
                    tw = [word(e, 4 * t + q) for q in range(4)]
                    w.append([dp[c][quad + t][2 * h]
                              + (dp[c][quad + t][2 * h + 1] << 8)
                              + ((tw[c >> 1] >> (16 * (c & 1))) & 0xFFFF)
                              for c in range(8)])
                d, c = _quad_carry(w, 8)
                u = d[2] + d[3]
                res = _cond_sub(np.array(u, np.uint64)[:, None],
                                np.array([c[3]], np.uint64), pl)[:, 0]
                for i in range(16):
                    out[i][e] = int(res[i])
    return np.array(out, np.uint64)


@pytest.mark.parametrize("variant", ["mxu", "kar+mxu", "mxunocarry"])
def test_tensor_core_redc_model_matches_the_plain_version(variant):
    """A lane-by-lane model of the kernel's tensor-core REDC (its shared
    rows and swizzle, the packed fragments, the D layout with B's columns
    permuted, the quad's carries and shuffles, the conditional subtract on
    two threads) gives the plain version's bits on a tile of 32 elements
    of 16-bit limbs, all 0xFFFF and p - 1 among them."""
    p = tmx.FR.p
    a, b = _limb_cases(p, 41, 32), _limb_cases(p, 42, 32)[:, ::-1].copy()
    ai, bi = list(a.astype(np.int64)), list(b.astype(np.int64))
    rows = []
    if variant == "mxunocarry":
        cols = _split_columns(ai, bi, 16)
        comps = [(int(cols[c // 3][e]) >> (8 * (c % 3))) & 0xFF if c < 48
                 else 0 for e in range(32) for c in range(64)]
        rows = [[sum(comps[64 * e + 4 * w + q] << (8 * q) for q in range(4))
                 for w in range(16)] for e in range(32)]
    else:
        cols = (_conv_kar(ai, bi) if variant == "kar+mxu"
                else _conv_wide(ai, bi))
        for e in range(32):
            t = sum(int(c[e]) << (16 * k) for k, c in enumerate(cols))
            rows.append([(t >> (32 * w)) & 0xFFFFFFFF for w in range(16)])
    got = _tc_redc(rows, p, variant == "mxunocarry")
    want = tmx.mont_mul_mxu_plain(
        torch.from_numpy(a.astype(np.uint32).view(np.int32)),
        torch.from_numpy(b.astype(np.uint32).view(np.int32)), variant, p)
    assert np.array_equal(got.astype(np.uint32), _u32(want))


def test_fragment_tables_unpack_to_the_script_matrices():
    """The packed B fragments (fragment_tables), read back through the
    m16n8k32 B layout and the positions of B's columns, are mxu_tables'
    matrices: PMAT whole; NMAT's columns at each component's byte position
    (the table on T's bytes) and NMAT padded to K = 64 (the ablation's);
    every position is some column of some n tile exactly once."""
    p = tmx.FR.p
    comps, nmat, pmat = tmx.mxu_tables(p)
    tab = tmx.fragment_tables(p)
    assert tab.shape == (tmx.TAB_ROWS, 32) and tab.dtype == np.uint32

    def unpack(rows_of, n_tiles, k, position):
        mat = np.full((8 * n_tiles, k), -1, np.int64)
        for nt in range(n_tiles):
            for ks in range(k // 32):
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for h in range(2):
                        reg = int(tab[rows_of(nt, ks, h), lane])
                        for i in range(4):
                            col = 32 * ks + 16 * h + 4 * t + i
                            assert mat[position(nt, g), col] in (-1, (reg >> (8 * i)) & 0xFF)
                            mat[position(nt, g), col] = (reg >> (8 * i)) & 0xFF
        assert (mat >= 0).all()  # every position and byte filled
        return mat

    got_p = unpack(lambda nt, ks, h: tmx.TAB_PMAT + 2 * nt + h, 8, 32,
                   tmx.mp_position)
    assert np.array_equal(got_p, pmat)
    got_n = unpack(lambda nt, ks, h: tmx.TAB_NMAT + 2 * nt + h, 4, 32,
                   tmx.m_position)
    for r, (k, d) in enumerate(comps):
        assert np.array_equal(got_n[:, 2 * k + d], nmat[:, r])
    got_s = unpack(lambda nt, ks, h: tmx.TAB_NMAT_SPLIT + 4 * nt + 2 * ks + h,
                   4, 64, tmx.m_position)
    assert np.array_equal(got_s[:, :len(comps)], nmat)
    assert not got_s[:, len(comps):].any()
    assert sorted(tmx.m_position(nt, n) for nt in range(4)
                  for n in range(8)) == list(range(32))
    assert sorted(tmx.mp_position(nt, n) for nt in range(8)
                  for n in range(8)) == list(range(64))


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
