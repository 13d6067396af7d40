"""Time the port's K1 and K2 (the field kernels), K3 (point formulas),
K4 (bucket scan), K5 (weighted suffix), K6 (ladder and tree), K7 (the
staged add), K8 (the batched Jacobian add and dbl), K9 and K10 (the
16-bit-limb Montgomery products), K11 (the raw-rate probes) and the
single-card NTT in other checkouts and this one on one card, in turns.

    python3 scripts/torch_kernel_ab.py OTHER_DIR [OTHER_DIR ...] [--parts k1_k6,k7_k8,k9_k10,k11,ntt] [--out chiprun_out/ab.json]

Each OTHER_DIR holds another checkout's `zksnap_tpu_torch` (for example
the parent commit: `git archive <commit> zksnap_tpu_torch | tar -x -C
build/parent`).  The turns run the others, this tree twice, then the
others in reverse (one other: OTHER, this, this, OTHER).  Each turn is
a process of its own with one checkout first on sys.path: it builds that
checkout's kernels (kept in the checkout's own build directory), makes
the same seeded inputs, calls the checkout's own `mont_mul`,
`mont_addsub`, `point`, `bucket_scan`, `weighted_suffix` and
`ladder_tree` (part k1_k6) and `point_add_batch`, `point_dbl_batch`,
`point_add_staged` and the SRS's double-and-add (part k7_k8),
`mul_limb_major` and `mont_mul_mxu` (part k9_k10), `dot_chain` and
`op_chain` (part k11), `poly/ntt.py` `_ntt_impl` (part ntt), and reads
CUDA events
over repeated calls and the profiler's device time of each kernel.
`--parts` picks the parts (default k1_k6 and k7_k8).  The shapes of
k1_k6:

  * K1, K2 (add): n = 8192 (the k=13 path's) and 2^21 (the k=21 path's)
    contiguous rows, and stage 10 of a 2^21 NTT's views (K1 on
    `xb[..., 1, :, :]` against `w[None]`, K2 on the even rows against
    that product); one forward 2^21 NTT;
  * K3: padd at n = 32768 (the k=21 path's lane carries) and n = 8192
    (the k=13 path's), pmadd and pdbl at n = 8192, on chip_smoke.py's
    seeded points (identities, P == Q and P == -P among them);
  * K4: a variable-base pass of 2 x 2^21 signed-digit pairs, M = 32768
    lanes x K = 128 steps (k=21), and the k=13 fixed-base stream, 16 x
    8192 pairs over M = 32768 lanes x K = 4 steps; then K4's device ms a
    launch at 1 to 128 steps a lane;
  * K5: W = 16 windows of B = 2^15 bucket sums (k=21) and W = 32 of 128
    (K=7);
  * K6: (c, W) = (16, 16) (k=21) and (8, 32) (K=7), and its device ms a
    launch at c = 16 for W = 1, 2, 4, 8, 16 (0 to 240 dependent
    doublings), fitted by least squares as a + b c (W - 1): b is the
    dependent chain's microseconds a doubling;
  * the voter at k=13 (chip_smoke.py's phase 4 sets it up): three warm
    proves timed, and one under the profiler (busy seconds, K1's, K2's
    and PyTorch's direct_copy launches and device ms).

The shapes of k7_k8, on chip_smoke.py's seeded Jacobian points:

  * K8's add and dbl and K7 through their entry points at n = 2^20 and
    32768 (chip_smoke.POINT_SHAPES; P == Q on about 2 % of the lanes),
    K8's add on a batch with P == Q on every lane (the doubling fallback
    everywhere) and on the warp-mixed edge batch at both n;
  * K3's Jacobian add and dbl (`fused.point`) at n = 2^20;
  * one 2^20-point chunk of the SRS's double-and-add
    (`prover/srs.py` `_powers_to_points`, 254 bits, a dbl and an add a
    bit), once, with its device time by kernel name.

The shapes of k9_k10, on chip_smoke.py's seeded 16-bit limbs (edge
values first): K9's variants B and C at n = 2^20 and B's chains x4, x18
and x40 at 2^18 (the experiment's own shapes); K10's six variants at
B = 2^18 (the experiment's) and 2^20.

The shapes of k11 (K11, the raw-rate probes): i8dot and bf16dot, 64
products, at W = 2^14 (the JAX script's `main`), 2^18 (its docstring's)
and 2^14 - 8, in every design the checkout has (`exp_vpu_rates.
DOT_DESIGNS`; a checkout without it has one), each held to its plain
version in the turn; the five chains on 16 x 2^14 lanes at 512 and 16,384
steps.  Each turn reads the dot kernels' ptxas lines and step loops
(chip_smoke.py's `dot_report`) and the chains' loops (`chain_loops`);
`k11_summary` gives each tree's device and call ms range beside the bound
of each shape.

The shapes of ntt: `_ntt_impl`, forward, one transform of 2^21, 2^18
and 2^13 (the checkout's own path: before the NTT kernels, PyTorch
around K1 and K2).  In a checkout with the kernels (`ntt_kernel`) the
turn also times the plain version (`_ntt_plain`) at those sizes and
holds the kernels bit-exact against it (`ntt_checks`), forward and
inverse, with and without the scales (a per-row `pre`, a constant
`post`), at k = 1-13, 16, 18, 21-24 (NTT_CHECK_K), batches 1, 3 and
[2, 4] (the larger k with fewer), the mesh's [chunk, n1, 16] at n1 = 2
and 4, and the int16 at-rest input; `ntt_summary` gives each tree's ms
a call and device ms beside the IMAD bound (NTT_PRODUCT_SLOTS slots a
product, k 2^(k-1) products), and the checks want every ntt_pass_kernel
built without a stack frame or spills.

Each turn also reads the kernels' ptxas lines and SASS mix
(chip_smoke.py's `ptxas_entries` and `kernel_sass`; cuobjdump is
required; part k7_k8 adds K3's Jacobian kinds and K7's and K8's own
kernels, where a checkout has them; part k9_k10 K9's and K10's, with
each one's SASS an element and its issue bound, chip_smoke.py's
`exp_mul_report`).  K1's to K4's, K6's to K10's outputs (and the NTT's
and the SRS chunk's) must be the same bytes in every turn; K5's the same points (X1 Z2 = X2 Z1 and Y1 Z2
= Y2 Z1), since a redesign may add in another order.  Device times are
given for each kernel: ms a call and launches a call.  Prints one JSON
line with every turn and the card's name and power limit; the whole
record goes to --out, with part k9_k10's summary (`k9_k10_summary`:
each tree's device ms range and issue bound beside the function's bound
at each shape) and part k11's (`k11_summary`).  K11's i8dot and chain
outputs must be the same bytes in every turn.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# K3's to K6's kernels, by the names of any checkout (K5 was one
# `weighted_suffix_kernel` before its chunked form)
SCAN_NAMES = ("bucket_scan_kernel", "weighted_suffix_kernel",
              "suffix_chunk_total_kernel", "suffix_carry_kernel",
              "suffix_chunk_kernel")
# K8's and K7's kernels of the checkouts before K8 and K7 went through
# K3's launcher (`point_kernel`)
JAC_NAMES = ("jac_add_kernel", "jac_dbl_kernel", "staged_add_a_kernel",
             "staged_add_b_kernel")
# every kernel whose device time a turn reports: K1-K8's and PyTorch's
# copies
KERNEL_NAMES = SCAN_NAMES + JAC_NAMES + (
    "point_kernel", "ladder_tree_kernel", "mont_mul_kernel",
    "mont_addsub_kernel", "direct_copy") + ("mul16_kernel", "mxu_mul_kernel",
                                            "dot_chain", "op_chain_kernel") + (
    "ntt_pass_kernel", "CatArrayBatchedCopy", "vectorized_gather_kernel",
    "Memcpy HtoD")
PARTS = ("k1_k6", "k7_k8", "k9_k10", "k11", "ntt")
# part ntt: the timed sizes (log2) and calls of each; the sizes held
# bit-exact to the plain version; the IMAD pipe's slots a Montgomery
# product and its rate (the kernel table's K1 bound)
NTT_TIMED = ((21, 10), (18, 20), (13, 50))
NTT_CHECK_K = tuple(range(1, 14)) + (16, 18, 21, 22, 23, 24)
NTT_PRODUCT_SLOTS = 264
IMAD_SLOTS_S = 16.7e12
# part k11's dot widths: the JAX main's 2^14, the script docstring's 2^18
# and a ragged 2^14 - 8; its chains' lengths on 16 x 2^14 lanes
K11_DOT_W = (("2^14", 1 << 14), ("2^18", 1 << 18), ("2^14-8", (1 << 14) - 8))
K11_CHAINS = (512, 16384)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turn(tree: str, k5_out: str, parts) -> dict:
    """One turn in this process: `tree`'s package, timed."""
    sys.path.insert(0, tree)
    import torch

    cs = _chip_smoke()
    from zksnap_tpu_torch import kernels
    from zksnap_tpu_torch.curves import fused

    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        fused.__file__)))
    assert os.path.samefile(pkg_root, tree), (pkg_root, tree)
    lib = kernels.build()
    kernels.library()
    # K3's projective kinds and K6's RCB kernel beside them, and K1, K2;
    # with k7_k8 every kind of K3 and K7's and K8's own kernels
    names = SCAN_NAMES + cs.INLINED_KERNELS + ("mont_mul_kernel",
                                               "mont_addsub_kernel")
    if "k7_k8" in parts:
        names += ("point_kernel",) + JAC_NAMES
    if "ntt" in parts:
        names += ("ntt_pass_kernel",)
    with open(os.path.join(os.path.dirname(lib),
                           f"build_{kernels.source_hash()}.log")) as f:
        all_ptxas = cs.ptxas_entries(f.read())
    ptxas = {k: v for k, v in all_ptxas.items()
             if any(s in k for s in names)}
    out = {"tree": tree, "parts": list(parts), "ptxas": ptxas,
           "sass": cs.kernel_sass(lib, names)}
    dev = torch.device("cuda", 0)
    if "k1_k6" in parts:
        out.update(k1_k6(cs, dev, k5_out))
    if "k7_k8" in parts:
        out.update(k7_k8(cs, dev))
    if "k9_k10" in parts:
        out["k9_k10_kernels"] = cs.exp_mul_report(all_ptxas, lib)
        out.update(k9_k10(cs, dev))
    if "k11" in parts:
        out["k11_kernels"] = cs.dot_report(all_ptxas, lib)
        out["k11_chain_loops"] = cs.chain_loops(lib)
        out.update(k11(cs, dev))
    if "ntt" in parts:
        out.update(ntt_part(cs, dev))
    return out


def timed_calls(cs, calls: dict) -> dict:
    """For each `key: (fn, reps)`: ms a call (CUDA events) and each
    kernel's device ms a call and launches a call (the profiler)."""
    out = {}
    for key, (fn, reps) in calls.items():
        _, by = cs.device_time(lambda: [fn() for _ in range(reps)])
        out[f"{key}_ms"] = cs.cuda_ms(fn, reps)
        out[f"{key}_device_ms"] = {
            k: [v[1] / reps, v[0] / reps] for k, v in by.items()
            if any(n in k for n in KERNEL_NAMES)}
    return out


def outputs_sha256(calls: dict, keys) -> str:
    h = hashlib.sha256()
    for key in keys:
        got = calls[key][0]()
        for a in (got if isinstance(got, (tuple, list)) else [got]):
            h.update(a.cpu().numpy().tobytes())
    return h.hexdigest()


def k1_k6(cs, dev, k5_out: str) -> dict:
    """Part k1_k6: K1-K6, a forward 2^21 NTT and the warm k=13 prove."""
    import torch

    from zksnap_tpu_torch.curves import fused
    from zksnap_tpu_torch.curves.native import BN254_G1
    from zksnap_tpu_torch.fields import bn254_fq, bn254_fr
    from zksnap_tpu_torch.fields import pallas_mont as pm
    from zksnap_tpu_torch.poly.domain import domain
    from zksnap_tpu_torch.poly.ntt import ntt

    Fq, b3 = bn254_fq(), 3 * BN254_G1.b
    rng = random.Random(20261017)
    gen = torch.Generator().manual_seed(20261017)
    P, Qg, Qa = cs.point_inputs(BN254_G1, Fq, 8192, rng, dev, False)
    M, K = 32768, 128
    idx = torch.randint(0, 8192, (M * K,), generator=gen).to(dev)
    pts = tuple(a[idx] for a in Qa)
    ids = torch.sort(torch.randint(0, 2 * (1 << 15) + 1, (M * K,),
                                   generator=gen))[0]
    flags = torch.cat([torch.ones(1, dtype=torch.bool),
                       ids[1:] != ids[:-1]]).to(dev)
    W, B = 16, 1 << 15
    flat = cs.reduce_inputs(Fq, BN254_G1, W * B, rng, dev)
    # the small shapes: the k=13 fixed-base stream, the K=7 windows
    _, _, Qs = cs.point_inputs(BN254_G1, Fq, 16 * 8192, rng, dev, False)
    ids_s = torch.sort(torch.randint(0, (1 << 15) + 1, (16 * 8192,),
                                     generator=gen))[0]
    flags_s = torch.cat([torch.ones(1, dtype=torch.bool),
                         ids_s[1:] != ids_s[:-1]]).to(dev)
    W_s, B_s = 32, 128
    flat_s = cs.reduce_inputs(Fq, BN254_G1, W_s * B_s, rng, dev)
    # K3 at the k=21 lane carries: 32768 rows drawn from the 8192
    pick = torch.randint(0, 8192, (32768,), generator=gen).to(dev)
    padd21 = [a[pick] for a in P + Qg]
    # K6's window sums: the k=21 and K=7 shapes (identities, P beside -P
    # and equal sums among them), then the fit's narrower ones, general
    # points
    wsums = {(c, w): cs.reduce_inputs(Fq, BN254_G1, w, rng, dev)
             for c, w in ((16, 16), (8, 32))}
    rows = cs.reduce_inputs(Fq, BN254_G1, 24, rng, dev)
    for c, w in cs.LADDER_FIT[:-1]:
        wsums[c, w] = tuple(a[6 : 6 + w].contiguous() for a in rows)

    # K1 and K2 at the k=13 and k=21 paths' shapes and on a middle NTT
    # stage's views at 2^21 (xb[..., 1] against w[None]; K2 the even rows
    # against that product), and one forward 2^21 NTT
    Fr = bn254_fr()
    fa, fb = cs.field_inputs(Fr, 8192, rng, dev)
    pick21 = torch.randint(0, 8192, (1 << 21,), generator=gen).to(dev)
    fa21, fb21 = fa[pick21], fb[pick21]
    x21 = cs.random_canonical(1 << 21, 20261027, dev)
    u, xa, wb = cs.ntt_stage_operands(x21, 21, 10, domain(21).twiddles(dev))
    t = pm.mont_mul(xa, wb, Fr.p)

    def point(kind, ins):
        return lambda: fused.point(kind, ins, Fq.p, b3)

    def ladder(c, w):
        return lambda: fused.ladder_tree(wsums[c, w], c, w, Fq.p, b3)

    calls = {
        "k3_padd_n32768": (point("padd", padd21), 200),
        "k3_padd_n8192": (point("padd", list(P + Qg)), 200),
        "k3_pmadd_n8192": (point("pmadd", list(P + Qa)), 200),
        "k3_pdbl_n8192": (point("pdbl", list(P)), 200),
        "k4": (lambda: fused.bucket_scan(pts, flags, M, K, Fq.p, b3), 10),
        "k5": (lambda: fused.weighted_suffix(flat, B, Fq.p, b3), 5),
        "k4_k13": (lambda: fused.bucket_scan(Qs, flags_s, M, 4, Fq.p, b3),
                   50),
        "k5_k7": (lambda: fused.weighted_suffix(flat_s, B_s, Fq.p, b3), 50),
        "k6": (ladder(16, 16), 20),
        "k6_k7": (ladder(8, 32), 20)}
    field_calls = {
        "k1_n8192": (lambda: pm.mont_mul(fa, fb, Fr.p), 2000),
        "k2_n8192": (lambda: pm.mont_addsub(fa, fb, Fr.p, "add"), 2000),
        "k1_n2^21": (lambda: pm.mont_mul(fa21, fb21, Fr.p), 50),
        "k2_n2^21": (lambda: pm.mont_addsub(fa21, fb21, Fr.p, "add"), 50),
        "k1_ntt_view_s10": (lambda: pm.mont_mul(xa, wb, Fr.p), 50),
        "k2_ntt_view_s10": (lambda: pm.mont_addsub(u, t, Fr.p, "add"), 50)}
    calls.update(field_calls)
    calls["ntt_2^21"] = (lambda: ntt(21).forward(x21), 10)
    out = {}
    for tag, keys in (("k3", [k for k in calls if k.startswith("k3")]),
                      ("k4", ("k4", "k4_k13")),
                      ("k1_k2", list(field_calls) + ["ntt_2^21"])):
        out[f"{tag}_sha256"] = outputs_sha256(calls, keys)
    h = hashlib.sha256()
    for c, w in wsums:
        for a in ladder(c, w)():
            h.update(a.cpu().numpy().tobytes())
    out["k6_sha256"] = h.hexdigest()
    torch.save([[a.cpu() for a in calls[key][0]()] for key in ("k5", "k5_k7")],
               k5_out)
    out.update(timed_calls(cs, calls))
    # one warm voter prove at k=13 (chip_smoke.py's phase 4 sets it up):
    # three timed, one under the profiler
    work = tempfile.mkdtemp(prefix="ab_k13_", dir=os.path.join(ROOT, "build"))
    try:
        pk, inst = cs.phase4(dev, work, {})
        from zksnap_tpu_torch.prover.plonk import prove

        out["prove_k13_s"] = [cs.synced(lambda: prove(pk, inst))[1]
                              for _ in range(3)]
        wall, by = cs.device_time(lambda: prove(pk, inst))
        copies = [v for k, v in by.items() if "direct_copy" in k]
        out["prove_k13_profiled"] = {
            "wall_s": wall, "busy_s": sum(v[1] for v in by.values()) / 1e3,
            "direct_copy": [sum(v[0] for v in copies),
                            sum(v[1] for v in copies)],
            **{name: [sum(v[0] for k, v in by.items() if name in k),
                      sum(v[1] for k, v in by.items() if name in k)]
               for name in ("mont_mul_kernel", "mont_addsub_kernel")}}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # K4's device ms a launch against its steps a lane (M lanes, the
    # first M * K pairs of the k=21 stream): its fixed cost a launch
    # apart from its cost a step
    out["k4_by_steps"] = {}
    for steps in (1, 2, 4, 8, 16, 32, 64, 128):
        n = M * steps
        sub = tuple(a[:n] for a in pts)
        _, by = cs.device_time(lambda: [
            fused.bucket_scan(sub, flags[:n], M, steps, Fq.p, b3)
            for _ in range(20)])
        out["k4_by_steps"][steps] = sum(
            v[1] for k, v in by.items() if "bucket_scan" in k) / 20
    # K6's device ms a launch against its dependent doublings c (W - 1)
    out["k6_by_doublings"] = {}
    for c, w in cs.LADDER_FIT:
        _, by = cs.device_time(lambda: [ladder(c, w)() for _ in range(20)])
        out["k6_by_doublings"][c * (w - 1)] = sum(
            v[1] for k, v in by.items() if "ladder_tree" in k) / 20
    xs = sorted(out["k6_by_doublings"])
    a, b = cs.fit_line(xs, [out["k6_by_doublings"][x] for x in xs])
    out["k6_fit_us"] = {"a": a * 1e3, "b_per_doubling": b * 1e3}
    return out


def k7_k8(cs, dev, srs_n: int = 1 << 20) -> dict:
    """Part k7_k8: K8's add and dbl and K7 through their entry points,
    K3's Jacobian add and dbl at the first shape, and one chunk of srs_n
    points of the SRS's double-and-add."""
    import torch

    from zksnap_tpu_torch.curves import fused
    from zksnap_tpu_torch.curves import pallas_point as pp
    from zksnap_tpu_torch.curves.jacobian import bn254_ops
    from zksnap_tpu_torch.fields import bn254_fq, bn254_fr
    from zksnap_tpu_torch.prover.srs import _powers_to_points

    Fq = bn254_fq()
    p, n0 = Fq.p, Fq.n0
    rng = random.Random(20261018)
    calls = {}
    for tag, n in cs.POINT_SHAPES:
        reps = 20 if n > 32768 else 200
        P, Q, same = cs.point_batch_inputs(n, rng, dev)
        S = cs.same_point_batch(n, rng, dev)
        E, F, _ = cs.warp_mixed_batch(n, rng, dev)
        calls[f"k8_add_{tag}"] = (
            lambda P=P, Q=Q: pp.point_add_batch(P, Q, p, n0), reps)
        calls[f"k8_dbl_{tag}"] = (
            lambda P=P: pp.point_dbl_batch(P, p, n0), reps)
        calls[f"k7_{tag}"] = (
            lambda P=P, Q=Q: pp.point_add_staged(P, Q, p, n0), reps)
        calls[f"k8_add_p_eq_q_{tag}"] = (
            lambda S=S: pp.point_add_batch(S[0], S[1], p, n0), reps)
        calls[f"k8_add_warp_mixed_{tag}"] = (
            lambda E=E, F=F: pp.point_add_batch(E, F, p, n0), reps)
        if tag == cs.POINT_SHAPES[0][0]:
            calls[f"k3_add_{tag}"] = (
                lambda P=P, Q=Q: fused.point("add", list(P + Q), p), reps)
            calls[f"k3_dbl_{tag}"] = (
                lambda P=P: fused.point("dbl", list(P), p), reps)
    out = {"k7_k8_sha256": outputs_sha256(calls, list(calls))}
    out.update(timed_calls(cs, calls))
    # one chunk of the SRS's double-and-add: 2^20 scalars below r
    Fr = bn254_fr()
    scalars = [rng.randrange(Fr.p) for _ in range(srs_n)]
    ops = bn254_ops()
    got = _powers_to_points(ops, scalars, dev)
    out["srs_chunk_sha256"] = hashlib.sha256(b"".join(
        a.cpu().numpy().tobytes() for a in (got.x, got.y, got.z))).hexdigest()
    del got
    wall, by = cs.device_time(lambda: _powers_to_points(ops, scalars, dev))
    out["srs_chunk"] = {"n": len(scalars), "wall_s": wall,
                        "device_ms": {k: v[::-1] for k, v in by.items()}}
    torch.cuda.empty_cache()
    return out


def k9_k10(cs, dev) -> dict:
    """Part k9_k10: K9's B and C at n = 2^20 and its chains at 2^18, K10's
    six variants at B = 2^18 and 2^20."""
    import numpy as np

    from zksnap_tpu_torch.experiments import exp_mul_mxu as mx
    from zksnap_tpu_torch.experiments import exp_mul_variants as mv

    rng = np.random.default_rng(20261019)
    p, r = mv.FQ.p, mx.FR.p
    n = 1 << cs.EXP_N_LOG
    a = cs.limb_rows(rng, n, 0x2FFF, dev, edge=(0, 1, p - 1, p - 2))
    b = cs.limb_rows(rng, n, 0x2FFF, dev, edge=(p - 1, 0, p - 1, 1))
    aq, bq = a[:, :n // 4].contiguous(), b[:, :n // 4].contiguous()
    calls = {"k9_B_2^20": (lambda: mv.mul_limb_major(a, b, p), 50),
             "k9_C_2^20": (lambda: mv.mul_limb_major(a, b, p, rolled=True),
                           20)}
    for k in mv.CHAINS:
        calls[f"k9_B_x{k}_2^18"] = (
            lambda k=k: mv.mul_limb_major(aq, bq, p, n_muls=k), 20)
    top = (1 << 256) - 1
    for log_b in (cs.EXP_B_LOG, cs.EXP_N_LOG):
        x = cs.limb_rows(rng, 1 << log_b, 0xFFFF, dev, edge=(0, 1, r - 1, top))
        y = cs.limb_rows(rng, 1 << log_b, 0xFFFF, dev, edge=(r - 1, 0, r - 1,
                                                             top))
        for v in mx.VARIANTS:
            calls[f"k10_{v}_2^{log_b}"] = (
                lambda v=v, x=x, y=y: mx.mont_mul_mxu(x, y, v, r), 50)
    out = {"k9_k10_sha256": outputs_sha256(calls, list(calls))}
    out.update(timed_calls(cs, calls))
    return out


def k11(cs, dev) -> dict:
    """Part k11: K11's dots (64 products) at K11_DOT_W, in each design that
    the tree has (`exp_vpu_rates.DOT_DESIGNS`; the default one under the
    plain key), each held to its plain version (i8dot bit-exact, bf16dot
    within chip_smoke.BF16_TOL of max |acc|); its five chains on 16 x 2^14
    lanes at K11_CHAINS steps, bit-exact at 512.  The hash covers the
    default design's i8dot outputs and the chains', which every checkout
    has."""
    import numpy as np
    import torch

    from zksnap_tpu_torch.experiments import exp_vpu_rates as vr

    rng = np.random.default_rng(20261020)
    default = getattr(vr, "DOT_DESIGN", None)
    designs = getattr(vr, "DOT_DESIGNS", (None,))
    calls, errs, exact = {}, {}, []
    for tag, W in K11_DOT_W:
        for kind in vr.DOT_KINDS:
            _, (lhs, x0) = vr.make_dot(kind, W, vr.N_MM,
                                       *cs.dot_sides(rng, kind, W), device=dev)
            want = vr.dot_chain_plain(kind, lhs, x0, vr.N_MM)
            for d in designs:
                kw = {} if d is None else {"design": d}
                key = f"k11_{kind}" + ("" if d == default else f"_{d}") \
                    + f"_{tag}"

                def fn(kind=kind, lhs=lhs, x0=x0, kw=kw):
                    return vr.dot_chain(kind, lhs, x0, vr.N_MM, **kw)
                got = fn()
                if kind == "i8dot":
                    errs[key] = cs.max_abs_err([got], [want])
                    cs.require(errs[key] == 0, ("K11", key, errs[key]))
                    if d == default:  # the keys every checkout has
                        exact.append(key)
                else:
                    errs[key] = float((got - want).abs().max()
                                      / want.abs().max())
                    cs.require(errs[key] <= cs.BF16_TOL, ("K11", key,
                                                         errs[key]))
                calls[key] = (fn, 200 if W < 1 << 16 else 50)
    W = 1 << cs.EXP_W_LOG
    a, b = cs.u32_rows(rng, W, dev), cs.u32_rows(rng, W, dev)
    for kind in vr.CHAIN_KINDS:
        cs.require(torch.equal(vr.op_chain(kind, a, b, K11_CHAINS[0]),
                               vr.op_chain_plain(kind, a, b, K11_CHAINS[0])),
                   ("K11 chain", kind))
        for chain in K11_CHAINS:
            key = f"k11_{kind}_c{chain}"
            calls[key] = (lambda kind=kind, chain=chain: vr.op_chain(
                kind, a, b, chain), 200 if chain <= 512 else 20)
            exact.append(key)
    out = {"k11_sha256": outputs_sha256(calls, exact), "k11_errors": errs}
    out.update(timed_calls(cs, calls))
    return out


def k11_summary(record: dict) -> dict:
    """{shape: {"bound_ms", "bound_by", tree: {"device_ms": [lo, hi],
    "ms": [lo, hi]}}} over a k11 record's turns: each tree's device and
    call ms (the range over its turns) beside the function's bound
    (chip_smoke.dot_bound; a chain's from its loop, chain_step_rate, the
    loop in this tree's first turn)."""
    cs = _chip_smoke()
    from zksnap_tpu_torch.experiments import exp_vpu_rates as vr

    widths = dict(K11_DOT_W)
    loops = next(t["k11_chain_loops"] for t in record["turns"]
                 if os.path.samefile(t["tree"], ROOT))
    lanes = 16 * (1 << cs.EXP_W_LOG)
    out = {}
    for t in record["turns"]:
        tree = os.path.basename(os.path.normpath(t["tree"]))
        for key in t:
            if not (key.startswith("k11_") and key.endswith("_device_ms")):
                continue
            shape = key[len("k11_"):-len("_device_ms")]
            kind, size = shape.split("_")[0], shape.split("_")[-1]
            if kind in vr.DOT_KINDS:
                b = cs.dot_bound(kind, widths[size], vr.N_MM)
            else:
                chain = int(size[1:])
                rate = cs.chain_step_rate(loops[kind], vr.CHAIN_UNROLL)
                b = cs.bound(lanes * chain, lanes * 12, rate)
            r = out.setdefault(shape, b)
            dev_ms = sum(v[0] for v in t[key].values())
            ms = t[f"k11_{shape}_ms"]
            old = r.get(tree, {"device_ms": [dev_ms] * 2, "ms": [ms] * 2})
            r[tree] = {"device_ms": [min(old["device_ms"][0], dev_ms),
                                     max(old["device_ms"][1], dev_ms)],
                       "ms": [min(old["ms"][0], ms), max(old["ms"][1], ms)]}
    return out


def k9_k10_summary(record: dict) -> dict:
    """{shape: {"bound_ms", "bound_by", tree: {"device_ms": [lo, hi],
    "issue_bound_ms", "issue_bound_by"}}} over a k9_k10 record's turns:
    each tree's device ms a call (the range over its turns), the
    function's bound (chip_smoke.bound: MUL_OPS a product, or the 256-bit
    product's for K10's ablations, and 192 bytes an element) and the issue
    bound of the tree's compiled SASS (chip_smoke.issue_bound)."""
    cs = _chip_smoke()
    out = {}
    for t in record["turns"]:
        tree = os.path.basename(os.path.normpath(t["tree"]))
        sass = {cs.exp_kernel_key(k): r["an_element"]
                for k, r in t["k9_k10_kernels"].items()}
        for key in t:
            if not (key.startswith(("k9_", "k10_"))
                    and key.endswith("_device_ms")):
                continue
            shape = key[:-len("_device_ms")]
            kind, *mid, size = shape.split("_")
            n = 1 << int(size.split("^")[1])
            if kind == "k9":
                muls = int(mid[1][1:]) if len(mid) > 1 else 1
                kernel = f"mul16_kernel<{int(mid[0] == 'C')}>"
                tag = mid[0] if muls == 1 else f"B x{muls}"
                ops = n * muls * cs.MUL_OPS
            else:
                from zksnap_tpu_torch.experiments import exp_mul_mxu as mx

                v = "_".join(mid)
                kernel, tag = f"mxu_mul_kernel<{mx.VARIANTS.index(v)}>", ""
                ops = n * (cs.MUL_OPS if v in mx.PRODUCTS else cs.PRODUCT_OPS)
            r = out.setdefault(shape, cs.bound(ops, n * 3 * cs.ROW))
            ms = sum(v[0] for v in t[key].values())
            lo, hi = r.get(tree, {}).get("device_ms", [ms, ms])
            r[tree] = {"device_ms": [min(lo, ms), max(hi, ms)],
                       **{k: v for k, v in cs.issue_bound(
                           sass[kernel][tag], n, n * 3 * cs.ROW).items()
                          if k != "clocks_an_element"}}
    return out


def _ntt_rows(rng, shape, dev):
    """Seeded canonical Montgomery rows of `shape` (..., 16): random
    16-bit limbs under p's top limb, the first rows 0 and p - 1."""
    import numpy as np
    import torch

    from zksnap_tpu_torch.fields import bn254_fr, ints_to_limbs

    x = rng.integers(0, 1 << 16, shape, dtype=np.int64)
    x[..., -1] &= 0x1FFF
    flat = x.reshape(-1, 16)
    flat[0] = 0
    flat[-1] = ints_to_limbs([bn254_fr().p - 1])[0]
    return torch.from_numpy(x.astype(np.int32)).to(dev)


def ntt_checks(dev) -> dict:
    """The NTT kernels against their plain version on the card, bit for
    bit: each case forward and inverse, plain, with the scales, and with
    the int16 at-rest input and the scales."""
    import importlib

    import numpy as np
    import torch

    from zksnap_tpu_torch.fields import bn254_fr
    from zksnap_tpu_torch.poly.domain import domain
    from zksnap_tpu_torch.prover.poly_device import pack_poly

    nt = importlib.import_module("zksnap_tpu_torch.poly.ntt")
    F = bn254_fr()
    rng = np.random.default_rng(20261017)
    cases = []
    for k in NTT_CHECK_K:
        lead = [()] + ([(3,)] if k <= 21 else []) + ([(2, 4)] if k <= 13
                                                      else [])
        cases += [(k, s) for s in lead]
    cases += [(1, (1 << 18,)), (2, (1 << 17,))]   # the mesh's [chunk, n1]
    failed, n_cases = [], 0
    for k, lead in cases:
        n = 1 << k
        x = _ntt_rows(rng, (*lead, n, 16), dev)
        pre = _ntt_rows(rng, (n, 16), dev)
        d = domain(k)
        for inverse in (False, True):
            tw = d.twiddles_inv(dev) if inverse else d.twiddles(dev)
            post = F.const_t(d.n_inv if inverse else 5, dev)
            for scaled, packed in ((False, False), (True, False),
                                   (True, True)):
                kw = {"pre": pre, "post": post} if scaled else {}
                got = nt.ntt_kernel(pack_poly(x) if packed else x, tw, k, F,
                                    **kw)
                want = nt._ntt_plain(F.mul(x, pre) if scaled else x, tw, k,
                                     F)
                if scaled:
                    want = F.mul(want, post)
                n_cases += 1
                if not torch.equal(got, want):
                    failed.append([k, list(lead), inverse, scaled, packed])
        del x, pre
        torch.cuda.empty_cache()
    return {"cases": n_cases, "failed": failed, "ok": not failed}


def ntt_part(cs, dev) -> dict:
    """Part ntt: the checkout's `_ntt_impl` at NTT_TIMED; with the
    kernels, the plain version's time and `ntt_checks`."""
    import importlib

    import numpy as np

    from zksnap_tpu_torch.fields import bn254_fr
    from zksnap_tpu_torch.poly.domain import domain

    nt = importlib.import_module("zksnap_tpu_torch.poly.ntt")
    F = bn254_fr()
    rng = np.random.default_rng(20261018)
    calls, plain = {}, {}
    for k, reps in NTT_TIMED:
        x = _ntt_rows(rng, (1 << k, 16), dev)
        tw = domain(k).twiddles(dev)
        calls[f"ntt_2^{k}"] = (
            lambda x=x, tw=tw, k=k: nt._ntt_impl(x, tw, k, F), reps)
        if hasattr(nt, "_ntt_plain"):
            plain[f"ntt_plain_2^{k}"] = (
                lambda x=x, tw=tw, k=k: nt._ntt_plain(x, tw, k, F), reps)
    out = {"ntt_sha256": outputs_sha256(calls, list(calls))}
    out.update(timed_calls(cs, calls))
    if plain:
        out.update(timed_calls(cs, plain))
        out["ntt_checks"] = ntt_checks(dev)
    return out


def ntt_summary(record: dict) -> dict:
    """Each tree's ms a call and device ms of part ntt at each size, with
    the IMAD bound."""
    out = {}
    for k, _ in NTT_TIMED:
        key = f"ntt_2^{k}"
        bound = k * (1 << (k - 1)) * NTT_PRODUCT_SLOTS / IMAD_SLOTS_S * 1e3
        row = {"bound_ms": bound}
        for t in record["turns"]:
            tree = "this" if t["tree"] == ROOT else t["tree"]
            dev_ms = sum(v[0] for v in t[f"{key}_device_ms"].values())
            row.setdefault(tree, []).append(
                {"ms": t[f"{key}_ms"], "device_ms": dev_ms,
                 "plain_ms": t.get(f"ntt_plain_{key[4:]}_ms")})
        out[key] = row
    return out


def same_points(a, b) -> bool:
    """Two projective point lists on the card are the same points."""
    import torch

    from zksnap_tpu_torch.fields import bn254_fq
    from zksnap_tpu_torch.fields.pallas_mont import mont_mul

    p = bn254_fq().p
    dev = torch.device("cuda", 0)
    (x1, y1, z1), (x2, y2, z2) = ([t.to(dev) for t in a],
                                  [t.to(dev) for t in b])
    return bool(torch.equal(mont_mul(x1, z2, p), mont_mul(x2, z1, p))
                and torch.equal(mont_mul(y1, z2, p), mont_mul(y2, z1, p))
                and torch.equal(z1.eq(0).all(-1), z2.eq(0).all(-1)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="+")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "ab.json"))
    ap.add_argument("--parts", default="k1_k6,k7_k8",
                    help="comma-separated parts to run: " + ", ".join(PARTS))
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("--k5-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    parts = tuple(args.parts.split(","))
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts: unknown part in {args.parts!r}")
    if args.turn:
        print(json.dumps(turn(args.turn, args.k5_out, parts)))
        return
    import torch

    sys.path.insert(0, ROOT)
    others = [os.path.abspath(o) for o in args.others]
    work = os.path.join(ROOT, "build", "ab")
    os.makedirs(work, exist_ok=True)
    turns = []
    order = others + [ROOT, ROOT] + others[::-1]
    for i, tree in enumerate(order):
        k5_out = os.path.join(work, f"k5_{i}.pt")
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree,
             "--turn", tree, "--k5-out", k5_out, "--parts", args.parts],
            stdout=subprocess.PIPE, text=True, check=True)
        turns.append(json.loads(res.stdout.strip().splitlines()[-1]))
        t = turns[-1]
        print(json.dumps({k: v for k, v in t.items()
                          if k not in ("ptxas", "sass")}), flush=True)
    same = (("k1_k2", "k3", "k4", "k6") if "k1_k6" in parts else ()) + (
        ("k7_k8", "srs_chunk") if "k7_k8" in parts else ()) + (
        ("k9_k10",) if "k9_k10" in parts else ()) + (
        ("k11",) if "k11" in parts else ()) + (
        ("ntt",) if "ntt" in parts else ())
    checks = {f"{k}_same_bytes": len({t[f"{k}_sha256"] for t in turns}) == 1
              for k in same}
    if "k1_k6" in parts:
        k5 = [torch.load(os.path.join(work, f"k5_{i}.pt"))
              for i in range(len(order))]
        checks["k5_same_points"] = all(same_points(k5[0][j], k5[i][j])
                                       for i in range(1, len(order))
                                       for j in (0, 1))
    if "ntt" in parts:
        mine = [t for t in turns if "ntt_checks" in t]
        checks["ntt_bit_exact"] = bool(mine) and all(
            t["ntt_checks"]["ok"] for t in mine)
        checks["ntt_no_stack_or_spills"] = bool(mine) and all(
            v.get("stack_bytes") == 0 and v.get("spill_stores") == 0
            and v.get("spill_loads") == 0
            for t in mine for name, v in t["ptxas"].items()
            if "ntt_pass_kernel" in name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    line = {"turns": turns, **checks, "nvidia_smi": smi}
    if "k9_k10" in parts:
        line["k9_k10_summary"] = k9_k10_summary(line)
    if "k11" in parts:
        line["k11_summary"] = k11_summary(line)
    if "ntt" in parts:
        line["ntt_summary"] = ntt_summary(line)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(line, f, indent=1)
    print(json.dumps({**checks, "nvidia_smi": smi}))
    if not all(checks.values()):
        sys.exit(f"torch_kernel_ab: checks failed: {checks}")


if __name__ == "__main__":
    main()
