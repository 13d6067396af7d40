"""Time the port's K1 and K2 (the field kernels), K3 (point formulas),
K4 (bucket scan), K5 (weighted suffix) and K6 (ladder and tree) in other
checkouts and this one on one card, in turns.

    python3 scripts/torch_kernel_ab.py OTHER_DIR [OTHER_DIR ...] [--out chiprun_out/ab.json]

Each OTHER_DIR holds another checkout's `zksnap_tpu_torch` (for example
the parent commit: `git archive <commit> zksnap_tpu_torch | tar -x -C
build/parent`).  The turns run the others, this tree twice, then the
others in reverse (one other: OTHER, this, this, OTHER).  Each turn is
a process of its own with one checkout first on sys.path: it builds that
checkout's kernels (kept in the checkout's own build directory), makes
the same seeded inputs, calls the checkout's own `mont_mul`,
`mont_addsub`, `point`, `bucket_scan`, `weighted_suffix` and
`ladder_tree`, and reads CUDA events over repeated calls and the
profiler's device time of each kernel.  The shapes:

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

Each turn also reads the kernels' ptxas lines and SASS mix
(chip_smoke.py's `ptxas_entries` and `kernel_sass`; cuobjdump is
required).  K1's to K4's and K6's outputs (and the NTT's) must be the
same bytes in every turn; K5's the same points (X1 Z2 = X2 Z1 and Y1 Z2
= Y2 Z1), since a redesign may add in another order.  Device times are
given for each kernel: ms a call and launches a call.  Prints one JSON
line with every turn and the card's name and power limit; the whole
record goes to --out.
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
# every kernel whose device time a turn reports: K1-K6's and PyTorch's
# copies
KERNEL_NAMES = SCAN_NAMES + ("point_kernel", "ladder_tree_kernel",
                             "mont_mul_kernel", "mont_addsub_kernel",
                             "direct_copy")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turn(tree: str, k5_out: str) -> dict:
    """One turn in this process: `tree`'s package, timed."""
    sys.path.insert(0, tree)
    import torch

    cs = _chip_smoke()
    from zksnap_tpu_torch import kernels
    from zksnap_tpu_torch.curves import fused
    from zksnap_tpu_torch.curves.native import BN254_G1
    from zksnap_tpu_torch.fields import bn254_fq, bn254_fr
    from zksnap_tpu_torch.fields import pallas_mont as pm
    from zksnap_tpu_torch.poly.domain import domain
    from zksnap_tpu_torch.poly.ntt import ntt

    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        fused.__file__)))
    assert os.path.samefile(pkg_root, tree), (pkg_root, tree)
    lib = kernels.build()
    kernels.library()
    # K3's projective kinds and K6's RCB kernel beside them, and K1, K2
    names = SCAN_NAMES + cs.INLINED_KERNELS + ("mont_mul_kernel",
                                               "mont_addsub_kernel")
    with open(os.path.join(os.path.dirname(lib),
                           f"build_{kernels.source_hash()}.log")) as f:
        ptxas = {k: v for k, v in cs.ptxas_entries(f.read()).items()
                 if any(s in k for s in names)}
    sass = cs.kernel_sass(lib, names)
    dev = torch.device("cuda", 0)
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
    out = {"tree": tree, "ptxas": ptxas, "sass": sass}
    for tag, keys in (("k3", [k for k in calls if k.startswith("k3")]),
                      ("k4", ("k4", "k4_k13")),
                      ("k1_k2", list(field_calls) + ["ntt_2^21"])):
        h = hashlib.sha256()
        for key in keys:
            got = calls[key][0]()
            for a in (got if isinstance(got, (tuple, list)) else [got]):
                h.update(a.cpu().numpy().tobytes())
        out[f"{tag}_sha256"] = h.hexdigest()
    h = hashlib.sha256()
    for c, w in wsums:
        for a in ladder(c, w)():
            h.update(a.cpu().numpy().tobytes())
    out["k6_sha256"] = h.hexdigest()
    torch.save([[a.cpu() for a in calls[key][0]()] for key in ("k5", "k5_k7")],
               k5_out)
    for key, (fn, reps) in calls.items():
        _, by = cs.device_time(lambda: [fn() for _ in range(reps)])
        out[f"{key}_ms"] = cs.cuda_ms(fn, reps)
        # each kernel's device ms a call and launches a call
        out[f"{key}_device_ms"] = {
            k: [v[1] / reps, v[0] / reps] for k, v in by.items()
            if any(n in k for n in KERNEL_NAMES)}
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
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("--k5-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(turn(args.turn, args.k5_out)))
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
             "--turn", tree, "--k5-out", k5_out],
            stdout=subprocess.PIPE, text=True, check=True)
        turns.append(json.loads(res.stdout.strip().splitlines()[-1]))
        t = turns[-1]
        print(json.dumps({k: v for k, v in t.items()
                          if k not in ("ptxas", "sass")}), flush=True)
    k5 = [torch.load(os.path.join(work, f"k5_{i}.pt"))
          for i in range(len(order))]
    checks = {f"{k}_same_bytes": len({t[f"{k}_sha256"] for t in turns}) == 1
              for k in ("k1_k2", "k3", "k4", "k6")}
    checks["k5_same_points"] = all(same_points(k5[0][j], k5[i][j])
                                   for i in range(1, len(order))
                                   for j in (0, 1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    line = {"turns": turns, **checks, "nvidia_smi": smi}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(line, f, indent=1)
    print(json.dumps({**checks, "nvidia_smi": smi}))
    if not all(checks.values()):
        sys.exit(f"torch_kernel_ab: checks failed: {checks}")


if __name__ == "__main__":
    main()
