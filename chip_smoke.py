"""Drive the PyTorch port (zksnap_tpu_torch) through its main path on one
CUDA GPU and check it: the quickest proof that the port still starts.

    python3 chip_smoke.py

Phases:
  1. build the four hand-written CUDA kernels from csrc/ (nvcc, timed);
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (n = 8192 field elements and points; the
     fixed-base bucket stream of 16 * 8192 pairs), edge cases included,
     bit-exact, and time both;
  3. K=7 parity with the frozen JAX vectors: the port's keygen gives the
     frozen vk digest and the port's verifier accepts the frozen proof;
  4. the main path: voter circuit at k=13 (check_plume=False), SRS made on
     the card in a fresh directory, keygen (vk digest against the frozen
     JAX digest), a cold and a warm proof, verification, and a tampered
     proof rejected;
  5. the kernels' launch counts over phase 4, each required > 0;
  6. one more warm proof under torch.profiler: the device's busy share
     and the kernels that hold it;
  7. the card's name and power limit.

Phase 2's per-call times come from CUDA events over repeated calls and
include the host's launch path; the device time per launch comes from
the profiler.  Details go to chiprun_out/chip_smoke.json.

Exits non-zero, with no result line, when there is no CUDA device or any
check fails.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
VECTORS = os.path.join(ROOT, "tests", "vectors")


def log(*a):
    print(*a, flush=True)


def require(ok, what):
    """A check of the run: raise (and so exit non-zero) when it fails."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def vk_digest(vk) -> str:
    h = hashlib.sha256()
    for name in sorted(vk.commitments):
        pt = vk.commitments[name]
        x, y = (0, 0) if pt.is_identity() else (pt.x, pt.y)
        h.update(name.encode() + x.to_bytes(32, "little")
                 + y.to_bytes(32, "little"))
    return h.hexdigest()


def build_fixed_circuit():
    """The frozen K=7 circuit of scripts/gen_protocol_vectors.py."""
    from zksnap_tpu_torch.trace import Context

    ctx = Context(lookup_bits=6)
    a = ctx.load_witness(7)
    b = ctx.load_witness(9)
    c = ctx.mul(a, b)
    d = ctx.add(c, ctx.load_constant(5))
    ctx.range_check(ctx.load_witness(37), 6)
    sel = ctx.load_witness(1)
    e = ctx.select(a, b, sel)
    ctx.constrain_equal(e, a)
    ctx.expose_public(d)
    return ctx


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn over `reps` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time(fn) -> tuple[float, dict]:
    """One call of fn under torch.profiler's CUDA activity: (wall seconds,
    {device activity name: [count, total ms]}); the dict is empty when the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c = by_name.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.elapsed_us() / 1e3
    return wall, by_name


def kernel_device_ms(fn, symbol: str, reps: int = 20):
    """Device milliseconds per launch of the kernel whose name holds
    `symbol`, over `reps` calls of fn; None where not measured."""
    _, by_name = device_time(lambda: [fn() for _ in range(reps)])
    hits = [v for k, v in by_name.items() if symbol in k]
    if not hits:
        return None
    return sum(v[1] for v in hits) / sum(v[0] for v in hits)


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def max_abs_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        require(g.shape == w.shape, (g.shape, w.shape))
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


# -- phase 2 inputs -----------------------------------------------------------

def field_inputs(F, n: int, rng, dev):
    """n pairs of Montgomery operands, edge values first."""
    p = F.p
    edge = [0, 1, p - 1, p - 2, 1, 0, p - 1]
    edge_b = [p - 1, p - 1, p - 1, 1, 0, 0, 2]
    xs = edge + [rng.randrange(p) for _ in range(n - len(edge))]
    ys = edge_b + [rng.randrange(p) for _ in range(n - len(edge_b))]
    return F.to_mont(xs, dev), F.to_mont(ys, dev)


def point_inputs(curve, F, n: int, rng, dev, jacobian: bool):
    """(P, Q_general, Q_affine) coordinate lists of n points each.

    P and Q_general carry random non-trivial z (projective: (lx, ly, l);
    Jacobian: (l^2 x, l^3 y, l)); Q_affine has z = 1 or, for identities,
    the stream encoding (0, 0, 0).  The first rows are edge cases:
    identity operands, P == Q, P == -Q."""
    from zksnap_tpu_torch.curves.native import AffinePoint

    q = curve.p
    g = AffinePoint.generator(curve)
    pool = [rng.randrange(1, curve.n) * g for _ in range(48)]
    ident = AffinePoint.identity(curve)

    def enc(pt, lam):
        if pt.is_identity():
            return ((lam * lam % q, lam * lam * lam % q, 0) if jacobian
                    else (0, lam, 0))
        if jacobian:
            return (lam * lam * pt.x % q, lam * lam * lam * pt.y % q, lam)
        return (lam * pt.x % q, lam * pt.y % q, lam)

    def aff(pt):
        return (0, 0, 0) if pt.is_identity() else (pt.x, pt.y, 1)

    ps, qs = [], []
    a, b = pool[0], pool[1]
    edge = [(ident, a), (a, ident), (ident, ident), (a, a), (b, -b),
            (a, b), (b, b), (a, -a)]
    for pa, qa in edge:
        ps.append(pa)
        qs.append(qa)
    while len(ps) < n:
        ps.append(pool[rng.randrange(len(pool))])
        qs.append(ident if rng.random() < 0.05
                  else pool[rng.randrange(len(pool))])
    P = [enc(pt, rng.randrange(1, q)) for pt in ps]
    Qg = [enc(pt, rng.randrange(1, q)) for pt in qs]
    Qa = [aff(pt) for pt in qs]

    def tensors(rows):
        return tuple(F.to_mont([r[i] for r in rows], dev) for i in range(3))

    return tensors(P), tensors(Qg), tensors(Qa)


def phase2(dev, rng, results):
    from zksnap_tpu_torch.curves import fused
    from zksnap_tpu_torch.curves.native import BN254_G1, SECP256K1
    from zksnap_tpu_torch.fields import bn254_fq, bn254_fr, secp256k1_fp
    from zksnap_tpu_torch.fields import pallas_mont as pm
    from zksnap_tpu_torch.msm.pippenger import CUDA_LANES

    n = 8192
    fields = [bn254_fr(), bn254_fq(), secp256k1_fp()]

    # K1 / K2: every field, edge values, and a broadcast operand
    k1_err = k2_err = 0
    for F in fields:
        a, b = field_inputs(F, n, rng, dev)
        k1_err = max(k1_err, max_abs_err(
            [pm.mont_mul(a, b, F.p), pm.mont_mul(a, b[3], F.p)],
            [pm.mont_mul_plain(a, b, F.p), pm.mont_mul_plain(a, b[3], F.p)]))
        for mode in ("add", "sub"):
            k2_err = max(k2_err, max_abs_err(
                [pm.mont_addsub(a, b, F.p, mode),
                 pm.mont_addsub(b[5], a, F.p, mode)],
                [pm.mont_addsub_plain(a, b, F.p, mode),
                 pm.mont_addsub_plain(b[5], a, F.p, mode)]))
    require(k1_err == 0 and k2_err == 0, (k1_err, k2_err))
    F = bn254_fr()
    a, b = field_inputs(F, n, rng, dev)
    results["K1"] = dict(
        max_abs_err=k1_err,
        ms=cuda_ms(lambda: pm.mont_mul(a, b, F.p), 200),
        plain_ms=cuda_ms(lambda: pm.mont_mul_plain(a, b, F.p), 5))
    results["K2"] = dict(
        max_abs_err=k2_err,
        ms=cuda_ms(lambda: pm.mont_addsub(a, b, F.p, "add"), 200),
        plain_ms=cuda_ms(lambda: pm.mont_addsub_plain(a, b, F.p, "add"), 5))
    results["K1"]["device_ms"] = kernel_device_ms(
        lambda: pm.mont_mul(a, b, F.p), "mont_mul_kernel")
    results["K2"]["device_ms"] = kernel_device_ms(
        lambda: pm.mont_addsub(a, b, F.p, "add"), "mont_addsub_kernel")
    for name in ("K1", "K2"):
        log(f"{name} bit-exact over bn254 Fr/Fq, secp256k1 Fp (n={n}): "
            f"kernel {results[name]['ms']:.4f} ms a call "
            f"({fmt_ms(results[name]['device_ms'])} on the device), plain "
            f"{results[name]['plain_ms']:.4f} ms")

    # K3: six kinds; projective kinds on BN254, Jacobian on BN254 and secp
    k3_err = 0
    k3_ms = {}
    cases = [(BN254_G1, bn254_fq(), False), (BN254_G1, bn254_fq(), True),
             (SECP256K1, secp256k1_fp(), True)]
    for curve, Fq, jac in cases:
        P, Qg, Qa = point_inputs(curve, Fq, n, rng, dev, jac)
        b3 = 0 if jac else 3 * curve.b
        kinds = (("add", P + Qg), ("madd", P + Qa), ("dbl", P)) if jac else (
            ("padd", P + Qg), ("pmadd", P + Qa), ("pdbl", P))
        for kind, ins in kinds:
            got = fused.point(kind, list(ins), Fq.p, b3)
            want = fused.point_plain(kind, list(ins), Fq.p, b3)
            err = max_abs_err(got, want)
            require(err == 0, (curve.name, kind, err))
            k3_err = max(k3_err, err)
            if curve is BN254_G1:
                k3_ms[kind] = (
                    cuda_ms(lambda: fused.point(kind, list(ins), Fq.p, b3), 50),
                    cuda_ms(lambda: fused.point_plain(kind, list(ins), Fq.p,
                                                      b3), 2),
                    kernel_device_ms(
                        lambda: fused.point(kind, list(ins), Fq.p, b3),
                        "point_kernel"))
    for kind, (ms, pms, dms) in k3_ms.items():
        log(f"K3 {kind:5s} bit-exact (n={n}): kernel {ms:.4f} ms a call "
            f"({fmt_ms(dms)} on the device), plain {pms:.4f} ms")
    results["K3"] = dict(max_abs_err=k3_err, ms=k3_ms["padd"][0],
                         plain_ms=k3_ms["padd"][1], device_ms=k3_ms["padd"][2])
    results["K3_kinds"] = {kind: {"ms": ms, "plain_ms": pms, "device_ms": dms}
                           for kind, (ms, pms, dms) in k3_ms.items()}

    # K4: the fixed-base stream at k=13: 16 windows * 8192 pairs into
    # 2^15 signed buckets, sorted, identities encoded (0, 0, 0)
    Fq = bn254_fq()
    pairs, buckets = 16 * n, 1 << 15
    M = CUDA_LANES
    K = pairs // M
    _, _, Qa = point_inputs(BN254_G1, Fq, pairs, rng, dev, False)
    ids = torch.sort(torch.randint(0, buckets + 1, (pairs,),
                                   generator=torch.Generator().manual_seed(7)))[0]
    flags = torch.cat([torch.ones(1, dtype=torch.bool),
                       ids[1:] != ids[:-1]]).to(dev)
    got = fused.bucket_scan(Qa, flags, M, K, Fq.p, 3 * BN254_G1.b)
    want = fused.bucket_scan_plain(Qa, flags, M, K, Fq.p, 3 * BN254_G1.b)
    k4_err = max_abs_err(got, want)
    require(k4_err == 0, k4_err)
    results["K4"] = dict(
        max_abs_err=k4_err,
        ms=cuda_ms(lambda: fused.bucket_scan(Qa, flags, M, K, Fq.p, 9), 20),
        plain_ms=cuda_ms(lambda: fused.bucket_scan_plain(
            Qa, flags, M, K, Fq.p, 9), 2))
    results["K4"]["device_ms"] = kernel_device_ms(
        lambda: fused.bucket_scan(Qa, flags, M, K, Fq.p, 9),
        "bucket_scan_kernel")
    log(f"K4 bucket scan bit-exact (M={M} lanes x K={K} steps): kernel "
        f"{results['K4']['ms']:.4f} ms a call "
        f"({fmt_ms(results['K4']['device_ms'])} on the device), plain "
        f"{results['K4']['plain_ms']:.4f} ms")


def phase3(dev, srs_dir):
    from zksnap_tpu_torch.prover.plonk import keygen, verify
    from zksnap_tpu_torch.prover.srs import gen_srs

    with open(os.path.join(VECTORS, "transcript_v1.json")) as f:
        v = json.load(f)["proof_k7"]
    srs = gen_srs(7, cache_dir=srs_dir, device=dev)
    pk = keygen(build_fixed_circuit(), 7, srs)
    got = vk_digest(pk.vk)
    require(got == v["vk_sha256"], (got, v["vk_sha256"]))
    proof = bytes.fromhex(v["proof_hex"])
    inst = [int(x) for x in v["instances"]]
    require(verify(pk.vk, srs.g2, srs.tau_g2, inst, proof),
            "the frozen K=7 proof does not verify")
    log(f"K=7: vk digest {got[:16]}... equals the frozen JAX digest; "
        "the frozen proof verifies")


def phase4(dev, srs_dir, times):
    from zksnap_tpu_torch.circuits.voter import VoterFlags, voter_circuit
    from zksnap_tpu_torch.natives import generate_random_voter_circuit_inputs
    from zksnap_tpu_torch.prover.plonk import keygen, prove, verify
    from zksnap_tpu_torch.prover.srs import gen_srs
    from zksnap_tpu_torch.trace import Context, check

    with open(os.path.join(VECTORS, "torch_port_v1.json")) as f:
        v = json.load(f)["voter_k13"]
    k = v["k"]
    t0 = time.time()
    inp = generate_random_voter_circuit_inputs(random.Random(v["inputs_seed"]))
    ctx = Context(lookup_bits=v["lookup_bits"])
    pub = []
    voter_circuit(ctx, inp, pub, VoterFlags(check_plume=False))
    inst = [c.value for c in pub]
    check(ctx, inst)
    require([str(x) for x in inst] == v["instances"],
            "voter instances differ from the frozen ones")
    times["synthesis_s"] = time.time() - t0

    t0 = time.time()
    srs = gen_srs(k, cache_dir=srs_dir, device=dev)
    torch.cuda.synchronize()
    times["srs_s"] = time.time() - t0
    t0 = time.time()
    pk = keygen(ctx, k, srs)
    torch.cuda.synchronize()
    times["keygen_s"] = time.time() - t0
    got = vk_digest(pk.vk)
    shape = {key: getattr(pk.vk, key) for key in v["vk_shape"]}
    require(shape == v["vk_shape"], (shape, v["vk_shape"]))
    require(got == v["vk_sha256"], (got, v["vk_sha256"]))
    log(f"voter k={k}: vk {shape}; digest {got[:16]}... equals the frozen "
        "JAX digest")

    t0 = time.time()
    proof = prove(pk, inst)
    torch.cuda.synchronize()
    times["prove_cold_s"] = time.time() - t0
    t0 = time.time()
    proof = prove(pk, inst)
    torch.cuda.synchronize()
    times["prove_warm_s"] = time.time() - t0
    t0 = time.time()
    ok = verify(pk.vk, srs.g2, srs.tau_g2, inst, proof)
    times["verify_s"] = time.time() - t0
    require(ok, "voter proof does not verify")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    require(not verify(pk.vk, srs.g2, srs.tau_g2, inst, bytes(bad)),
            "tampered proof accepted")
    log(f"voter k={k}: proof of {len(proof)} bytes verifies; one flipped "
        "byte is rejected")
    log("voter k={k}: synthesis {synthesis_s:.3f} s, SRS {srs_s:.3f} s, "
        "keygen {keygen_s:.3f} s, prove cold {prove_cold_s:.3f} s, warm "
        "{prove_warm_s:.3f} s, verify {verify_s:.3f} s".format(k=k, **times))
    return pk, inst


def profile_prove(pk, inst, times):
    """Where the warm prove's time goes: device activity under the
    profiler, against the wall time of the same (profiled) prove."""
    from zksnap_tpu_torch.prover.plonk import prove

    wall, by_name = device_time(lambda: prove(pk, inst))
    busy = sum(v[1] for v in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    times["profiled_prove_s"] = wall
    times["device_busy_s"] = busy
    times["device_top"] = dict(top)
    log(f"voter k={pk.vk.k}: warm prove under the profiler {wall:.3f} s, device "
        f"busy {busy:.3f} s ({100 * busy / wall:.1f}%); "
        + ("; ".join(f"{k[:40]} x{v[0]} {v[1]:.1f} ms" for k, v in top)
           if top else "no device activity seen: not measured"))


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; a CUDA GPU "
                 "is required")
    sys.path.insert(0, ROOT)
    from zksnap_tpu_torch import kernels
    from zksnap_tpu_torch.curves.fused import bucket_scan, point
    from zksnap_tpu_torch.fields.pallas_mont import mont_addsub, mont_mul

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 1. build
    t0 = time.time()
    lib_path = kernels.build()
    build_s = time.time() - t0
    kernels.library()
    log(f"build: {os.path.relpath(lib_path, ROOT)}; nvcc {build_s:.1f} s "
        f"(with loading {time.time() - t0:.1f} s)")
    with open(os.path.join(os.path.dirname(lib_path),
                           f"build_{kernels.source_hash()}.log")) as f:
        for line in f:
            if "Compiling entry function" in line or "registers" in line:
                log("  ptxas:", line.strip())

    rng = random.Random(20261016)
    results = {}
    phase2(dev, rng, results)

    work = tempfile.mkdtemp(prefix="chip_smoke_srs_",
                            dir=os.path.join(ROOT, "build"))
    try:
        phase3(dev, work)
        counters = (("K1", mont_mul), ("K2", mont_addsub), ("K3", point),
                    ("K4", bucket_scan))
        for _, fn in counters:
            fn.launches = 0
        times = {}
        pk, inst = phase4(dev, work, times)
        launches = {name: fn.launches for name, fn in counters}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"kernel launches over the voter k=13 path: {launches}")
    require(all(n > 0 for n in launches.values()), launches)
    profile_prove(pk, inst, times)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip())

    meta = {
        "K1": ("zksnap_tpu_torch/csrc/mont.cu",
               "zksnap_tpu/fields/pallas_mont.py:87"),
        "K2": ("zksnap_tpu_torch/csrc/mont.cu",
               "zksnap_tpu/fields/pallas_mont.py:170"),
        "K3": ("zksnap_tpu_torch/csrc/point.cu",
               "zksnap_tpu/curves/fused.py:382"),
        "K4": ("zksnap_tpu_torch/csrc/bucket_scan.cu",
               "zksnap_tpu/curves/fused.py:490"),
    }
    names = {"K1": "mont_mul", "K2": "mont_addsub", "K3": "point",
             "K4": "bucket_scan"}
    line = {"kernels": [
        {"name": names[k], "route": "cuda", "source": meta[k][0],
         "replaces": meta[k][1], "launches": launches[k],
         "max_abs_err": results[k]["max_abs_err"], "ms": results[k]["ms"],
         "plain_ms": results[k]["plain_ms"]} for k in ("K1", "K2", "K3", "K4")]}
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({**line, "voter_k13": times, "k3_kinds": results["K3_kinds"],
                   "device_ms": {k: results[k]["device_ms"]
                                 for k in ("K1", "K2", "K3", "K4")},
                   "build_s": build_s,
                   "nvidia_smi": smi.stdout.strip()}, f, indent=1)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
