"""Where a K1 / K2 call spends its time, and where the NTT's and the
prover's copies come from, for one checkout of the port on one card.

    python3 scripts/torch_field_probe.py [TREE] [--reps 10000] [--out chiprun_out/field_probe.json]

TREE holds a checkout's `zksnap_tpu_torch` (default: this one; for the
parent commit `git archive <commit> zksnap_tpu_torch | tar -x -C
build/parent`).  The probe builds that checkout's kernels and records:

  * the ptxas lines and the SASS mix of `mont_mul_kernel` and
    `mont_addsub_kernel` (chip_smoke.py's `ptxas_entries` and
    `kernel_sass`; cuobjdump is required): instructions, LDL/STL and
    CALLs, the kernel's own code and each subroutine;
  * the host split of one K1 and one K2 (add) call at n = 8192, and of K1
    on a middle NTT stage's operands at k = 13 (`xb[..., 1, :, :]`
    against `w[None]`): each piece of the wrapper timed alone with
    `time.perf_counter` over --reps calls (the whole call, the operand
    preparation, `torch.empty`, `kernels.on_device`'s enter and exit,
    the operand checks, the ctypes call with its arguments ready);
  * where PyTorch's `direct_copy` kernels come from over one forward NTT
    of 2^21 and one warm voter prove at k=13 (chip_smoke.py's phase 4
    sets it up): `torch.profiler` with CPU and CUDA activity; each launch
    is put under "operands" (the field wrappers' operand preparation),
    "casts" (a dtype conversion, `aten::_to_copy`) or "other", with
    launches and device ms, and the commonest chains of ops that issued
    the others.

Prints one JSON line with the card's name and power limit; the whole
record goes to --out.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_split(cs, a, b, p: int, mode, reps: int) -> dict:
    """{piece: host ms a call} of one K1 (mode None) or K2 call on a, b.
    A checkout whose wrappers read operands where they lie is timed by
    chip_smoke.py's own `field_host_split`; an older one (operands made
    contiguous, three `kernels.rows` checks) piece by piece here."""
    import torch

    from zksnap_tpu_torch import kernels
    from zksnap_tpu_torch.fields import pallas_mont as pm

    if hasattr(pm, "operand_view"):
        return cs.field_host_split(a, b, p, mode, reps)
    call = ((lambda: pm.mont_mul(a, b, p)) if mode is None
            else (lambda: pm.mont_addsub(a, b, p, mode)))
    ar, br, sa, sb, batch, n = pm._operands(a, b)
    out = torch.empty((n, 16), dtype=torch.int32, device=a.device)
    lib = kernels.library()
    mod = kernels.mod_ptr(p)

    def on_device():
        with kernels.on_device(ar, br, out):
            pass

    with kernels.on_device(ar, br, out) as stream:
        pass
    args = (ar.data_ptr(), br.data_ptr(), out.data_ptr(), n, sa, sb)
    if mode is None:
        launch = lambda: lib.zk_mont_mul(*args, mod, stream)  # noqa: E731
    else:
        launch = lambda: lib.zk_mont_addsub(*args, 0, mod, stream)  # noqa
    return {
        "call": cs.host_ms(call, reps),
        "_operands": cs.host_ms(lambda: pm._operands(a, b), reps),
        "torch.empty": cs.host_ms(lambda: torch.empty(
            (n, 16), dtype=torch.int32, device=a.device), reps),
        "on_device": cs.host_ms(on_device, reps),
        "rows x3": cs.host_ms(lambda: (
            kernels.rows(ar, n if sa else 1), kernels.rows(br, n if sb else 1),
            kernels.rows(out, n)), reps),
        "ctypes call": cs.host_ms(launch, reps),
    }


def copy_sources(fn) -> dict:
    """PyTorch's direct_copy kernels over one call of fn, by source:
    {"operands" | "casts" | "other": [launches, device ms], "frames":
    {the chain of ops above an "other" launch: [launches, device ms]}
    (the 12 commonest)}.  The field wrappers' operand preparation
    (`_operands`, or `operand_rows` where the wrappers read operands in
    place) runs inside a `record_function` range for the call, so that
    its copies are found among a launch's parent events whatever Python
    stacks the profiler keeps."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from zksnap_tpu_torch.fields import pallas_mont as pm

    name = "operand_rows" if hasattr(pm, "operand_rows") else "_operands"
    orig = getattr(pm, name)

    def marked(*args, **kw):
        with record_function("field_operands"):
            return orig(*args, **kw)

    setattr(pm, name, marked)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        setattr(pm, name, orig)
    out = {"operands": [0, 0.0], "casts": [0, 0.0], "other": [0, 0.0]}
    frames = {}
    for e in prof.events():
        kernels = [k for k in e.kernels if "direct_copy" in k.name]
        if not kernels:
            continue
        names, up = [], e
        while up is not None:
            names.append(up.name)
            up = up.cpu_parent
        if "field_operands" in names:
            kind = "operands"
        elif "aten::_to_copy" in names:
            kind = "casts"
        else:
            kind = "other"
        ms = sum(k.duration for k in kernels) / 1e3
        out[kind][0] += len(kernels)
        out[kind][1] += ms
        if kind == "other":
            c = frames.setdefault(" < ".join(names[:4]), [0, 0.0])
            c[0] += len(kernels)
            c[1] += ms
    out["frames"] = dict(sorted(frames.items(), key=lambda kv: -kv[1][0])[:12])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=ROOT)
    ap.add_argument("--reps", type=int, default=10000)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "field_probe.json"))
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_field_probe: a CUDA GPU is required")
    cs = _chip_smoke()
    from zksnap_tpu_torch import kernels
    from zksnap_tpu_torch.fields import bn254_fr
    from zksnap_tpu_torch.poly.domain import domain
    from zksnap_tpu_torch.poly.ntt import ntt

    assert os.path.samefile(os.path.dirname(os.path.dirname(
        kernels.__file__)), tree), (kernels.__file__, tree)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    lib = kernels.build()
    kernels.library()
    names = ("mont_mul_kernel", "mont_addsub_kernel")
    with open(os.path.join(os.path.dirname(lib),
                           f"build_{kernels.source_hash()}.log")) as f:
        ptxas = {k: v for k, v in cs.ptxas_entries(f.read()).items()
                 if any(s in k for s in names)}
    sass = cs.kernel_sass(lib, names)
    rec = {"tree": tree, "torch": torch.__version__, "ptxas": ptxas,
           "sass": sass}

    F = bn254_fr()
    a, b = cs.field_inputs(F, 8192, random.Random(20261017), dev)
    x = cs.random_canonical(1 << 13, 20261018, dev)
    _, xa, wb = cs.ntt_stage_operands(x, 13, 6, domain(13).twiddles(dev))
    rec["host_split_ms"] = {
        "K1 n=8192": host_split(cs, a, b, F.p, None, args.reps),
        "K2 add n=8192": host_split(cs, a, b, F.p, "add", args.reps),
        "K1 NTT stage 6 of k=13": host_split(cs, xa, wb, F.p, None,
                                             args.reps)}

    x21 = cs.random_canonical(1 << 21, 20261019, dev)
    ntt(21).forward(x21)
    rec["ntt_2p21_copies"] = copy_sources(lambda: ntt(21).forward(x21))
    work = tempfile.mkdtemp(prefix="field_probe_",
                            dir=os.path.join(ROOT, "build"))
    try:
        pk, inst = cs.phase4(dev, work, {})
        from zksnap_tpu_torch.prover.plonk import prove

        rec["prove_k13_copies"] = copy_sources(lambda: prove(pk, inst))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rec["nvidia_smi"] = smi
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if k != "sass"}))


if __name__ == "__main__":
    main()
