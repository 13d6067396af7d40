"""Drive the port's mesh paths alone on the card, or on several cards.

    python3 scripts/mesh_torch.py [--cards]

Builds the kernels, then runs chip_smoke.py's mesh phases and nothing
else: K=7 on a virtual mesh (the frozen JAX vk digest and seeded proof
bytes), warm_prove's two child processes at the voter's k=13, and the
PLUME voter at k=21 (chip_smoke.phase_plume, with
ZKSNAP_TPU_FUSED_REDUCE=1) followed by phase_mesh_k21: the virtual mesh
of four and, on a machine with two or more cards, K1 and K3 on the last
card, the mesh over the first 2 or 4 cards and scaling_efficiency over
1, 2, 4 cards.  `--cards` keeps only the PLUME voter and the distinct
cards' part (chip_smoke.phase_mesh_cards): the run to make on a machine
of several cards.  Each prove path's launches of K1-K6 are counted and
must be > 0.  Writes chiprun_out/mesh_torch.json and prints the cards'
names and power limits; exits non-zero if a check fails.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("mesh_torch: a CUDA GPU is required")
    from zksnap_tpu_torch import kernels
    from zksnap_tpu_torch.curves.fused import (bucket_scan, ladder_tree,
                                               point, weighted_suffix)
    from zksnap_tpu_torch.fields.pallas_mont import mont_addsub, mont_mul
    from zksnap_tpu_torch.prover.srs import gen_srs

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.time()
    t0 = time.time()
    kernels.library()
    cs.log(f"build and load: {time.time() - t0:.1f} s; "
           f"{torch.cuda.device_count()} card(s)")
    counters = {"K1": mont_mul, "K2": mont_addsub, "K3": point,
                "K4": bucket_scan, "K5": weighted_suffix, "K6": ladder_tree}
    launches = {}

    def path(name, fn, needs):
        for fn_ in counters.values():
            fn_.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in counters.items()}
        cs.log(f"kernel launches over the {name} path: {counts}")
        cs.require(all(counts[k] > 0 for k in needs), (name, counts))
        launches[name] = counts
        return out

    work = tempfile.mkdtemp(prefix="mesh_torch_",
                            dir=os.path.join(ROOT, "build"))
    out = {"mesh_k7": {}, "warm_prove_k13": {}, "voter_plume_k21": {},
           "mesh_k21": {}}
    cards_only = sys.argv[1:] == ["--cards"]
    try:
        if not cards_only:
            path("K=7 on a virtual mesh",
                 lambda: cs.phase_mesh_k7(dev, work, out["mesh_k7"]),
                 ("K1", "K2", "K3", "K4"))
            gen_srs(13, cache_dir=work, device=dev)
            cs.phase_warm_prove(work, out["warm_prove_k13"])
        with cs.fused_reduce("1"):
            srs, pk, inst = cs.phase_plume(dev, work, out["voter_plume_k21"])
            if cards_only:
                cs.phase_mesh_cards(srs, pk, inst, path, out["mesh_k21"])
            else:
                cs.phase_mesh_k21(dev, srs, pk, inst, path, out["mesh_k21"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    cs.log(smi.stdout.strip())
    out.update(path_launches=launches, nvidia_smi=smi.stdout.strip(),
               total_s=time.time() - t_start)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "mesh_torch.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    cs.log(f"mesh_torch: all checks passed in {time.time() - t_start:.1f} s")


if __name__ == "__main__":
    main()
