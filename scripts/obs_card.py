"""What the port's tracing (zksnap_tpu_torch/obs.py) costs on the card,
and what its spans and counters read, on one benchmark cell.

    python3 scripts/obs_card.py [--workload voter_plume_k21.prove] [--seed N] [--pairs 4] [--out chiprun_out/obs_card.json]

(`--device cpu --cells portbench/tests/cells --workload arith_k7.prove`
tries it on the CPU at K=7.)

Set-up is portbench/run.py's own (inputs from the seed, synthesis, the
SRS, keygen, one warm-up proof), with tracing off.  Then:

  * cost: --pairs pairs of proofs, tracing off against on (the profiler
    off), in the order off, on, on, off, off, on, ... ; each proof's wall
    seconds, ending in a device synchronise, and the host us a launch
    that each proof with tracing on reads without the profiler;
  * readings: one proof with tracing on under torch.profiler (CPU and
    CUDA, input shapes): each round span's seconds and counter deltas
    (K1-K6 launches, K5 and K6 included, launch_ns, elements, wait_ns),
    and the CUDA runtime's blocking calls (cudaStreamSynchronize,
    cudaDeviceSynchronize, cudaEventSynchronize, cudaMemcpy*) inside and
    outside the reads that `obs.wait` times, whose intervals the script
    records by wrapping it; the calls outside are summed by the copy's
    direction and the ATen operation that issued them.

Prints one JSON summary line with the card's name and power limit; the
whole record goes to --out.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def timed_proofs(setup, obs, pairs: int, seed: int) -> dict:
    from portbench import generator

    order = []
    for i in range(pairs):
        order += ["off", "on"] if i % 2 == 0 else ["on", "off"]
    out = {"off": [], "on": [], "launch_us_on": []}
    for i, mode in enumerate(order):
        obs.enable() if mode == "on" else obs.disable()
        t = time.perf_counter()
        setup.prove(generator.request_rng(seed, 100 + i))
        setup.sync()
        out[mode].append(time.perf_counter() - t)
        obs.disable()
        if mode == "on":
            out["launch_us_on"].append(launch_us(obs.spans()[-1]))
        obs.clear()
    return out


def launch_us(root) -> float:
    """Host us a K1-K6 launch over a `prove` span (portbench/metrics/
    launch_us.py's arithmetic)."""
    from portbench.program_spans import LAUNCHED

    n = sum(root.counters.get(f"{w}.launches", 0) for w in LAUNCHED)
    ns = sum(root.counters.get(f"{w}.launch_ns", 0) for w in LAUNCHED)
    return ns / n / 1e3 if n else None


def _recording_wait(obs, intervals: list):
    """obs.wait's timer, also keeping each read's interval on the
    profiler's clock."""
    base = obs._Wait

    class Recorded(base):
        __slots__ = ()

        def __exit__(self, *exc):
            intervals.append((self.t0 + obs._offset,
                              time.perf_counter_ns() + obs._offset))
            return base.__exit__(self, *exc)

    obs._Wait = Recorded
    return base


def blocking_calls(prof, waits: list, t0: int, t1: int) -> dict:
    """The runtime's blocking calls in [t0, t1] (synchronisations, and
    copies to or from the host: a copy on the card alone is left out):
    seconds inside and outside the timed reads, and those outside by the
    copy's direction and the innermost ATen operation around the call,
    with its input shapes."""
    from torch.autograd import DeviceType

    kind, host, calls = {}, [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.name().startswith("Memcpy"):
                kind[e.correlation_id()] = e.name()
            continue
        s, d, name = e.start_ns(), e.duration_ns(), e.name()
        if name.startswith(BLOCKING):
            if t0 <= s <= t1:
                calls.append((s, s + d, name, e.correlation_id()))
        elif name.startswith("aten::") and d > 0:
            host.append((s, s + d, f"{name} {e.shapes()}"))
    host.sort(key=lambda h: h[0])
    starts = [h[0] for h in host]
    waits = sorted(waits)
    wstarts = [w[0] for w in waits]
    inside = outside = 0
    by_op: dict = {}
    for s, e, name, corr in calls:
        copy = kind.get(corr, "")
        if name.startswith("cudaMemcpy") and "DtoD" in copy:
            continue
        i = bisect.bisect_right(wstarts, s) - 1
        if i >= 0 and waits[i][0] <= s and e <= waits[i][1]:
            inside += e - s
            continue
        outside += e - s
        op = "none"
        j = bisect.bisect_right(starts, s)
        for hs, he, h in reversed(host[max(0, j - 400):j]):
            if hs <= s and e <= he:
                op = h
                break
        key = f"{name} [{copy}] in {op}"
        c = by_op.setdefault(key, [0, 0.0])
        c[0] += 1
        c[1] += (e - s) / 1e9
    top = sorted(by_op.items(), key=lambda kv: -kv[1][1])[:25]
    return {"inside_s": inside / 1e9, "outside_s": outside / 1e9,
            "calls": len(calls), "outside_by_op": top}


def traced_proof(setup, obs, seed: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from portbench import generator

    waits: list = []
    base = _recording_wait(obs, waits)
    obs.clear()
    obs.enable()
    try:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if setup.cuda else [])
        with profile(activities=acts, record_shapes=True) as prof:
            t0 = obs.now_ns()
            setup.prove(generator.request_rng(seed, 99))
            setup.sync()
            t1 = obs.now_ns()
        spans = obs.spans()
    finally:
        obs.disable()
        obs.clear()
        obs._Wait = base
    root = [s for s in spans if s.name == "prove"][-1]
    rounds = {s.name: {"s": s.seconds,
                       "counters": {k: v for k, v in s.counters.items() if v}}
              for s in spans if s is root or s.parent == root.id}
    wait_s = root.counters["wait_ns"] / 1e9
    block = blocking_calls(prof, waits, t0, t1)
    block["outside_share_of_wait"] = (block["outside_s"] / wait_s
                                      if wait_s else None)
    return {"proof_s": root.seconds, "rounds": rounds,
            "rounds_sum_s": sum(v["s"] for k, v in rounds.items()
                                if k != "prove"),
            "wait_s": wait_s, "timed_reads": len(waits),
            "blocking": block}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="voter_plume_k21.prove")
    ap.add_argument("--seed", type=int, default=3500000041)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "obs_card.json"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cells", default=None)
    args = ap.parse_args(argv)

    from portbench import run
    from zksnap_tpu_torch import obs

    t = time.perf_counter()
    setup = run.prepare(run.Bench(args.cells), args.workload, args.seed,
                        args.device)
    setup_s = time.perf_counter() - t
    cost = timed_proofs(setup, obs, args.pairs, args.seed)
    off, on = sorted(cost["off"]), sorted(cost["on"])
    readings = traced_proof(setup, obs, args.seed)
    rec = {"card": card(), "workload": args.workload, "seed": args.seed,
           "setup_s": setup_s, "spans": dict(setup.spans.seconds),
           "cost": cost,
           "cost_median_off_s": off[len(off) // 2] if off else None,
           "cost_median_on_s": on[len(on) // 2] if on else None,
           "cost_pairs_on_minus_off_s": [b - a for a, b in zip(
               cost["off"], cost["on"])],
           "traced": readings}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    summary = {k: rec[k] for k in ("card", "workload", "seed", "setup_s",
                                   "cost", "cost_pairs_on_minus_off_s")}
    summary["traced"] = {k: v for k, v in readings.items()
                         if k != "blocking"}
    summary["blocking"] = {k: v for k, v in readings["blocking"].items()
                           if k != "outside_by_op"}
    summary["blocking_top"] = readings["blocking"]["outside_by_op"][:12]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
