#!/usr/bin/env python3
"""Run one cell of the benchmark of zksnap_tpu_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files are found by name: workloads/<cell>.json names its
configuration (configs/<name>.json, whose `circuit` names
circuits/<kind>.py and reference/circuits/<kind>.py) and its traffic
(traffic/<name>.json); each metric of BENCHMARK.json is read by
metrics/<metric>.py.  Set-up (inputs from the seed, the program's
synthesis, the SRS, keygen, warm-up requests) is timed as setup_s; then
the generator drives the program for `--seconds`; then, once the
program's state is freed, the reference judges every answer of the
window.  The last line of standard output is the result's JSON object;
the last lines of standard error give each number compared and its
limit.  `--trace 1` runs the window under torch.profiler and reports the
per-layer metrics instead of the end-to-end ones.

`--device cpu` and `--cells DIR` (a further directory of workloads/ and
configs/) are for the CPU tests: such a run reports no device metric.
Without a card the run fails; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "zksnap_tpu")
NAME_CHARS = 160  # a device operation's name in the breakdown


def _fail(msg: str, code: int):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


class Bench:
    """The benchmark's files, found by name under portbench/ and, for the
    tests, a further directory of workloads/ and configs/."""

    def __init__(self, extra: str | None = None):
        self.roots = [HERE] + ([os.path.abspath(extra)] if extra else [])
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            self.manifest = json.load(f)

    def _json(self, sub: str, name: str) -> dict:
        for r in self.roots:
            path = os.path.join(r, sub, f"{name}.json")
            if os.path.exists(path):
                with open(path) as f:
                    return json.load(f)
        raise FileNotFoundError(f"no {sub}/{name}.json")

    def cell(self, name: str) -> dict:
        return self._json("workloads", name)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    @staticmethod
    def circuit(kind: str):
        return importlib.import_module(f"portbench.circuits.{kind}")

    @staticmethod
    def reader(metric: str):
        path = os.path.join(HERE, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


@dataclass
class Run:
    """What a metric's reader reads."""
    device: str
    setup_s: float
    spans: dict
    proofs: int = 0
    window_s: float = 0.0
    counters: dict = field(default_factory=dict)
    ops: dict | None = None       # device operation -> [count, seconds]
    busy_s: float | None = None
    idle: dict | None = None      # host activity -> idle device seconds
    window_peak_bytes: int | None = None


@dataclass
class Setup:
    config: dict
    traffic: dict
    inputs: object
    instances: list
    record: object
    program_vk: dict
    pk: object
    spans: object
    cuda: bool
    device: object
    seed: int
    setup_s: float = 0.0

    def prove(self, rng):
        from zksnap_tpu_torch.prover.plonk import prove

        return prove(self.pk, self.instances, rng)

    def sync(self):
        self.spans.sync()


def record_of(ctx):
    """The synthesized circuit's raw record, the reference's starting
    point (copies of the program's arrays)."""
    import numpy as np

    from portbench.reference.layout import Record

    return Record(
        n_cells=len(ctx.advice),
        gates=np.array(ctx.gate_offsets.array(), dtype=np.int64),
        copies=np.array(ctx.copies.pairs(), dtype=np.int64).reshape(-1, 2),
        const_idx=np.array(ctx.const_idx.array(), dtype=np.int64),
        const_vals=np.array(ctx.const_vals.limbs(), dtype=np.uint16),
        lookups=np.array(ctx.lookups.array(), dtype=np.int64),
        instance_idx=np.array([c.idx for c in ctx.instance], dtype=np.int64),
        lookup_bits=int(ctx.lookup_bits))


def plain_vk(vk) -> dict:
    from portbench.reference.check import VK_NUMBERS

    out = {f: getattr(vk, f) for f in VK_NUMBERS}
    out["commitments"] = {nm: None if p.is_identity() else (p.x, p.y)
                          for nm, p in vk.commitments.items()}
    return out


def prepare(bench: Bench, cell_name: str, seed: int, device: str) -> Setup:
    import torch

    from portbench import generator
    from portbench.spans import Spans

    cell = bench.cell(cell_name)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    generator.check_traffic(traffic)
    cuda = device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell["chips"]):
        _fail(f"cell {cell_name} needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              3)
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    from zksnap_tpu_torch.prover.plonk import keygen
    from zksnap_tpu_torch.prover.srs import gen_srs

    kind = bench.circuit(config["circuit"])
    spans = Spans(torch, cuda)
    with spans.span("inputs"):
        inputs = kind.make_inputs(config, seed)
    with spans.span("synth"):
        ctx, instances = kind.synthesize(config, inputs)
    record = record_of(ctx)
    with spans.span("srs"):
        srs = gen_srs(config["k"], seed=config["srs_seed"].encode(),
                      device=dev)
    with spans.span("keygen"):
        pk = keygen(ctx, config["k"], srs, device=dev)
    del ctx, srs
    setup = Setup(config=config, traffic=traffic,
                  inputs=inputs, instances=instances, record=record,
                  program_vk=plain_vk(pk.vk), pk=pk, spans=spans, cuda=cuda,
                  device=dev, seed=seed)
    with spans.span("warmup"):
        generator.warm_up(traffic, setup.prove, seed, setup.sync)
    return setup


def _counter(path: str):
    mod, attr = path.split(":")
    return getattr(importlib.import_module(mod), attr)


def measure(setup: Setup, readers: dict, seconds: float, trace: bool):
    """Drive the window; returns (window, Run, memory peak of the run)."""
    import torch

    from portbench import devtrace, generator

    counters = sorted({c for r in readers.values()
                       for c in getattr(r, "COUNTERS", ())})
    before = {c: _counter(c).launches for c in counters}
    peak = None
    if setup.cuda:
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if setup.cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    gc.collect()  # the window starts with none of set-up's garbage
    t0_ns = time.time_ns()
    win = generator.closed_loop(setup.traffic, setup.prove, setup.seed,
                                seconds, setup.sync)
    t1_ns = time.time_ns()
    if prof is not None:
        prof.__exit__(None, None, None)
    run = Run(device=setup.device.type, setup_s=setup.setup_s,
              spans=dict(setup.spans.seconds), proofs=len(win.answers),
              window_s=win.seconds,
              counters={c: _counter(c).launches - before[c]
                        for c in counters})
    if setup.cuda:
        run.window_peak_bytes = torch.cuda.max_memory_allocated()
        peak = max(peak, run.window_peak_bytes)
    if prof is not None and setup.cuda:
        t_read = time.perf_counter()
        t = devtrace.read(prof, t0_ns, t1_ns)
        print(f"trace read in {time.perf_counter() - t_read:.3f} s",
              file=sys.stderr, flush=True)
        if t["ops"]:
            run.ops, run.busy_s, run.idle = t["ops"], t["busy_s"], t["idle"]
    del prof
    return win, run, peak


def free_program(setup: Setup):
    """Drop the program's key and cached set-up before the reference runs."""
    import torch

    from zksnap_tpu_torch.prover import srs as srs_mod

    setup.pk = None
    srs_mod._MEMO.clear()
    gc.collect()
    if setup.cuda:
        torch.cuda.empty_cache()


def judge(setup: Setup, answers: list) -> list:
    from portbench.reference.check import Reference

    ref = Reference(setup.config, setup.inputs, setup.record, setup.device)
    checks = ref.judge({"instances": setup.instances,
                        "vk": setup.program_vk}, answers)
    print("reference: " + ", ".join(f"{k} {v:.3f} s"
                                    for k, v in ref.seconds.items()),
          file=sys.stderr, flush=True)
    return checks


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def breakdown(run: Run) -> dict:
    def top(d, key):
        rows = sorted(d.items(), key=lambda kv: -key(kv[1]))[:10]
        return [[n[:NAME_CHARS], key(v)] for n, v in rows]

    return {"device_ops": top(run.ops, lambda v: v[1]),
            "idle_gaps": top(run.idle or {}, lambda v: v)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the CPU tests only; no device metric")
    ap.add_argument("--cells", default=None,
                    help="a further directory of workloads/ and configs/ "
                         "(the CPU tests)")
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")

    bench = Bench(args.cells)
    kind = "per_layer" if args.trace else "end_to_end"
    entries = bench.manifest[kind]
    readers = {m["name"]: bench.reader(m["name"]) for m in entries}

    setup = prepare(bench, args.workload, args.seed, args.device)
    setup.setup_s = time.perf_counter() - T_START
    for name, s in setup.spans.seconds.items():
        print(f"span {name}: {s:.3f} s", file=sys.stderr, flush=True)
    print(f"setup_s: {setup.setup_s:.3f} s", file=sys.stderr, flush=True)

    win, run, peak = measure(setup, readers, args.seconds, bool(args.trace))
    print(f"window: {len(win.answers)} answers of {win.attempted} in "
          f"{win.seconds:.3f} s: "
          + " ".join(f"{d:.3f}" for d in win.durations),
          file=sys.stderr, flush=True)
    metrics = {}
    for m in entries:
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    free_program(setup)
    checks = judge(setup, win.answers)
    correct = win.failed == 0 and all(v <= lim for _, v, lim in checks)

    bad = forbidden_modules()
    if bad:
        _fail("modules that the benchmark may not load are loaded: "
              + ", ".join(bad), 4)

    if setup.cuda:
        import torch

        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count(),
                  "memory_peak_bytes": peak}
        if args.trace and run.busy_s is not None:
            device.update(busy_s=run.busy_s, window_s=run.window_s)
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": None}
    result = {"correct": correct, "attempted": win.attempted,
              "failed": win.failed + sum(v for n, v, _ in checks
                                         if n == "proofs_rejected"),
              "metrics": metrics, "device": device}
    if args.trace and run.ops:
        result["breakdown"] = breakdown(run)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
