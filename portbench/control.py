#!/usr/bin/env python3
"""The control and the planted faults of a cell, read by its reference at
the cell's own size: the readings that the limits of `correct` rest on.
The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--out FILE]

For each seed: the cell's set-up (as a run makes it), then
- honest: two proofs as the window makes them;
- control: one proof of a witness that breaks one constraint (one class of
  equal advice cells, touching no constant, lookup or public cell, moved
  by 1: the gate there no longer holds), which a sound proof system must
  reject;
- stale: a window whose second request returns the first's answer;
- altered: a window whose first answer has one byte changed where it is
  produced (a byte in the middle of the proof: an evaluation).
Each variant's counts are printed as one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import generator, run  # noqa: E402
from portbench.reference.check import Reference  # noqa: E402


def unsatisfied_class(record) -> list[int]:
    """Advice cells of one equality class that holds a gate cell and no
    constant, lookup or public cell."""
    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = record.n_cells
    cp = record.copies
    g = coo_matrix((np.ones(len(cp), np.int8), (cp[:, 0], cp[:, 1])),
                   shape=(n, n))
    _, label = connected_components(g, directed=False)
    banned = np.zeros(label.max() + 1, dtype=bool)
    for idx in (record.const_idx, record.lookups, record.instance_idx):
        banned[label[idx]] = True
    in_gate = np.zeros(n, dtype=bool)
    for off in range(4):
        in_gate[np.minimum(record.gates + off, n - 1)] = True
    ok = in_gate & ~banned[label]
    if not ok.any():
        raise ValueError("no class of gate cells free of constants, lookups "
                         "and public cells")
    first = int(np.flatnonzero(ok)[0])
    return np.flatnonzero(label == label[first]).tolist()


def shift_cells(limbs, cells: list[int], delta: int):
    """Add delta (mod p) to each cell's value in the (N, 16) uint16 rows."""
    import numpy as np

    from portbench.reference.fr import P

    for c in cells:
        v = int.from_bytes(limbs[c].astype("<u2").tobytes(), "little")
        v = (v + delta) % P
        limbs[c] = np.frombuffer(v.to_bytes(32, "little"), dtype="<u2")


def readings(setup, ref: Reference, seed: int) -> dict:
    program = {"instances": setup.instances, "vk": setup.program_vk}
    honest = [setup.prove(generator.request_rng(seed, i)) for i in range(2)]
    out = {"honest": ref.judge(program, honest),
           "stale": ref.judge(program, [honest[0], honest[0]])}
    p = bytearray(honest[0])
    p[len(p) // 2] ^= 0x01
    out["altered"] = ref.judge(program, [bytes(p), honest[1]])
    cells = unsatisfied_class(setup.record)
    limbs = setup.pk.layout.advice_limbs
    shift_cells(limbs, cells, 1)
    try:
        bad = setup.prove(generator.request_rng(seed, 2))
    finally:
        shift_cells(limbs, cells, -1)
    out["control"] = ref.judge(program, [bad])
    out["control_cells"] = len(cells)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cells", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = run.Bench(args.cells)
    for seed in (int(s) for s in args.seeds.split(",")):
        setup = run.prepare(bench, args.workload, seed, args.device)
        ref = Reference(setup.config, setup.inputs, setup.record,
                        setup.device)
        r = readings(setup, ref, seed)
        line = {"workload": args.workload, "seed": seed,
                "control_cells": r.pop("control_cells"),
                **{k: {n: v for n, v, _ in checks}
                   for k, checks in r.items()}}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        setup = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
