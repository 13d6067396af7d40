# Copy of zksnap_tpu/parallel/batch_witness.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""Data-parallel (P1) batched witness generation.

The reference parallelizes witness synthesis only through rayon inside
halo2's prover (SURVEY.md section 2.3 "Data parallel"); this framework's
synthesis is pure-python trace building (trace/context.py), which at
voter+PLUME scale costs ~3 minutes of single-core time per voter.  A
batch of N voters is embarrassingly parallel: each synthesis touches
only its own Context, so a ProcessPoolExecutor gives ~min(N, cores)
speedup (Context is plain picklable host data -- lists of python ints).

Usage:
    ctxs = batch_witnesses(build, inputs)        # N parallel syntheses
    pks  = [rebind_witness(pk, c) for c, _ in ctxs]  # then prove serially

where `build(inp) -> (ctx, instances)` is any circuit synthesis
function (e.g. the voter circuit; see scripts/bench_batch_witness.py).
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor


def _run(args):
    build, inp = args
    ctx, instances = build(inp)
    return ctx, instances


def batch_witnesses(build, inputs, max_workers: int | None = None):
    """Synthesize `build(inp)` for every input in parallel processes.

    build must be a module-level (picklable) callable returning
    (Context, instance list).  Returns results in input order.
    """
    workers = max_workers or min(len(inputs), os.cpu_count() or 1)
    if workers <= 1 or len(inputs) <= 1:
        return [build(i) for i in inputs]
    with ProcessPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(_run, [(build, i) for i in inputs]))
