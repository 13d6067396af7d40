"""The program's own spans and counters (zksnap_tpu_torch/obs.py), for the
per-layer metrics that read them.

Only those metrics' readers import this module, and run.py loads the
readers only for a `--trace 1` run, before set-up: so importing it
switches the program's tracing on for traced runs alone, keygen
included, and the untraced runs that give prove_s and setup_s keep it
off.  A program without `obs` (a checkout from before it) leaves `obs`
None, and every function here returns None.

The window's proofs are the last `run.proofs` completed `prove` spans;
the warm-up proof comes before them.
"""

from __future__ import annotations

try:
    from zksnap_tpu_torch import obs
except ImportError:
    obs = None
else:
    obs.enable()

# the K1-K6 wrappers whose launches launch_us averages over
LAUNCHED = ("mont_mul", "mont_addsub", "point", "bucket_scan",
            "weighted_suffix", "ladder_tree")


def proofs(run) -> list | None:
    if obs is None or not run.proofs:
        return None
    done = [s for s in obs.spans()
            if s.name == "prove" and s.parent is None and not s.failed]
    if len(done) < run.proofs:
        return None
    return done[-run.proofs:]


def round_s(run, name: str) -> float | None:
    """Seconds a proof in the window's spans called `name`."""
    ps = proofs(run)
    if ps is None:
        return None
    ids = {p.id for p in ps}
    inside = [s for s in obs.spans() if s.name == name and s.request in ids]
    if not inside:
        return None
    return sum(s.seconds for s in inside) / len(ps)


def setup_s(name: str) -> float | None:
    """Seconds of set-up's (last) span called `name`."""
    if obs is None:
        return None
    found = [s for s in obs.spans() if s.name == name]
    return found[-1].seconds if found else None


def total(run, key: str) -> int | None:
    """Counter `key`'s deltas summed over the window's proofs."""
    ps = proofs(run)
    if ps is None:
        return None
    return sum(p.counters.get(key, 0) for p in ps)
