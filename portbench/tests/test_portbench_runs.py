"""Whole runs of portbench/run.py in child processes, on the CPU at K=7
(the test-only cell under tests/cells, found by name): a sound run is
correct and loads no module it may not; a run whose prover is broken
underneath (its answers stale, or altered where produced) is not
correct; a run that sees no card fails instead of falling back; the
reference loads nothing of the program.  On the card (`-m card`) the
same cell runs traced there."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CELLS = os.path.join(HERE, "cells")
RUN = [os.path.join(ROOT, "portbench", "run.py"), "--workload",
       "arith_k7.prove", "--cells", CELLS]
FORBIDDEN = {"jax", "jaxlib", "flax", "zksnap_tpu"}


def _run(argv, env=None, timeout=600):
    e = dict(os.environ)
    e.update(env or {})
    p = subprocess.run([sys.executable] + argv, cwd=ROOT, env=e,
                       capture_output=True, text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return p, result


def test_sound_run_is_correct():
    p, res = _run(RUN + ["--seed", "2147483659", "--seconds", "0.001",
                         "--device", "cpu"])
    assert p.returncode == 0, p.stderr[-3000:]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == 1
    assert set(res["metrics"]) == {"prove_s", "setup_s"}
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    assert "check proofs_rejected: 0 (limit 0)" in p.stderr


@pytest.mark.parametrize("fault", ["stale", "altered"])
def test_broken_prover_is_not_correct(fault):
    seconds = "0.12" if fault == "stale" else "0.001"
    p, res = _run([os.path.join(HERE, "break_prover.py"), fault] + RUN[1:]
                  + ["--seed", "77", "--seconds", seconds,
                     "--device", "cpu"])
    assert p.returncode == 0, p.stderr[-3000:]
    assert res["correct"] is False
    key = "proofs_repeated" if fault == "stale" else "proofs_rejected"
    assert res["checks"][key]["value"] >= 1


def test_no_card_fails_without_a_result():
    p, res = _run(RUN + ["--seed", "5", "--seconds", "1"],
                  env={"CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert p.returncode != 0 and res is None
    assert "CUDA device" in p.stderr


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, %r); "
            "import portbench.reference.check, portbench.reference.verifier, "
            "portbench.reference.layout, portbench.reference.fr, "
            "portbench.natives.inputs; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not top & (FORBIDDEN | {"zksnap_tpu_torch"})


@pytest.mark.card
def test_traced_run_on_the_card(cuda_card):
    p, res = _run(RUN + ["--seed", "2147483659", "--seconds", "2",
                         "--trace", "1"], timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert "device_busy_pct" in res["metrics"]
