"""BENCHMARK.json against the files of portbench/: names and units in
their alphabets, every cell's workload, configuration, traffic and
circuit files found by name, a reader for every metric, every per-layer
metric's `moves` an end-to-end metric that each of its cells reports, and
the test-only cell named by no harness file."""

import json
import os
import re
import subprocess

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FILE = re.compile(r"^[A-Za-z0-9_./-]+$")

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    M = json.load(_f)
METRICS = M["end_to_end"] + M["per_layer"]


def _json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def test_names_and_units():
    names = ([m["name"] for m in METRICS] + [c["name"] for c in M["configs"]]
             + [w["name"] for w in M["workloads"]]
             + [w[k] for w in M["workloads"] for k in ("config", "traffic")]
             + [k for c in M["configs"] for k in c["reduced"]])
    bad = [n for n in names if not NAME.match(n)]
    assert not bad
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [x["name"] for x in M[kind]]
        assert len(ns) == len(set(ns)), kind
    for text in ([c[k] for c in M["configs"] for k in ("why", "source")]
                 + [w["why"] for w in M["workloads"]]
                 + [m["layer"] for m in M["per_layer"]] + M["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds():
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_files_found_by_name(cell):
    w = next(x for x in M["workloads"] if x["name"] == cell)
    f = _json("workloads", f"{cell}.json")
    assert (f["config"], f["traffic"], f["chips"]) == (
        w["config"], w["traffic"], w["chips"])
    cfg = next(c for c in M["configs"] if c["name"] == w["config"])
    assert cfg["file"] == f"portbench/configs/{w['config']}.json"
    config = _json("configs", f"{w['config']}.json")
    _json("traffic", f"{w['traffic']}.json")
    for d in ("circuits", os.path.join("reference", "circuits")):
        assert os.path.exists(os.path.join(BENCH, d,
                                           f"{config['circuit']}.py"))


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    with open(path) as f:
        assert "def read(run)" in f.read()


@pytest.mark.parametrize("metric", [m["name"] for m in M["per_layer"]])
def test_moves_is_reported_in_each_of_its_cells(metric):
    m = next(x for x in M["per_layer"] if x["name"] == metric)
    e2e = {x["name"]: x for x in M["end_to_end"]}
    assert m["moves"] in e2e  # the harness reads every metric in every cell


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in M["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and M["per_layer"]


def test_test_cell_is_named_by_no_harness_file():
    cells = os.listdir(os.path.join(HERE, "cells", "configs"))
    names = [c[: -len(".json")] for c in cells]
    for dirpath, _, files in os.walk(BENCH):
        if os.path.abspath(dirpath).startswith(HERE):
            continue
        for fn in files:
            if fn.endswith((".py", ".json")):
                with open(os.path.join(dirpath, fn)) as f:
                    text = f.read()
                assert not any(n in text for n in names), fn


def test_committed_file_names():
    out = subprocess.run(["git", "ls-files", "--others", "--cached",
                          "--exclude-standard", "portbench"], cwd=ROOT,
                         capture_output=True, text=True)
    if out.returncode:
        pytest.skip("not a git checkout")
    files = out.stdout.split()
    assert files and all(FILE.match(f) for f in files)
