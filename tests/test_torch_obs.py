"""The port's spans and counters (zksnap_tpu_torch/obs.py) on the CPU.

One keygen and one seeded proof of the frozen K=7 circuit with tracing
on: the proof is still the frozen JAX proof byte for byte, the spans form
one `prove` root holding its five rounds in order and one `keygen` root
holding its layout and commits, their stamps lie on the Unix clock, and
the host's wait on reads rises.  Their commits take the fixed-base path
(K=7 above its lower size), which gives the same affine commitments as
the variable-base path in about a third of the CPU time.  Besides: off,
`span()` is one shared no-op that reads no clock; a span that an
exception closes is marked failed; threads keep their own stacks; a
registered counter's delta is carried; and K1/K2's `launch_elements` on
contiguous, broadcast, strided and one-element operands.
"""

import base64
import json
import os
import random
import threading
import time
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from zksnap_tpu_torch import obs
from zksnap_tpu_torch.fields.pallas_mont import launch_elements
from zksnap_tpu_torch.prover import plonk, poly_device
from zksnap_tpu_torch.prover.srs import gen_srs, srs_cache_path

torch.set_num_threads(1)

VECTORS = os.path.join(os.path.dirname(__file__), "vectors")
ROUNDS = ["prove.witness", "prove.grand_product", "prove.quotient",
          "prove.evals", "prove.openings"]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Keygen and the seeded proof with tracing on, from the frozen K=7
    dev SRS arrays; tracing and the fixed-base policy are restored
    afterwards."""
    with open(os.path.join(VECTORS, "torch_port_v1.json")) as f:
        vectors = json.load(f)
    frozen = vectors["seeded_proof_k7"]
    cache = str(tmp_path_factory.mktemp("srs"))
    np.savez(srs_cache_path(7, b"dev", cache), **{
        name: np.frombuffer(zlib.decompress(base64.b64decode(packed)),
                            dtype="<u4").reshape(128, 16)
        for name, packed in vectors["srs_k7_arrays"]["arrays"].items()})
    fb = poly_device._FB_STATE
    saved = fb["min_n"], fb["c"]
    fb.update(min_n=1 << 7, c=8)
    fb["tables"].clear()
    obs.clear()
    obs.enable()
    try:
        srs = gen_srs(7, cache_dir=cache, device="cpu")
        t0 = time.time_ns()
        pk = plonk.keygen(chip_smoke.build_fixed_circuit(), 7, srs,
                          device="cpu")
        proof = plonk.prove(pk, [int(x) for x in frozen["instances"]],
                            random.Random(frozen["rng_seed"]))
        t1 = time.time_ns()
        spans = obs.spans()
    finally:
        obs.disable()
        obs.clear()
        fb["min_n"], fb["c"] = saved
        fb["tables"].clear()
    return dict(proof=proof, frozen=frozen, spans=spans, t0=t0, t1=t1)


def _one(spans, name):
    found = [s for s in spans if s.name == name]
    assert len(found) == 1, name
    return found[0]


def test_seeded_proof_with_tracing_on_is_frozen(traced):
    assert traced["proof"].hex() == traced["frozen"]["proof_hex"]


def test_prove_span_holds_five_rounds_in_order(traced):
    spans = traced["spans"]
    root = _one(spans, "prove")
    assert root.parent is None and root.request == root.id
    assert root.attrs == {"k": 7, "n_advice": 1, "mesh": False}
    rounds = sorted((s for s in spans if s.parent == root.id),
                    key=lambda s: s.start_ns)
    assert [s.name for s in rounds] == ROUNDS
    assert all(s.request == root.id and not s.failed for s in rounds)
    # below the rounds: the fixed-base commits, each inside its round
    ids = {s.id for s in rounds}
    inner = [s for s in spans if s.request == root.id
             and s is not root and s.id not in ids]
    assert inner and all(s.name == "commit.fixed" and s.parent in ids
                         for s in inner)
    assert root.start_ns <= rounds[0].start_ns
    assert rounds[-1].end_ns <= root.end_ns
    for a, b in zip(rounds, rounds[1:]):
        assert a.end_ns <= b.start_ns


def test_keygen_span_holds_layout_and_commits(traced):
    spans = traced["spans"]
    root = _one(spans, "keygen")
    layout, commit = _one(spans, "keygen.layout"), _one(spans, "keygen.commit")
    assert root.parent is None
    for s in (layout, commit):
        assert s.parent == s.request == root.id
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert layout.end_ns <= commit.start_ns


def test_stamps_lie_on_the_unix_clock(traced):
    for s in traced["spans"]:
        assert traced["t0"] <= s.start_ns <= s.end_ns <= traced["t1"]


def test_wait_ns_rises_in_a_proof(traced):
    root = _one(traced["spans"], "prove")
    assert root.counters["wait_ns"] > 0
    rounds = [_one(traced["spans"], r) for r in ROUNDS]
    assert sum(s.counters["wait_ns"] for s in rounds) <= \
        root.counters["wait_ns"]


def test_tracing_off_records_nothing(monkeypatch):
    obs.disable()
    before = obs.spans()
    monkeypatch.setattr(time, "perf_counter_ns",
                        lambda: pytest.fail("a clock read with tracing off"))
    with obs.span("off", k=1) as s, obs.wait():
        pass
    assert s is obs.span("other") is obs._NOOP
    assert obs.spans() == before


def test_failed_span_is_marked():
    obs.clear()
    obs.enable()
    try:
        with pytest.raises(ValueError):
            with obs.span("outer"):
                with obs.span("inner"):
                    raise ValueError("boom")
        inner, outer = obs.spans()[-2:]
    finally:
        obs.disable()
        obs.clear()
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.failed and outer.failed
    assert inner.parent == outer.id and obs._stack() == []


def test_threads_keep_their_own_stacks():
    obs.clear()
    obs.enable()
    entered, release = threading.Event(), threading.Event()

    def other():
        with obs.span("other"):
            entered.set()
            release.wait(10)

    t = threading.Thread(target=other)
    try:
        with obs.span("main"):
            t.start()
            entered.wait(10)
            with obs.span("main.child"):
                pass
            release.set()
            t.join(10)
        spans = {s.name: s for s in obs.spans()}
    finally:
        obs.disable()
        obs.clear()
    assert spans["other"].parent is None
    assert spans["main.child"].parent == spans["main"].id


def test_span_carries_counter_deltas():
    def probe():
        pass

    obs.register(probe, "launches")
    obs.clear()
    obs.enable()
    try:
        probe.launches += 5
        with obs.span("counted"):
            probe.launches += 3
        (s,) = obs.spans()
    finally:
        obs.disable()
        obs.clear()
        obs._counted.pop("probe")
    assert s.counters["probe.launches"] == 3 and s.counters["wait_ns"] == 0


def _rows(*shape):
    return torch.zeros(*shape, 16, dtype=torch.int32)


@pytest.mark.parametrize("case", ["contiguous", "broadcast", "strided",
                                  "one_element"])
def test_launch_elements(case):
    """Output rows plus each operand's distinct rows: a broadcast or
    stride-0 dimension counts once."""
    if case == "contiguous":
        a, b, want = _rows(8), _rows(8), 8 + 8 + 8
    elif case == "broadcast":       # an NTT stage: xb [4, 8] times w[None]
        a, b, want = _rows(4, 8), _rows(8)[None], 32 + 32 + 8
    elif case == "strided":         # xb[:, 1] of [6, 2] rows; an expand
        a = _rows(6, 2)[:, 1]
        b = _rows(1).expand(6, 16)
        want = 6 + 6 + 1
    else:                           # a [16] constant against [5] rows
        a, b, want = _rows(5), _rows(1)[0], 5 + 5 + 1
    n = torch.broadcast_shapes(a.shape, b.shape).numel() // 16
    assert launch_elements(n, a, b) == want
