"""The per-layer metrics that read the program's own spans and counters
(portbench/program_spans.py).  On the CPU: a traced run of the test-only
cell reports the five rounds, keygen's two parts and the host's wait,
and neither launch_us nor roofline_pct.field, which need a card; it stays
correct.  On the card (`-m card`): the program's spans and the
profiler's events share a clock, for the launches of K1 and K2 that the
profiler sees inside each round span are the launches that the span's
counters carry."""

import os

import pytest

from portbench import generator, run

from .test_portbench_runs import RUN, _run

CELLS = os.path.join(os.path.dirname(__file__), "cells")
SEED = 2147483659
ROUNDS = ("witness", "grand_product", "quotient", "evals", "openings")
SPAN_METRICS = {f"round_s.{r}" for r in ROUNDS} | {
    "keygen_layout_s", "keygen_commit_s", "host_wait_s"}
FIELD_KERNELS = ("mont_mul_kernel", "mont_addsub_kernel")


def test_traced_cpu_run_reports_the_program_spans():
    p, res = _run(RUN + ["--seed", str(SEED), "--seconds", "0.001",
                         "--trace", "1", "--device", "cpu"], timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    assert res["correct"] is True
    got = set(res["metrics"])
    assert SPAN_METRICS <= got
    assert not got & {"launch_us", "roofline_pct.field"}
    assert all(res["metrics"][m]["value"] > 0 for m in SPAN_METRICS)


def _field_launch_stamps(prof) -> list:
    """Host stamps of the runtime's launch calls (cudaLaunchKernel and
    its kin) that launched K1 or K2: each device kernel carries the
    correlation id of the call that launched it."""
    from torch.autograd import DeviceType

    from portbench.devtrace import kernel_name

    events = list(prof.profiler.kineto_results.events())
    ids = {e.correlation_id() for e in events
           if e.device_type() == DeviceType.CUDA
           and kernel_name(e.name()) in FIELD_KERNELS}
    return sorted(e.start_ns() for e in events
                  if e.device_type() != DeviceType.CUDA
                  and "LaunchKernel" in e.name()
                  and e.correlation_id() in ids)


@pytest.mark.card
def test_round_spans_share_the_profilers_clock(cuda_card):
    import bisect

    from torch.profiler import ProfilerActivity, profile

    from zksnap_tpu_torch import obs

    setup = run.prepare(run.Bench(CELLS), "arith_k7.prove", SEED, "cuda")
    obs.clear()
    obs.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            setup.prove(generator.request_rng(SEED, 1))
            setup.sync()
        spans = obs.spans()
    finally:
        obs.disable()
        obs.clear()
    stamps = _field_launch_stamps(prof)
    assert stamps, "the profiler saw no launch of K1 or K2"
    rounds = [s for s in spans if s.name.startswith("prove.")]
    assert [s.name for s in rounds] == [f"prove.{r}" for r in ROUNDS]
    for s in rounds:
        seen = (bisect.bisect_right(stamps, s.end_ns)
                - bisect.bisect_left(stamps, s.start_ns))
        counted = (s.counters["mont_mul.launches"]
                   + s.counters["mont_addsub.launches"])
        assert counted > 0 and seen == counted, (s.name, seen, counted)
