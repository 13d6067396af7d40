"""The readers of the fixed-base metrics (metrics/commit_s.fixed.py,
metrics/roofline_pct.msm_fixed.py) on a window built by hand: two
`prove` spans, each holding one `commit.fixed` span over which the
program's counter `commit_fixed.pairs` rises by 2^22, and K4's device
seconds in the trace.  The share is the pairs' bound over K4's seconds;
a window without such spans or counter (a program before them, or a
cell of variable-base commits) and a CPU run read None."""

import pytest

from portbench import run

PAIRS = 1 << 22
K4_S = 0.004


def _window(obs, fixed_base, commits: bool):
    for _ in range(2):
        with obs.span("prove"):
            with obs.span("prove.witness"):
                if commits:
                    with obs.span("commit.fixed", n=1 << 18, c=16,
                                  windows=16, groups=1):
                        fixed_base.commit_fixed.pairs += PAIRS


def _run(device="cuda"):
    return run.Run(device=device, setup_s=0.0, spans={}, proofs=2,
                   window_s=1.0,
                   ops={"void bucket_scan_kernel<true>(int const*)": [2, K4_S],
                        "void point_kernel<3>(int const*)": [9, 1.0]})


@pytest.mark.parametrize("commits", [True, False])
def test_fixed_base_readers(commits):
    from zksnap_tpu_torch import obs
    from zksnap_tpu_torch.msm import fixed_base

    was_on = obs.ON  # loading program_spans switches tracing on
    bench = run.Bench()
    roof = bench.reader("roofline_pct.msm_fixed")
    spans = bench.reader("commit_s.fixed")
    obs.clear()
    obs.enable()
    try:
        _window(obs, fixed_base, commits)
        if commits:
            share = roof.read(_run())
            assert share == pytest.approx(
                100.0 * roof.bound_s(2 * PAIRS) / K4_S)
            assert 0 < share < 100
            assert spans.read(_run()) > 0
            assert roof.read(_run("cpu")) is None
        else:
            assert roof.read(_run()) is None
            assert spans.read(_run()) is None
    finally:
        obs.clear()
        if not was_on:
            obs.disable()
