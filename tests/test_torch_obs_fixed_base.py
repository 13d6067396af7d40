"""The fixed-base commit's span and counter (msm/fixed_base.py, obs.py) on
the CPU: a commit of 2^12 points at the policy's window c = 16.  With
tracing on it is one `commit.fixed` span carrying n, c, windows and
groups, `commit_fixed.pairs` rises by W * n, and the commitment equals
the same commit with tracing off; with tracing off no span is kept.

The table holds 16 distinct points, each window's rows the same points
(not shifted by 2^(c*w)): the span, the counter and the on/off equality
do not depend on the table's values, and its doublings would cost about
25 s here.  Tolerance: none, the commits are compared bit for bit.
"""

import random

import pytest
import torch

from zksnap_tpu_torch import obs
from zksnap_tpu_torch.curves.native import BN254_G1, AffinePoint
from zksnap_tpu_torch.curves.proj import bn254_proj_ops
from zksnap_tpu_torch.fields import ints_to_limbs
from zksnap_tpu_torch.msm import fixed_base

torch.set_num_threads(1)

N = 1 << 12
C = 16


@pytest.fixture(scope="module")
def untraced():
    """The table, the scalars, and one commit with tracing off: its
    result, the spans it left and its counter delta."""
    rng = random.Random(12)
    g = AffinePoint.generator(BN254_G1)
    base = [rng.randrange(1, BN254_G1.n) * g for _ in range(16)]
    ops = bn254_proj_ops()
    P = ops.from_affine_host([base[i % 16] for i in range(N)], "cpu")
    W = -(-254 // C)
    table = fixed_base.FixedBaseTable(
        *(t.repeat(W, 1) for t in (P.x, P.y, P.z)), N, C, W)
    scal = torch.from_numpy(ints_to_limbs(
        [rng.randrange(BN254_G1.n) for _ in range(N)]))
    assert not obs.ON
    obs.clear()
    before = fixed_base.commit_fixed.pairs
    r = fixed_base.commit_fixed(table, scal)
    return dict(table=table, scal=scal, r=r, spans=obs.spans(),
                pairs=fixed_base.commit_fixed.pairs - before)


@pytest.mark.parametrize("tracing", ["off", "on"])
def test_commit_fixed_span_and_pairs(untraced, tracing):
    table = untraced["table"]
    W = table.n_windows
    if tracing == "off":
        assert untraced["spans"] == []
        assert untraced["pairs"] == W * N
        return
    obs.clear()
    obs.enable()
    try:
        with obs.span("outer") as outer:
            r = fixed_base.commit_fixed(table, untraced["scal"])
        spans = obs.spans()
    finally:
        obs.disable()
        obs.clear()
    commits = [s for s in spans if s.name == "commit.fixed"]
    assert len(commits) == 1
    s = commits[0]
    assert s.attrs == {"n": N, "c": C, "windows": W, "groups": 1}
    assert s.parent == outer.id and not s.failed
    # the commit's own span carries its pairs, as does every span round it
    assert s.counters["commit_fixed.pairs"] == W * N == 16 * N
    assert outer.counters["commit_fixed.pairs"] == W * N
    for a in ("x", "y", "z"):
        assert torch.equal(getattr(r, a), getattr(untraced["r"], a))


@pytest.mark.parametrize("n, groups", [(1 << 12, 1), (1 << 18, 1),
                                       (1 << 19, 2), (1 << 20, 4)])
def test_window_groups(n, groups):
    """W * n pairs in groups of at most PAIR_GROUP (2^22): one group
    through k=18 at c = 16, then 8 and 4 windows a group."""
    W = -(-254 // C)
    wg = fixed_base.window_group(n, W)
    assert -(-W // wg) == groups
    assert min(wg, W) * n <= fixed_base.PAIR_GROUP
