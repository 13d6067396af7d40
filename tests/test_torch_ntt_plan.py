"""The NTT kernels' pass plan (poly/ntt.py `ntt_plan`) and its arithmetic.

The kernels (csrc/ntt.cu) run only on the card; here a plain PyTorch
executor of a plan takes the same steps in the same order -- the pass
order, each pass's rows and the places it writes them to, the bit
reversal inside a sub-transform, the stage and inter-pass twiddles read
from the same packed rows (`_tables`) -- and is held bit-exact against
`_ntt_impl`'s plain version, which tests/test_torch_msm_ntt.py holds to
the JAX package.  Pass widths are forced down to 1-4 bits so that small
transforms take three to six passes.  Tolerance: none.
"""

import importlib

import numpy as np
import pytest
import torch

from zksnap_tpu_torch.fields import bn254_fr
from zksnap_tpu_torch.poly.domain import domain
from zksnap_tpu_torch.prover.poly_device import pack_poly

torch.set_num_threads(1)
DEV = "cpu"
nt = importlib.import_module("zksnap_tpu_torch.poly.ntt")  # the package
# exports the function `ntt` under the module's name
SMEM_BYTES = 232448  # an H100 block's most shared memory


@pytest.mark.parametrize("batch", [1, 3, 8, 1 << 17])
def test_plan_covers_every_k(batch):
    for k in range(1, 27):
        plan = nt.ntt_plan(k, batch)
        assert sum(plan.widths) == k and len(plan.widths) <= nt.MAX_PASSES
        assert all(1 <= b <= nt.TILE_LOG for b in plan.widths)
        assert len(plan.widths) == -(-k // nt.TILE_LOG)
        assert plan.stage_log == max(plan.widths)
        assert 1 <= plan.split <= max(k - 1, 1)
        for p, b in enumerate(plan.widths):
            tile = 1 << (plan.cols_log[p] + b)
            assert tile <= 1 << nt.TILE_LOG
            assert 32 * tile <= 65536 <= SMEM_BYTES
            assert (plan.blocks(p) << plan.cols_log[p]) >= batch << (k - b)
            assert 32 <= plan.threads(p) <= nt.MAX_THREADS
            assert plan.threads(p) <= max(32, tile // 2)
    assert nt.ntt_plan(21, 1).widths == (11, 10)
    assert nt.ntt_plan(21, 1).cols_log == (0, 1)


def _unpack(words):
    """[r, 8] packed words -> [r, 16] int32 limbs."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(
        len(w), 16).to(torch.int32)


def _bitrev(b: int) -> torch.Tensor:
    i = torch.arange(1 << b)
    r = torch.zeros_like(i)
    for bit in range(b):
        r |= ((i >> bit) & 1) << (b - 1 - bit)
    return r


def _by_passes(x, twiddles, plan, F, pre=None, post=None):
    """The kernels' steps in plain PyTorch: x [B, n, 16] (int16 or int32)
    -> [B, n, 16] int32, pass by pass as csrc/ntt.cu takes them."""
    k, widths = plan.k, plan.widths
    n, P = 1 << k, len(widths)
    lo = [sum(widths[:j]) for j in range(P)]
    tab, lo_row, hi_row = nt._tables(twiddles, plan, F)
    rows = _unpack(tab)
    xs = nt._u32(x)
    out = torch.zeros((x.shape[0], n, 16), dtype=torch.int32)
    for p, b in enumerate(widths):
        gcols = k - b
        g = torch.arange(1 << gcols)[:, None]   # the columns
        t = torch.arange(1 << b)[None, :]       # a column's elements
        if p == 0:
            v = xs[:, (t << gcols) | g]          # rows t 2^(k - b) + g
            if pre is not None:
                v = F.mul(v, pre[(t << gcols) | g])
            dst = t | torch.zeros_like(g)
            for j in range(1, P):                # spread_digits
                dst |= ((g >> (k - lo[j] - widths[j]))
                        & ((1 << widths[j]) - 1)) << lo[j]
        else:                                    # insert_digit
            dst = ((g & ((1 << lo[p]) - 1)) | (t << lo[p])
                   | ((g >> lo[p]) << (lo[p] + b)))
            v = out[:, dst]
        v = v[:, :, _bitrev(b)]                  # loaded to bit-reversed places
        for s in range(b):                       # radix-2 stages
            m = 1 << s
            vb = v.reshape(v.shape[0], v.shape[1], -1, 2, m, 16)
            u, w = vb[..., 0, :, :], vb[..., 1, :, :]
            if s:
                w = F.mul(w, rows[torch.arange(m) << (plan.stage_log - 1 - s)])
            v = torch.cat([F.add(u, w), F.sub(u, w)], dim=-2).reshape(v.shape)
        if p == P - 1:
            if post is not None:
                v = F.mul(v, post)
        else:
            r = g if p == 0 else sum(           # gather_digits
                ((dst >> lo[j]) & ((1 << widths[j]) - 1))
                << (k - lo[j] - widths[j]) for j in range(p + 1, P))
            e = (t * r) << lo[p]
            tw = F.mul(rows[lo_row + (e & ((1 << plan.split) - 1))],
                       rows[hi_row + (e >> plan.split)])
            v = F.mul(v, tw)
        out[:, dst] = v
    return out


# (k, widest pass, batch, int16 input, pre, post, inverse)
CASES = [
    (1, 1, 3, False, True, True, False),
    (2, 1, 1, True, False, True, True),
    (3, 1, 2, False, True, False, False),
    (4, 2, 3, True, True, True, True),
    (5, 2, 1, False, False, False, False),
    (6, 2, 2, True, True, False, True),
    (7, 2, 3, False, False, True, False),
    (8, 3, 1, True, True, True, False),
    (9, 3, 2, False, False, True, True),
    (10, 2, 1, True, True, False, False),
    (11, 4, 2, False, True, True, True),
    (12, 2, 1, True, False, False, False),
    (12, 3, 2, False, True, True, True),
    (12, 4, 1, True, True, True, False),
]


@pytest.mark.parametrize("k,bits,batch,in16,pre,post,inverse", CASES,
                         ids=[f"k{c[0]}-b{c[1]}" for c in CASES])
def test_passes_match_plain(k, bits, batch, in16, pre, post, inverse):
    F = bn254_fr()
    n = 1 << k
    rng = np.random.default_rng(1700 + 31 * k + bits)
    vals = [int(v) * int(w) % F.p for v, w in
            zip(rng.integers(0, 1 << 62, batch * n),
                rng.integers(1, 1 << 62, batch * n))]
    vals[0] = 0
    vals[-1] = F.p - 1
    x = F.to_mont(vals, DEV).reshape(batch, n, 16)
    d = domain(k)
    tw = d.twiddles_inv(DEV) if inverse else d.twiddles(DEV)
    pre_t = (F.to_mont([int(v) for v in rng.integers(1, 1 << 62, n)], DEV)
             if pre else None)
    post_t = F.const_t(d.n_inv if inverse else 7, DEV) if post else None
    if in16:
        x = pack_poly(x)
        assert x.dtype == torch.int16
    plan = nt.plan_passes(k, batch, nt.pass_widths(k, bits))
    got = _by_passes(x, tw, plan, F, pre_t, post_t)
    want = nt._ntt_impl(x, tw, k, F, pre=pre_t, post=post_t)
    assert want.dtype == torch.int32
    assert torch.equal(got, want)


def test_tables_are_the_roots_powers():
    F = bn254_fr()
    k = 7
    d = domain(k)
    plan = nt.plan_passes(k, 1, (3, 2, 2))
    tab, lo_row, hi_row = nt._tables(d.twiddles(DEV), plan, F)
    got = F.from_mont(_unpack(tab))
    w = d.omega
    assert got[:lo_row] == [pow(w, i << (k - 3), F.p) for i in range(4)]
    assert got[lo_row:hi_row] == [pow(w, i, F.p) for i in range(1 << 4)]
    assert got[hi_row:] == [pow(w, i << 4, F.p) for i in range(1 << 3)]
    assert nt._tables(d.twiddles(DEV), plan, F)[0] is tab
