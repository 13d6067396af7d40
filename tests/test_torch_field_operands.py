"""How the port's field kernels K1 and K2 read their operands in place.

`fields.pallas_mont.operand_view` describes an operand broadcast to the
call's shape as one pointer and two levels of strides: row i at
(i // inner) * s_outer + (i % inner) * s_inner rows.  These tests build
the layouts the prover passes (a contiguous operand, one element for all
rows, the NTT's `w[None]` over a strided twiddle slice, the odd and even
halves `xb[..., 1 or 0, :, :]` of every K=7 stage with and without a
leading batch), gather each one's rows from its storage with the
kernel's own index math (the magic-number division included) and hold
them to `x.expand(shape).reshape(n, 16)`.  Layouts the descriptor
cannot hold are copied once and counted.  The launch geometry is a pure
function of (n, SM count).  All integers: no tolerance.
"""

import random

import numpy as np
import pytest
import torch

from zksnap_tpu_torch.fields import bn254_fr
from zksnap_tpu_torch.fields import pallas_mont as pm
from zksnap_tpu_torch.poly.domain import domain

torch.set_num_threads(1)
DEV = "cpu"
K = 7


def _rows(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, 1 << 16, (n, 16), dtype=np.int64).astype(np.int32))


def _gather(x, shape):
    """x's rows as the kernel reads them: operand_rows' arguments, the
    division by `inner` through (magic, shift), the offsets gathered from
    x's storage."""
    n = shape[:-1].numel()
    (ptr, inner, magic, shift, s_outer, s_inner), t = pm.operand_rows(
        x, shape, n, _Counter())
    assert t is x and ptr == x.data_ptr()
    i = torch.arange(n, dtype=torch.int64)
    q = (((i * magic) >> 32) + i) >> shift
    off = q * s_outer + (i - q * inner) * s_inner
    assert torch.equal(q, i // inner)
    span = int(off.max()) + 1
    base = torch.as_strided(x, (span, 16), (16, 1), x.storage_offset())
    return base[off]


class _Counter:
    copies = 0


def _stage_views(lead, s):
    """(u, odd rows, w[None]) of stage s of a K=7 NTT over a batch `lead`
    (chip_smoke.ntt_stage_operands, written out)."""
    n, m = 1 << K, 1 << s
    x = _rows(int(np.prod(lead, dtype=np.int64)) * n, 7 + s).reshape(
        *lead, n, 16)
    tw = domain(K).twiddles(DEV)
    xb = x.reshape(*lead, n >> (s + 1), 2, m, 16)
    w = tw[:: (n // 2) // m] if m > 1 else tw[:1]
    return xb[..., 0, :, :], xb[..., 1, :, :], w[None, :, :]


def _check_in_place(x, shape):
    assert pm.operand_view(x, shape) is not None
    n = shape[:-1].numel()
    assert torch.equal(_gather(x, shape), x.expand(shape).reshape(n, 16))


@pytest.mark.parametrize("case", ["contiguous", "one element", "one row",
                                  "w[None] of a strided slice"])
def test_descriptor_reads_simple_layouts(case):
    x = _rows(256, 1)
    shape = torch.Size((8, 32, 16))
    view = {"contiguous": x.reshape(8, 32, 16),
            "one element": x[5],
            "one row": x[3:4].reshape(1, 1, 16),
            "w[None] of a strided slice": x[::8][None]}[case]
    _check_in_place(view, shape)


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("s", range(K))
def test_every_k7_stage_reads_in_place(lead, s):
    """Every stage's K1 operands (odd rows, w[None]) and K2 operands (even
    rows against the product) with no copy, with and without a leading
    batch."""
    u, odd, w = _stage_views(lead, s)
    shape = torch.broadcast_shapes(odd.shape, w.shape)
    for x in (odd, w, u):
        _check_in_place(x, shape)
    m, rows = 1 << s, shape[:-1].numel()
    if s == 0:      # one row a block: a single level of stride 2
        want = (rows, 0, 2)
    elif rows == m:  # one block: the odd half is contiguous
        want = (m, 0, 1)
    else:           # lead x blocks fold into one outer level of stride 2m
        want = (m, 2 * m, 1)
    assert pm.operand_view(odd, shape) == want


def test_ntt_views_fold_to_two_levels():
    """xb[..., 1, :, :] at the middle stage of a batched 2^13 NTT: lead x
    blocks fold into one outer level of stride 2m; w[None] has s_outer 0
    and the twiddle slice's step."""
    k, s, lead = 13, 6, (4,)
    n, m = 1 << k, 1 << s
    x = torch.zeros((*lead, n, 16), dtype=torch.int32)
    xb = x.reshape(*lead, n >> (s + 1), 2, m, 16)
    tw = torch.zeros((n // 2, 16), dtype=torch.int32)
    w = tw[:: (n // 2) // m]
    shape = torch.broadcast_shapes(xb[..., 1, :, :].shape, w[None].shape)
    assert pm.operand_view(xb[..., 1, :, :], shape) == (m, 2 * m, 1)
    assert pm.operand_view(w[None], shape) == (m, 0, (n // 2) // m)
    assert pm.operand_view(tw[:1][None], shape) == (
        lead[0] * (n >> (s + 1)) * m, 0, 0)


def _refused():
    x = _rows(512, 3)
    flat = torch.zeros(512 * 16 + 2, dtype=torch.int32)
    misaligned = flat[2:].view(512, 16)
    misaligned.copy_(x)
    cube = x.reshape(4, 8, 1, 16, 16)
    return {"limbs not adjacent": x.t().contiguous().t(),
            "not 16-byte aligned": misaligned,
            "three levels": cube[:, ::3, 0]}


@pytest.mark.parametrize("case", ["limbs not adjacent",
                                  "not 16-byte aligned", "three levels"])
def test_refused_layouts_are_copied_and_counted(case):
    x = _refused()[case]
    shape = x.shape
    n = shape[:-1].numel()
    assert pm.operand_view(x, shape) is None
    counter = _Counter()
    (ptr, inner, magic, shift, s_outer, s_inner), t = pm.operand_rows(
        x, shape, n, counter)
    assert counter.copies == 1
    assert t is not x and t.is_contiguous() and ptr == t.data_ptr()
    assert ptr % 16 == 0
    assert (inner, s_outer, s_inner) == (n, 0, 1)
    assert torch.equal(t, x.reshape(n, 16))
    assert torch.equal(_gather(t, torch.Size((n, 16))), x.reshape(n, 16))


def test_refused_one_element_is_copied_once():
    flat = torch.zeros(18, dtype=torch.int32)
    x = flat[2:]
    x.copy_(_rows(1, 4)[0])
    counter = _Counter()
    args, t = pm.operand_rows(x, torch.Size((64, 16)), 64, counter)
    assert counter.copies == 1 and t.shape == (1, 16)
    assert args[1:] == (1, *pm.divider(1), 0, 0)


def test_operand_checks_dtype_and_width():
    with pytest.raises(ValueError, match="int32"):
        pm.operand_view(torch.zeros((4, 16), dtype=torch.int64),
                        torch.Size((4, 16)))
    with pytest.raises(ValueError, match="int32"):
        pm.operand_view(torch.zeros((4, 8), dtype=torch.int32),
                        torch.Size((4, 8)))


@pytest.mark.parametrize("d", [1, 2, 3, 7, 64, 1000, 8191, 12345677,
                               1 << 30, (1 << 31) - 1])
def test_divider_matches_integer_division(d):
    magic, shift = pm.divider(d)
    assert 0 < magic < 1 << 32 and 0 <= shift <= 31
    rng = random.Random(d)
    for i in [0, 1, d - 1, d, d + 1, (1 << 31) - 1] + [
            rng.randrange(1 << 31) for _ in range(2000)]:
        assert (((i * magic) >> 32) + i) >> shift == i // d


@pytest.mark.parametrize("n, sms", [
    (1, 132), (31, 132), (4096, 132), (8192, 132), (8192, 114),
    (32768, 132), (1 << 21, 132), ((1 << 21) + 1, 132), (1 << 23, 132)])
def test_launch_geometry(n, sms):
    threads, blocks = pm.launch_geometry(n, sms)
    assert threads in (32, 64, 128, 256)
    assert blocks == -(-n // threads) and threads * blocks >= n
    # the largest block that still gives every SM one, down to 32 threads
    assert blocks >= sms or threads == 32
    assert threads == 256 or -(-n // (2 * threads)) < sms
    if n == 8192 and sms == 132:
        assert blocks >= 128


def test_cpu_operands_take_the_plain_version():
    """CPU operands never reach the descriptors: no launch, no copy, even
    for a layout the kernels would copy."""
    F = bn254_fr()
    x = _refused()["limbs not adjacent"]
    x = x % 0x3000  # below the modulus's top limb
    before = (pm.mont_mul.launches, pm.mont_mul.copies,
              pm.mont_addsub.copies)
    got = F.mul(x, x[3])
    assert torch.equal(got, pm.mont_mul_plain(x.contiguous(), x[3], F.p))
    F.add(x, x)
    assert (pm.mont_mul.launches, pm.mont_mul.copies,
            pm.mont_addsub.copies) == before
