"""Number-theoretic transform over BN254 Fr: single device and
mesh-sharded (PyTorch port of zksnap_tpu/poly/ntt.py).

Single device: `_ntt_impl`.  On a CUDA tensor it launches the NTT
kernels (csrc/ntt.cu): one launch a pass of `ntt_plan`, each pass whole
sub-transforms of at most 2^11 elements in shared memory, the four-step
twiddle between passes.  On a CPU tensor it runs `_ntt_plain`, the
kernels' plain version: iterative radix-2 decimation-in-time, a
bit-reversal gather, then k stages, each one batched multiply (K1) and
one add and one subtract (K2) over [..., n/2, 16] limb tensors.

Mesh: the four-step NTT -- the length-n vector as an n1 x n2 matrix
sharded by rows over a 1-D `parallel.Mesh`; local NTTs of length n2, a
twiddle scale, one exchange between the mesh's devices (the JAX
package's all_to_all), then NTTs of length n1.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import obs
from ..fields.common import N_LIMBS
from ..fields.field import PrimeField
from .domain import Domain, domain


def _u32(x):
    """Widen an at-rest (possibly int16) limb tensor to the int32 compute
    form (the JAX package's uint32 widening)."""
    if x.dtype == torch.int16:
        return x.to(torch.int32) & 0xFFFF
    return x


@functools.cache
def _bitrev_perm(k: int) -> np.ndarray:
    n = 1 << k
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def _ntt_plain(x, twiddles, k: int, F: PrimeField):
    """The NTT kernels' plain version: x [..., n, 16] int32 coefficients
    -> [..., n, 16] evaluations (natural order), one transform for each
    index of the leading dimensions (the JAX package's vmap, written out
    as a batch), on any device.

    twiddles: [n/2, 16] table of omega^i on x's device."""
    n = 1 << k
    lead = x.shape[:-2]
    perm = torch.from_numpy(_bitrev_perm(k))
    with obs.wait():  # a copy from the host waits on the stream
        perm = perm.to(x.device)
    x = x[..., perm, :]
    for s in range(k):
        m = 1 << s          # half-block
        nb = n >> (s + 1)   # number of blocks
        xb = x.reshape(*lead, nb, 2, m, 16)
        u = xb[..., 0, :, :]
        # twiddle for position j in a block: omega^(j * n/(2m))
        w = twiddles[:: (n // 2) // m] if m > 1 else twiddles[:1]
        t = F.mul(xb[..., 1, :, :], w[None, :, :])
        x = torch.cat([F.add(u, t), F.sub(u, t)], dim=-2).reshape(
            *lead, n, 16)
    return x


def _ntt_impl(x, twiddles, k: int, F: PrimeField, pre=None, post=None):
    """x: [..., n, 16] coefficients, int32 or the int16 at-rest form ->
    [..., n, 16] int32 evaluations (natural order), one transform for each
    index of the leading dimensions.  `pre` ([n, 16]) multiplies input row
    i before the transform, `post` ([16]) every output after it.

    twiddles: [n/2, 16] table of omega^i on x's device.  A CUDA tensor
    launches the NTT kernels (`ntt_kernel`); a CPU tensor runs the plain
    version."""
    if x.is_cuda:
        return ntt_kernel(x, twiddles, k, F, pre, post)
    x = _u32(x)
    if pre is not None:
        x = F.mul(x, pre)
    y = _ntt_plain(x, twiddles, k, F)
    return y if post is None else F.mul(y, post)


# ---------------------------------------------------------------------------
# The NTT kernels (csrc/ntt.cu): the pass plan and the launches
# ---------------------------------------------------------------------------

TILE_LOG = 11    # a block's elements (C sub-transforms of 2^b, C 2^b), and
# so a pass's widest sub-transform: 2^11 x 32 B of shared memory
MIN_BLOCKS = 256  # a pass keeps this many blocks where the batch allows
MAX_PASSES = 8    # csrc/ntt.cu's NTT_MAX_PASSES
MAX_THREADS = 256


def pass_widths(k: int, max_bits: int = TILE_LOG) -> tuple[int, ...]:
    """The fewest passes of at most `max_bits` bits that cover k, as even
    as they come, the wider first (21 -> 11, 10)."""
    passes = max(1, -(-k // max_bits))
    q, r = divmod(k, passes)
    return tuple(q + 1 if i < r else q for i in range(passes))


class Plan(NamedTuple):
    """How the kernels cut a batch of 2^k transforms: pass p transforms
    digit p (`widths[p]` bits) and holds 2^cols_log[p] sub-transforms a
    block; `stage_log` is the widest pass (the stage table's root order,
    log2), `split` the bits of the inter-pass twiddle table w^lo."""
    k: int
    batch: int
    widths: tuple
    cols_log: tuple
    stage_log: int
    split: int

    def blocks(self, p: int) -> int:
        cols = self.batch << (self.k - self.widths[p])
        return -(-cols >> self.cols_log[p])

    def threads(self, p: int) -> int:
        butterflies = (1 << (self.cols_log[p] + self.widths[p])) >> 1
        return min(MAX_THREADS, max(32, butterflies))


def plan_passes(k: int, batch: int, widths) -> Plan:
    """The plan for `widths` (which sum to k): each pass holds as many
    sub-transforms a block as fit TILE_LOG, fewer where the pass would
    have fewer than MIN_BLOCKS blocks."""
    if sum(widths) != k or not 1 <= len(widths) <= MAX_PASSES:
        raise ValueError(f"pass widths {widths} for 2^{k}")
    cols_log = []
    for b in widths:
        cols = batch << (k - b)
        fill = max(1, cols // MIN_BLOCKS).bit_length() - 1
        cols_log.append(max(0, min(TILE_LOG - b, fill)))
    return Plan(k, batch, tuple(widths), tuple(cols_log), max(widths),
                (k + 1) // 2)


@functools.lru_cache(maxsize=256)
def ntt_plan(k: int, batch: int) -> Plan:
    """The kernels' plan for `batch` transforms of 2^k: from k and the
    batch alone."""
    return plan_passes(k, batch, pass_widths(k))


def _packed(t):
    """[r, 16] int32 limbs -> [r, 8] int32 words (limb 2i + 2^16 limb
    2i+1, the int16 at-rest form's bytes)."""
    w = t[:, 0::2].to(torch.int64) + (t[:, 1::2].to(torch.int64) << 16)
    return (w - ((w >> 31) << 32)).to(torch.int32)


_TABLES = WeakIdKeyDictionary()  # twiddles -> {(stage_log, split): tables}


def _tables(twiddles, plan: Plan, F: PrimeField):
    """The kernels' twiddle rows from `twiddles` ([n/2, 16] of w^i), packed
    ([rows, 8] int32), and the first rows of the lo and hi tables: the
    2^(stage_log-1) stage twiddles of the 2^stage_log-th root (rows
    i 2^(k - stage_log) of `twiddles`), then, where the plan has more than
    one pass, w^lo for lo < 2^split and w^(hi 2^split) for
    hi < 2^(k - split) (past n/2 the negated rows: w^(n/2) = -1).  Built
    once for each table and plan shape."""
    per = _TABLES.setdefault(twiddles, {})
    key = (plan.stage_log, plan.split)
    if key not in per:
        k, sl, s = plan.k, plan.stage_log, plan.split
        parts = [twiddles[:: 1 << (k - sl)]] if sl else []
        lo_row = sum(len(p) for p in parts)
        if len(plan.widths) > 1:
            half = twiddles[:: 1 << s]
            parts += [twiddles[: 1 << s], half, F.neg(half)]
        hi_row = lo_row + (1 << s)
        rows = (torch.cat(parts) if parts
                else twiddles.new_zeros((1, N_LIMBS)))
        per[key] = (_packed(rows).contiguous(), lo_row, hi_row)
    return per[key]


@functools.lru_cache(maxsize=256)
def _pass_params(plan: Plan, in16: bool, lo_row: int, hi_row: int) -> tuple:
    """Each pass's parameter array for `zk_ntt_pass` (csrc/ntt.cu's order:
    first, last, in16, batch, k, passes, p, cols_log, stage_log, split,
    lo_row, hi_row, blocks, threads, then the passes' widths)."""
    last = len(plan.widths) - 1
    out = []
    for p in range(last + 1):
        params = (ctypes.c_int * (14 + MAX_PASSES))()
        params[:14] = [int(p == 0), int(p == last), int(in16), plan.batch,
                       plan.k, last + 1, p, plan.cols_log[p], plan.stage_log,
                       plan.split, lo_row, hi_row, plan.blocks(p),
                       plan.threads(p)]
        params[14:15 + last] = list(plan.widths)
        out.append(params)
    return tuple(out)


def ntt_kernel(x, twiddles, k: int, F: PrimeField, pre=None, post=None):
    """`_ntt_impl` on x's card: one launch of csrc/ntt.cu a pass of
    `ntt_plan(k, batch)`.  x is read in place (int32, or int16 at rest);
    the result is a fresh contiguous [..., n, 16] int32.
    `ntt_kernel.launches` counts launches, `.transforms` the transforms;
    while tracing is on (`obs`) `.launch_ns` adds each call's host time."""
    from .. import kernels

    t0 = time.perf_counter_ns() if obs.ON else 0
    n = 1 << k
    if x.dtype not in (torch.int16, torch.int32) or x.shape[-2:] != (
            n, N_LIMBS):
        raise ValueError(f"NTT operand {x.dtype} {tuple(x.shape)}, expected "
                         f"int16 or int32 [..., {n}, {N_LIMBS}]")
    lead = x.shape[:-2]
    batch = x.numel() // (n * N_LIMBS)
    if batch * n >= 1 << 31:
        raise ValueError(f"{batch} transforms of 2^{k}: the kernels take "
                         f"fewer than 2^31 rows")
    extra = [t for t in (pre, post) if t is not None]
    on = kernels.on_device(x, twiddles, *extra)
    kernels.rows(twiddles, max(n // 2, 1))
    pre_ptr = None if pre is None else kernels.rows(pre, n)
    post_ptr = None if post is None else kernels.rows(post, 1)
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernels read a row as 16-byte vectors
        raise ValueError("NTT operand rows must be 16-byte aligned")
    out = torch.empty((*lead, n, N_LIMBS), dtype=torch.int32,
                      device=x.device)
    if batch == 0:
        return out
    plan = ntt_plan(k, batch)
    tab, lo_row, hi_row = _tables(twiddles, plan, F)
    passes = _pass_params(plan, x.dtype == torch.int16, lo_row, hi_row)
    lib = kernels.library()
    mod = kernels.mod_ptr(F.p)
    src, dst = x.data_ptr(), out.data_ptr()
    with on as stream:
        for p, params in enumerate(passes):
            err = lib.zk_ntt_pass(src if p == 0 else dst, dst, tab.data_ptr(),
                                  pre_ptr if p == 0 else None,
                                  post_ptr if p == len(passes) - 1 else None,
                                  params, mod, stream)
            kernels.check(err, "zk_ntt_pass")
            ntt_kernel.launches += 1
    ntt_kernel.transforms += batch
    if t0:
        ntt_kernel.launch_ns += time.perf_counter_ns() - t0
    return out


ntt_kernel.launches = 0
ntt_kernel.transforms = 0
obs.register(ntt_kernel, "launches", "transforms", "launch_ns")


class NTT:
    """NTT / inverse NTT for one domain size."""

    def __init__(self, dom: Domain):
        self.dom = dom
        self.F = dom.F
        self.k = dom.k

    def forward(self, x):
        """Coefficients -> evaluations on the domain (natural order)."""
        return _ntt_impl(x, self.dom.twiddles(x.device), self.k, self.F)

    def inverse(self, y):
        """Evaluations -> coefficients."""
        return _ntt_impl(y, self.dom.twiddles_inv(y.device), self.k, self.F,
                         post=self.F.const_t(self.dom.n_inv, y.device))


@functools.cache
def ntt(k: int) -> NTT:
    return NTT(domain(k))



# ---------------------------------------------------------------------------
# Mesh-sharded four-step NTT
# ---------------------------------------------------------------------------

def four_step_input_perm(k: int, ndev: int) -> np.ndarray:
    """Gather indices putting x into the cyclic layout four_step_ntt expects:
    device d must hold x[d], x[d + n1], ..., x[d + (n2-1)*n1]."""
    n, n1 = 1 << k, ndev
    n2 = n // n1
    i = np.arange(n)
    return (i % n2) * n1 + i // n2  # x_prepared[d*n2 + j] = x[d + n1*j]


def four_step_output_perm(k: int, ndev: int) -> np.ndarray:
    """Gather indices mapping four_step_ntt's output (concatenated over
    devices) back to natural evaluation order: natural[X] = out[perm[X]]."""
    n, n1 = 1 << k, ndev
    n2 = n // n1
    chunk = n2 // n1  # t2-values per device after the transpose
    X = np.arange(n)
    t1, t2 = X // n2, X % n2
    d, r = t2 // chunk, t2 % chunk
    return d * n2 + t1 * chunk + r


@functools.lru_cache(maxsize=64)
def _shard_scale(k: int, ndev: int, d: int, inverse: bool, device: str):
    """Shard d's twiddle scale [n2, 16]: w^(d * t2) for t2 < n2, w the
    n-th root of unity (its inverse for `inverse`)."""
    dom = domain(k)
    w = dom.omega_inv if inverse else dom.omega
    return dom.powers_of(pow(w, d, dom.F.p), k - (ndev.bit_length() - 1),
                         device)


def four_step_ntt(x, k: int, mesh, axis: str = "x", inverse: bool = False):
    """NTT of size n = 2^k over the devices of `mesh` along `axis`.

    x: [n, 16] in the cyclic layout of `four_step_input_perm` (shard d
    takes rows [d*n2, (d+1)*n2), the residue class d).  Returns, on
    x's device, the permuted evaluation layout undone by
    `four_step_output_perm`.

    `inverse=True` runs the transform with omega^-1 throughout (the caller
    scales by n^-1), so iNTTs shard the same way.

    Math (s = i1 + n1*i2, t = t2 + n2*t1):
      X[t2 + n2 t1] = sum_i1 (w^(i1 t2) * NTT_n2(x[i1 + n1*.])[t2]) * (w^n2)^(i1 t1)
    i.e. local length-n2 NTTs -> twiddle scale by w^(i1*t2) -> the
    exchange (shard j receives chunk j of every shard) -> local length-n1
    NTTs, batched over the chunk.
    """
    devs = mesh.axis_devices(axis)
    ndev = len(devs)
    n = 1 << k
    if ndev & (ndev - 1) or n % ndev:
        raise ValueError(f"four-step NTT of 2^{k} over {ndev} devices")
    k1 = ndev.bit_length() - 1
    k2 = k - k1
    n1, n2 = ndev, n >> k1
    if n2 % n1:
        raise ValueError(f"four-step NTT needs n >= ndev^2 (2^{k}, {ndev})")
    chunk = n2 // n1
    d2, d1 = domain(k2), domain(k1)
    F = d2.F

    parts = []
    for d, dev in enumerate(devs):
        tw2 = d2.twiddles_inv(dev) if inverse else d2.twiddles(dev)
        y = _ntt_impl(x[d * n2:(d + 1) * n2].to(dev), tw2, k2, F)  # over t2
        y = F.mul(y, _shard_scale(k, ndev, d, inverse, str(dev)))
        parts.append(y.reshape(n1, chunk, 16))
    out = []
    for j, dev in enumerate(devs):
        z = torch.stack([p[j].to(dev) for p in parts], dim=1)  # [chunk, n1, 16]
        if k1 > 0:
            tw1 = d1.twiddles_inv(dev) if inverse else d1.twiddles(dev)
            z = _ntt_impl(z, tw1, k1, F)
        out.append(z.transpose(0, 1).reshape(n2, 16).to(x.device))
    return torch.cat(out)
