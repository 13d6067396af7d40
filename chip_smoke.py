"""Drive the PyTorch port (zksnap_tpu_torch) through its main path on one
CUDA GPU and check it: the quickest proof that the port still starts.

    python3 chip_smoke.py

Phases:
  1. build the eleven hand-written CUDA kernels from csrc/ (one nvcc for
     each source, all started together, timed; ptxas registers and
     spills logged; the main loop of each K11 chain from cuobjdump -sass;
     K11's dot kernels' step loops (dot_report: a 0-byte frame each and
     no LDS/STS in a step);
     K4's and K5's kernels' registers, stack frames and SASS instruction
     mix; K3's six kinds and K6's RCB kernel required inlined: a 0-byte
     stack frame and no CALL and no LDL/STL in their SASS; K1's kernels
     required inlined too (no frame, no CALL, no local memory) and the
     ptxas lines of K3's projective kinds and K4-K6 those of
     K3_K6_PTXAS; the NTT kernels' instantiations with no stack frame and
     no spills);
  2. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes, edge cases included, bit-exact, and time both.
     K1 and K2 (add, sub) first (check_field_kernels): all four fields at
     ragged n (FIELD_RAGGED_N) with edge values first and last and
     one-element operands; three stages' strided and broadcast views of
     the plain NTT at 2^21 and 2^23 (a leading batch of 4), none copied;
     three layouts the kernels cannot read in place, each copied once and
     counted; their times at a middle stage's views and the host split of
     one call at n = 8192.  The NTT kernels (check_ntt_kernel) against
     their plain version at 2^21, 2^18 and 2^13 through the prover's
     coset_evals (int16 in, the coset powers folded in), evals_to_coeffs
     (n^-1 folded in) and coeffs_to_evals, with no K1 or K2 launch, the
     mesh's local transforms on every card, a misaligned operand refused,
     and their times against the plain version's.  Then
     the k=13 path's (n = 8192 field elements and points; the fixed-base
     bucket stream of 16 * 8192 pairs), the k=21 path's (field ops over
     2^21 rows; padd over 32768 lanes; a variable-base pass of 2 * 2^21
     signed-digit pairs, M = 32768 lanes x K = 128 steps; the fused
     reduction at W = 16 windows of B = 2^15 buckets and c = 16) and
     K=7's fused reduction (W = 32 windows of 128, c = 8), K4's and K5's
     Jacobian branches (b3 = 0) at the k=13 and K=7 shapes; K3's six
     kinds at ragged n (RAGGED_N) with identities, P == Q and P == -P
     first and last; K6 at W = 1 and 2 too, and its device time a launch
     at c = 16 over W = 1 to 16 fitted as a + b c (W - 1), b the
     microseconds a dependent doubling; then K7 and K8 through their own
     entry points (point_add_batch, point_dbl_batch, point_add_staged),
     which launch K3's Jacobian kinds as the SRS's double-and-add does,
     once each at n = 2^20 with the counts read, then against their plain
     versions at n = 2^20 and n = 32768, edge cases included, the staged
     add against the fused one, K8's add also on a batch with P == Q on
     every lane and on one with the edge cases inside every warp; K3's
     RCB kinds at secp256k1's modulus (b3 = 21) through secp_proj_ops,
     bit-exact at n = 32768 and at ragged n with the edge rows, 64 rows
     against the python-int oracle, timed at n = 32768 as BN254's padd;
  2b. the experiments path (K9-K11): the `main` of each module of
     zksnap_tpu_torch/experiments at the scripts' default sizes
     (exp_vpu_rates: 16 x 2^14 lanes, chain 512, 64 products;
     exp_mul_variants: n = 2^20, chains x4/x18/x40 at 2^18; exp_mul_mxu:
     B = 2^18, all six variants after its 256-value oracle check), with
     the counts of K9-K11 set to 0 just before and read just after; then
     each kernel against its plain version at those shapes (bit-exact,
     bf16dot within BF16_TOL), with the mains' times a call and the
     profiler's device times, K11's rates read again over a chain of
     RATE_CHAIN steps (CUDA events) and the dots' library yardstick; the
     K11 dots again at every width of DOT_CHECK_W (ragged ones among
     them), at DOT_TIMED_W timed with their plain versions and the
     library's chain; K10's six variants against their plain versions at
     B = 2^20, timed;
  3. K=7 parity with the frozen JAX vectors: the port's keygen gives the
     frozen vk digest, the port's verifier accepts the frozen proof, and
     a second keygen with ZKSNAP_TPU_FUSED_REDUCE=1 (every commit through
     K5 and K6) gives the frozen digest again; a third with its fixed
     columns lazy (LazyFixedCoeffs, the threshold forced) gives it too,
     and that key, saved and loaded back, proves the frozen seeded JAX
     proof's bytes;
  3b. K=7 on a virtual mesh (parallel.make_mesh over the card named four
     times; every commit and NTT sharded): keygen(..., mesh=) gives the
     frozen vk digest, a seeded prove(..., mesh=) the frozen seeded JAX
     proof's bytes;
  4. the first path: voter circuit at k=13 (check_plume=False), SRS made
     on the card in a fresh directory, keygen (vk digest against the
     frozen JAX digest), a cold and a warm proof, verification, and a
     tampered proof rejected; the launch counts of K1-K4 over it, each
     required > 0;
  5. one more warm proof under torch.profiler: the device's busy share
     and the kernels that hold it;
  5b. warm_prove's effect on a first proof: two child processes at the
     voter's k=13 on the library already built, one running warm_prove
     (each task timed) before keygen and the first prove, one without;
  6. the second path, with ZKSNAP_TPU_FUSED_REDUCE=1: the voter circuit
     with PLUME on at k=21 (its stats and instances against the frozen
     JAX ones), SRS made on the card under the profiler (K3's Jacobian
     launches and device time by kind), keygen (vk shape against the
     frozen one), a cold and a warm proof, verification, a tampered proof
     rejected, the peak device memory of keygen and of a proof; the
     launch counts of K1-K6 over it, each required > 0; one more warm
     proof under torch.profiler (K3's to K6's kernels in it apart); then
     one 2^21 commit fused and unfused, the same point, and the same
     commit through the fixed-base path enabled up to 2^21
     (configure_fixed_base), the same point, both timed; every proof
     keeps its polys in the int16 at-rest form;
  6b. the same key on a virtual mesh of four (still fused): a first and a
     warm sharded prove (seeded; time and peak), which verifies and
     rejects a flipped byte, with K1-K6's launches counted and each
     required > 0; one 2^21 commit sharded against one card (as points);
     four_step_ntt at 2^21 and 2^23, both ways, against the single-device
     NTT (bit for bit); the seeded sharded proof against a seeded
     single-device proof (byte for byte).  With two or more cards, K1
     and K3 on the last card alone, then the same checks over the first
     2 or 4 cards and scaling_efficiency of the 2^21 commit and the 2^23
     NTT over 1, 2, 4 cards; with one card it prints that they did not
     run;
  6c. poly_device's five functions that the prover does not call
     (coset_extended_evals, coset_interpolate, pow_series_traced,
     batch_eval, rlc): at k=7 on the card against the CPU, at k=18 with
     the extended domain at 2^21 rows bit-exact against their plain path
     on the card (K1's and K2's plain versions), the round trip against
     the zero-padded coefficients, coset_interpolate on a virtual mesh of
     four against one card; then the voter with the Paillier encryption
     check at k=18, PLUME off, through scripts/prove_voter_torch.py's
     main (its stats, instances and vk shape against the frozen JAX
     ones; SRS, keygen, a cold and a warm proof with their peaks and
     launches, verification), a tampered proof rejected, K1-K4 launched
     over its warm prove, and one more warm proof under torch.profiler;
  7. a ceremony-format SRS at k=15 written, read back (curve, pairing
     and Lagrange-sum checks) and compared; a corrupted file refused;
  8. the protocol of scripts/protocol_demo.py at its defaults: two rounds
     of a voter and a state-transition proof at k=13, keys rebound, each
     proof folded by RecursionChain, one final pairing;
  9. the proving service (server.py) in this process: the voter at k=13
     proved, verified, a tampered proof and an unknown circuit refused;
 10. Poseidon's batched path: hash_fixed_batched over 2^16 pairs against
     hash_fixed_native on 64 sampled rows and the frozen vectors,
     build_tree_device over 2^16 leaves against the native MerkleTree's
     levels (computed in 8 worker processes);
 11. the wrapper circuit at scripts/prove_wrapper_tpu.py --toy's shape
     through scripts/prove_wrapper_torch.py's main: K=7 children (their
     vk digests the frozen JAX ones), the shape solve (the frozen JAX
     shape), keygen at k=18, two rounds proved, each verified and a
     flipped byte rejected, rows 12 and up equal to wrapper_native's;
     the decide skipped as the JAX --toy path skips it;
 12. the CLI in child processes: the state-transition circuit at k=15
     through keygen, prove and verify, its vk digest the frozen JAX
     digest, a flipped byte making verify exit 1;
 13. the card's name and power limit, and the kernels' line.

Every path is driven with the launch counts set to 0 just before it and
read just after (the CLI's children excepted: their counts are theirs),
and with them K1's and K2's operand copies; the profiled proves give
PyTorch's direct_copy launches and device ms.

Phase 2's per-call times come from CUDA events over repeated calls and
include the host's launch path; the device time per launch comes from
the profiler.  Each kernel's bound is the larger of the integer
operations that its function needs at the H100's INT32 rate and its
bytes (inputs read once, outputs written once) at 3.35 TB/s; the point
formulas (K3-K8) count their products on the IMAD pipe and their adds on
the ALU pipe apart, and take the slowest of the two pipes and the issue.
The kernels line gives K1-K6 and the NTT (forward 2^21) at the k=21
path's shape, with that path's launches (K3's among them the SRS's
Jacobian dbl and add; the NTT's one a pass), K7, K8 at
n = 2^20 with their own path's (each of their launches is one of K3's
point kernel, which K3's count takes too), and K9 (variant B),
K10 (mxu), K11 (u32mul and i8dot) at the experiments' shapes with the
experiments path's, which count every variant or kind that launches the
one kernel (K9: A's launches are K1's; K11: the chains and the dots
apart); every shape's numbers go to chiprun_out/chip_smoke.json.  A K11
chain's bound is what the main loop of its compiled kernel issues (its
SASS), pipe by pipe; the dots' is their operations at the tensor cores'
int8 or bf16 rate.

Exits non-zero, with no result line, when there is no CUDA device or any
check fails.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
VECTORS = os.path.join(ROOT, "tests", "vectors")
FUSED = "ZKSNAP_TPU_FUSED_REDUCE"

# The bound model.  INT32 rate of an H100 SXM: 132 SMs x 64 INT32 lanes
# (Hopper white paper) at the 1.98 GHz that its 67 TFLOP/s float32 (data
# sheet) implies; HBM3 at 3.35 TB/s (data sheet).  A Montgomery product
# is 8 rounds of 16 32x32->64 multiply-adds (two 32-bit results each) and
# one 32-bit multiply: MUL_OPS operations at the INT32 rate for K1, K9 and
# K10.  The point formulas (K3-K8) count each pipe apart instead
# (formula_bound): a product's MUL_OPS multiply results on the IMAD pipe
# and MUL_ALU operations on the integer ALU pipe (its conditional
# subtract: 8 word subtracts, 8 selects), an add or subtract ADD_OPS on
# the ALU pipe (8 word adds, 8 word subtracts, 8 selects).  Each formula
# is (products, adds) for b3 = 9 (BN254).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
ROW = 64  # bytes of one field element at rest (16 int32 limbs)
MUL_OPS = 8 * (16 * 2 + 1)
MUL_ALU = 16
ADD_OPS = 24
PADD = (12, 27)
PMADD = (11, 21)
PDBL = (8, 13)
JADD = (16, 13)  # add-2007-bl; P == Q adds a JDBL
JDBL = (7, 14)
# K3's kinds by their number (csrc/point.cuh PointKind)
KIND_NAMES = ("add", "madd", "dbl", "padd", "pmadd", "pdbl")


# The experiments' rates: the tensor cores' dense int8 and bf16 rates
# (data sheet).  A step of K11's chains is bounded by what its compiled
# loop issues (chain_loops): each of an SM's four sub-partitions issues
# one warp instruction a clock, 128 lanes an SM; IMAD runs on the FMA
# pipe's heavy half and IADD3, LOP3, SHF on the integer ALU pipe, 64 lanes
# an SM a clock each (the white paper's 64 INT32 lanes); FFMA on both
# halves of the FMA pipe, 128 (its 67 TFLOP/s).  A step takes the most
# clocks that the issue or any one pipe spends on it.
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
SM_CLOCKS_PER_S = 132 * 1.98e9
ISSUE_LANES = 128
PIPES = {"imad": (64, ("IMAD",)),
         "alu": (64, ("IADD3", "LOP3", "SHF", "LEA", "SEL", "PRMT")),
         "fp32": (128, ("FFMA", "FADD", "FMUL"))}
PRODUCT_OPS = 8 * 8 * 2  # the 256-bit product alone: 64 32-bit mul-adds
# bf16dot against its plain version: the products' f32 sums run in another
# order (a relative error up to 32 * 2^-24 of a step), and a bf16 rounding
# of x that this flips moves the next step by 2^-8 of a term 1e-3 smaller
BF16_TOL = 1e-4  # of max |acc|


def bound(ops: float, nbytes: float, rate: float = INT32_OPS_PER_S) -> dict:
    """The least time the card could take: the larger of the two."""
    t_ops = ops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def formula_bound(work, nbytes: float) -> dict:
    """bound() of point formulas, `work` a list of (count, (products,
    adds)): the IMAD pipe, the ALU pipe (64 lanes an SM a clock each) and
    the issue (128) each spend the formulas' instructions at their own
    rate, and the slowest decides."""
    imad = sum(n * m * MUL_OPS for n, (m, _) in work)
    alu = sum(n * (m * MUL_ALU + a * ADD_OPS) for n, (m, a) in work)
    clocks = max(imad / PIPES["imad"][0], alu / PIPES["alu"][0],
                 (imad + alu) / ISSUE_LANES)
    return bound(clocks, nbytes, SM_CLOCKS_PER_S)


def log(*a):
    print(*a, flush=True)


def require(ok, what):
    """A check of the run: raise (and so exit non-zero) when it fails."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def vk_digest(vk) -> str:
    h = hashlib.sha256()
    for name in sorted(vk.commitments):
        pt = vk.commitments[name]
        x, y = (0, 0) if pt.is_identity() else (pt.x, pt.y)
        h.update(name.encode() + x.to_bytes(32, "little")
                 + y.to_bytes(32, "little"))
    return h.hexdigest()


def layout_digest(layout) -> str:
    """sha256 over a keygen layout's structure (either package's): shape,
    column starts, cell map, selectors, constants, table, active rows,
    permutation columns, sigma and deltas."""
    h = hashlib.sha256()
    h.update(repr((layout.k, layout.n, layout.usable, layout.n_advice,
                   layout.n_lookup, layout.lookup_bits,
                   [int(c) for c in layout.col_starts],
                   [tuple(c) for c in layout.perm_columns],
                   [int(d) for d in layout.deltas])).encode())
    for arr in ([layout.cell_map] + list(layout.q_cols)
                + [layout.const_col, layout.sigma]):
        a = np.ascontiguousarray(np.asarray(arr))
        h.update(str(a.dtype).encode() + str(a.shape).encode() + a.tobytes())
    for col in (layout.table_col, layout.active_col):
        h.update(np.asarray(col, dtype=np.int64).tobytes())
    return h.hexdigest()


def build_fixed_circuit():
    """The frozen K=7 circuit of scripts/gen_protocol_vectors.py."""
    from zksnap_tpu_torch.trace import Context

    ctx = Context(lookup_bits=6)
    a = ctx.load_witness(7)
    b = ctx.load_witness(9)
    c = ctx.mul(a, b)
    d = ctx.add(c, ctx.load_constant(5))
    ctx.range_check(ctx.load_witness(37), 6)
    sel = ctx.load_witness(1)
    e = ctx.select(a, b, sel)
    ctx.constrain_equal(e, a)
    ctx.expose_public(d)
    return ctx


def timed(fn):
    """(fn(), its milliseconds from CUDA events): one call, no warm-up."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn over `reps` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time(fn) -> tuple[float, dict]:
    """One call of fn under torch.profiler's CUDA activity: (wall seconds,
    {device activity name: [count, total ms]}); the dict is empty when the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c = by_name.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.elapsed_us() / 1e3
    return wall, by_name


def kernel_device_ms(fn, symbols, reps: int = 20, per_call: bool = False):
    """Device milliseconds of the kernels whose names hold `symbols` (one
    name or a tuple of names), over `reps` calls of fn: per launch, or
    with `per_call` their sum per call of fn; None where not measured."""
    if isinstance(symbols, str):
        symbols = (symbols,)
    _, by_name = device_time(lambda: [fn() for _ in range(reps)])
    hits = [v for k, v in by_name.items() if any(s in k for s in symbols)]
    if not hits:
        return None
    total = sum(v[1] for v in hits)
    return total / (reps if per_call else sum(v[0] for v in hits))


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def max_abs_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        require(g.shape == w.shape, (g.shape, w.shape))
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


# -- phase 2 inputs -----------------------------------------------------------

def field_inputs(F, n: int, rng, dev):
    """n pairs of Montgomery operands, edge values first."""
    p = F.p
    edge = [0, 1, p - 1, p - 2, 1, 0, p - 1]
    edge_b = [p - 1, p - 1, p - 1, 1, 0, 0, 2]
    xs = edge + [rng.randrange(p) for _ in range(n - len(edge))]
    ys = edge_b + [rng.randrange(p) for _ in range(n - len(edge_b))]
    return F.to_mont(xs, dev), F.to_mont(ys, dev)


def point_inputs(curve, F, n: int, rng, dev, jacobian: bool):
    """(P, Q_general, Q_affine) coordinate lists of n points each.

    P and Q_general carry random non-trivial z (projective: (lx, ly, l);
    Jacobian: (l^2 x, l^3 y, l)); Q_affine has z = 1 or, for identities,
    the stream encoding (0, 0, 0).  The first rows are edge cases:
    identity operands, P == Q, P == -Q."""
    from zksnap_tpu_torch.curves.native import AffinePoint

    q = curve.p
    g = AffinePoint.generator(curve)
    pool = [rng.randrange(1, curve.n) * g for _ in range(48)]
    ident = AffinePoint.identity(curve)

    def enc(pt, lam):
        if pt.is_identity():
            return ((lam * lam % q, lam * lam * lam % q, 0) if jacobian
                    else (0, lam, 0))
        if jacobian:
            return (lam * lam * pt.x % q, lam * lam * lam * pt.y % q, lam)
        return (lam * pt.x % q, lam * pt.y % q, lam)

    def aff(pt):
        return (0, 0, 0) if pt.is_identity() else (pt.x, pt.y, 1)

    ps, qs = [], []
    a, b = pool[0], pool[1]
    edge = [(ident, a), (a, ident), (ident, ident), (a, a), (b, -b),
            (a, b), (b, b), (a, -a)]
    for pa, qa in edge:
        ps.append(pa)
        qs.append(qa)
    while len(ps) < n:
        ps.append(pool[rng.randrange(len(pool))])
        qs.append(ident if rng.random() < 0.05
                  else pool[rng.randrange(len(pool))])
    P = [enc(pt, rng.randrange(1, q)) for pt in ps]
    Qg = [enc(pt, rng.randrange(1, q)) for pt in qs]
    Qa = [aff(pt) for pt in qs]

    def tensors(rows):
        return tuple(F.to_mont([r[i] for r in rows], dev) for i in range(3))

    return tensors(P), tensors(Qg), tensors(Qa)


def shape_result(results, name: str, tag: str, **r) -> dict:
    """Record kernel `name`'s check and times at the shape `tag`."""
    results.setdefault(name + "_shapes", {})[tag] = r
    return r


def time_field_kernels(results, tag: str, F, a, b, errs, k2=None):
    """K1 on a, b and K2 (add) on k2 (default a, b), timed: call, device
    and plain times.  The bound's bytes count each operand's own rows (a
    broadcast operand's once) and the n rows written."""
    from zksnap_tpu_torch.fields import pallas_mont as pm

    c, d = k2 if k2 is not None else (a, b)
    for name, (x, y), fn, plain, ops, sym in (
            ("K1", (a, b), lambda: pm.mont_mul(a, b, F.p),
             lambda: pm.mont_mul_plain(a, b, F.p), MUL_OPS, "mont_mul_kernel"),
            ("K2", (c, d), lambda: pm.mont_addsub(c, d, F.p, "add"),
             lambda: pm.mont_addsub_plain(c, d, F.p, "add"), ADD_OPS,
             "mont_addsub_kernel")):
        n = torch.broadcast_shapes(x.shape, y.shape)[:-1].numel()
        r = shape_result(
            results, name, tag, n=n, max_abs_err=errs[name],
            ms=cuda_ms(fn, 200 if n <= 8192 else 20),
            plain_ms=cuda_ms(plain, 5 if n <= 8192 else 1),
            device_ms=kernel_device_ms(fn, sym),
            **bound(n * ops, (x.numel() + y.numel()) // 16 * ROW + n * ROW))
        log(f"{name} bit-exact ({tag}, n={n}): kernel {r['ms']:.4f} ms a call "
            f"({fmt_ms(r['device_ms'])} on the device), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4g} ms")


# -- K1 and K2: the field kernels ----------------------------------------------

FIELD_KERNELS = ("mont_mul_kernel", "mont_addsub_kernel")
# n of K1's and K2's ragged check: one element, less than a warp, each side
# of the k=13 path's 8192 and one past the k=21 path's 2^21
FIELD_RAGGED_N = (1, 31, 8191, 8192, (1 << 21) + 1)
# stages of the plain NTT (`_ntt_plain`, the CPU's path) whose strided and
# broadcast views K1 and K2 read in place: the first (a one-row twiddle),
# a middle one and the last of 2^21
STAGE_VIEWS = (0, 10, 20)

# K3's projective kinds' and K4-K6's ptxas lines, (registers, stack frame
# bytes), as the builds since K1's redesign gave them: the Jacobian
# formulas inlined beside them for K3's Jacobian kinds (held to no frame
# and no local memory by require_inlined instead) must leave them as they
# were
K3_K6_PTXAS = {
    "_Z12point_kernelILi3ELi2EEvPKiS1_S1_S1_S1_S1_PiS2_S2_xi7Modulus": (113, 0),
    "_Z12point_kernelILi4ELi2EEvPKiS1_S1_S1_S1_S1_PiS2_S2_xi7Modulus": (140, 0),
    "_Z12point_kernelILi5ELi2EEvPKiS1_S1_S1_S1_S1_PiS2_S2_xi7Modulus": (80, 0),
    "_Z18bucket_scan_kernelILb0EEvPKhPKiS3_S3_PiS4_S4_xxi7Modulus": (198, 744),
    "_Z18bucket_scan_kernelILb1EEvPKhPKiS3_S3_PiS4_S4_xxi7Modulus": (252, 0),
    "_Z25suffix_chunk_total_kernelILb0EEvPKiS1_S1_PiS2_S2_xii7Modulus": (228, 840),
    "_Z25suffix_chunk_total_kernelILb1EEvPKiS1_S1_PiS2_S2_xii7Modulus": (255, 0),
    "_Z19suffix_carry_kernelILb0EEvPKiS1_S1_PiS2_S2_S2_S2_S2_ii7Modulus": (152, 1128),
    "_Z19suffix_carry_kernelILb1EEvPKiS1_S1_PiS2_S2_S2_S2_S2_ii7Modulus": (240, 0),
    "_Z19suffix_chunk_kernelILb0ELb0EEvPKiS1_S1_S1_S1_S1_S1_S1_S1_iPiS2_S2_S2_S2_S2_xii7Modulus": (198, 936),
    "_Z19suffix_chunk_kernelILb0ELb1EEvPKiS1_S1_S1_S1_S1_S1_S1_S1_iPiS2_S2_S2_S2_S2_xii7Modulus": (186, 1032),
    "_Z19suffix_chunk_kernelILb1ELb0EEvPKiS1_S1_S1_S1_S1_S1_S1_S1_iPiS2_S2_S2_S2_S2_xii7Modulus": (244, 0),
    "_Z19suffix_chunk_kernelILb1ELb1EEvPKiS1_S1_S1_S1_S1_S1_S1_S1_iPiS2_S2_S2_S2_S2_xii7Modulus": (252, 0),
    "_Z18ladder_tree_kernelILb0ELi1EEvPKiS1_S1_PiS2_S2_iii7Modulus": (132, 840),
    "_Z18ladder_tree_kernelILb1ELi4EEvPKiS1_S1_PiS2_S2_iii7Modulus": (112, 0),
}


def field_kernel_report(ptxas: dict, sass: dict) -> dict:
    """{kernel: registers, stack frame, CALLs, LDL/STL and instructions}
    for K1's and K2's kernels (ptxas_entries, kernel_sass: its own code
    and every subroutine)."""
    out = {}
    for name, v in sass.items():
        if not any(f in name for f in FIELD_KERNELS):
            continue
        subs = v["subroutines"].values()
        out[name] = {"registers": ptxas.get(name, {}).get("registers"),
                     "stack_bytes": ptxas.get(name, {}).get("stack_bytes"),
                     **{key: sum(s[key] for s in subs)
                        for key in ("CALL", "LDL/STL", "IMAD*", "all")}}
    return out


def require_field_kernels(report: dict, ptxas: dict):
    """K1's kernel inlined (a 0-byte stack frame, no CALL, no local
    memory) and K3-K6's ptxas lines those of K3_K6_PTXAS."""
    muls = {k: r for k, r in report.items() if "mont_mul_kernel" in k}
    require(len(muls) == 1 and all(
        r["stack_bytes"] == 0 and r["CALL"] == 0 and r["LDL/STL"] == 0
        for r in muls.values()), ("K1 not inlined", muls))
    got = {k: (ptxas.get(k, {}).get("registers"),
               ptxas.get(k, {}).get("stack_bytes")) for k in K3_K6_PTXAS}
    require(got == K3_K6_PTXAS, ("K3-K6 ptxas lines changed",
                                 {k: (v, K3_K6_PTXAS[k]) for k, v in got.items()
                                  if v != K3_K6_PTXAS[k]}))


def ntt_stage_operands(x, k: int, s: int, twiddles):
    """(u, the odd rows, w[None]) of stage s of `_ntt_plain` over x
    [..., 2^k, 16]: K2's strided `xb[..., 0, :, :]`, K1's strided
    `xb[..., 1, :, :]` and broadcast `w[None]`."""
    n, m = 1 << k, 1 << s
    xb = x.reshape(*x.shape[:-2], n >> (s + 1), 2, m, 16)
    w = twiddles[:: (n // 2) // m] if m > 1 else twiddles[:1]
    return xb[..., 0, :, :], xb[..., 1, :, :], w[None, :, :]


def host_ms(fn, reps: int) -> float:
    """Host milliseconds a call of fn over `reps` calls (perf_counter),
    after 100 calls of warm-up; the device is synchronised outside the
    timed loop."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def field_host_split(a, b, p: int, mode, reps: int) -> dict:
    """{piece: host ms a call} of one K1 (mode None) or K2 (mode "add" or
    "sub") call on a, b: the whole call and each piece of it alone (the
    two operands' descriptors, `torch.empty`, `kernels.on_device`'s
    enter and exit, the launch geometry, the ctypes call with its
    arguments ready)."""
    from zksnap_tpu_torch import kernels
    from zksnap_tpu_torch.fields import pallas_mont as pm

    shape = torch.broadcast_shapes(a.shape, b.shape)
    n = shape[:-1].numel()
    wrapper = pm.mont_mul if mode is None else pm.mont_addsub
    out = torch.empty((n, 16), dtype=torch.int32, device=a.device)
    ra, _ = pm.operand_rows(a, shape, n, wrapper)
    rb, _ = pm.operand_rows(b, shape, n, wrapper)
    sms = kernels.sm_count(a.device.index)
    threads, blocks = pm.launch_geometry(n, sms)
    lib, mod = kernels.library(), kernels.mod_ptr(p)
    with kernels.on_device(a, b) as stream:
        pass
    if mode is None:
        call = lambda: pm.mont_mul(a, b, p)  # noqa: E731
        launch = lambda: lib.zk_mont_mul(  # noqa: E731
            *ra, *rb, out.data_ptr(), n, threads, blocks, mod, stream)
    else:
        m = 0 if mode == "add" else 1
        call = lambda: pm.mont_addsub(a, b, p, mode)  # noqa: E731
        launch = lambda: lib.zk_mont_addsub(  # noqa: E731
            *ra, *rb, out.data_ptr(), n, m, threads, blocks, mod, stream)

    def on_device():
        with kernels.on_device(a, b):
            pass

    return {
        "call": host_ms(call, reps),
        "operand_rows x2": host_ms(lambda: (
            pm.operand_rows(a, shape, n, wrapper),
            pm.operand_rows(b, shape, n, wrapper)), reps),
        "torch.empty": host_ms(lambda: torch.empty(
            (n, 16), dtype=torch.int32, device=a.device), reps),
        "on_device": host_ms(on_device, reps),
        "launch_geometry": host_ms(lambda: pm.launch_geometry(
            n, kernels.sm_count(a.device.index)), reps),
        "ctypes call": host_ms(launch, reps),
    }


def copy_counts() -> dict:
    from zksnap_tpu_torch.fields import pallas_mont as pm

    return {"K1": pm.mont_mul.copies, "K2": pm.mont_addsub.copies}


def check_field_kernels(dev, rng, results):
    """K1 and K2 (add and sub) bit-exact against their plain versions:
    every field, edge values first and last, at each n of FIELD_RAGGED_N
    and with a one-element operand on either side; on the strided and
    broadcast views of STAGE_VIEWS' stages of the plain NTT at 2^21 and at
    2^23 (a leading batch of 4 x 2^21), none of them copied; and three
    layouts the kernels cannot read in place (limbs not adjacent, rows
    not 16-byte aligned, three levels of strides), each copied once and
    counted.  Then the times at stage 10's views and the host split of one
    call at n = 8192."""
    from zksnap_tpu_torch.fields import (bn254_fq, bn254_fr, secp256k1_fp,
                                         secp256k1_fq)
    from zksnap_tpu_torch.fields import pallas_mont as pm
    from zksnap_tpu_torch.poly.domain import domain

    gen = torch.Generator().manual_seed(rng.randrange(1 << 31))
    errs = {"K1": 0, "K2": 0}

    def held(a, b, p, what):
        got = [pm.mont_mul(a, b, p)] + [pm.mont_addsub(a, b, p, mode)
                                        for mode in ("add", "sub")]
        want = [pm.mont_mul_plain(a, b, p)] + [
            pm.mont_addsub_plain(a, b, p, mode) for mode in ("add", "sub")]
        e1, e2 = max_abs_err(got[:1], want[:1]), max_abs_err(got[1:], want[1:])
        require(e1 == 0 and e2 == 0, ("K1, K2", what, e1, e2))
        return got[0]

    copies0 = copy_counts()
    for F in (bn254_fr(), bn254_fq(), secp256k1_fp(), secp256k1_fq()):
        a, b = field_inputs(F, 8192, rng, dev)
        for n in FIELD_RAGGED_N:
            idx = torch.randint(0, 8192, (n,), generator=gen)
            edge = torch.arange(min(7, n))
            idx[:len(edge)] = edge
            idx[n - len(edge):] = edge
            idx = idx.to(dev)
            held(a[idx], b[idx], F.p, (F.name, n))
        held(a, b[3], F.p, (F.name, "one-element b"))
        held(b[5], a, F.p, (F.name, "one-element a"))
    F = bn254_fr()
    for tag, lead, k in (("2^21", (), 21), ("2^23", (4,), 21)):
        x = random_canonical((1 << k) * (lead[0] if lead else 1),
                             20261022 + len(lead), dev).reshape(
                                 *lead, 1 << k, 16)
        tw = domain(k).twiddles(dev)
        for s in STAGE_VIEWS:
            u, xa, wb = ntt_stage_operands(x, k, s, tw)
            t = held(xa, wb, F.p, ("NTT view", tag, s))
            held(u, t, F.p, ("NTT view, K2's", tag, s))
        del x
    require(copy_counts() == copies0, ("field operands copied",
                                       copies0, copy_counts()))

    a, b = field_inputs(F, 8192, rng, dev)
    flat = torch.zeros(8192 * 16 + 2, dtype=torch.int32, device=dev)
    misaligned = flat[2:].view(8192, 16)
    misaligned.copy_(a)
    cube = random_canonical(4 * 8 * 2 * 128, 20261025, dev).reshape(
        4, 8, 2, 128, 16)
    for what, v, w in (("limbs not adjacent", a.t().contiguous().t(), b),
                       ("not 16-byte aligned", misaligned, b),
                       ("three levels", cube[:, ::3, 1],
                        b[:4 * 3 * 128].reshape(4, 3, 128, 16))):
        before = copy_counts()
        held(v, w, F.p, ("refused layout", what))
        require(copy_counts() == {k: c + (1 if k == "K1" else 2)
                                  for k, c in before.items()},
                ("refused layout not copied once a call", what, before,
                 copy_counts()))
    results["field_checks"] = {
        "ragged_n": list(FIELD_RAGGED_N), "ntt_views": ["2^21", "2^23"],
        "ntt_view_stages": list(STAGE_VIEWS), "refused_layouts": 3,
        "max_abs_err": 0}
    log(f"K1, K2 (add, sub) bit-exact: 4 fields at n = {list(FIELD_RAGGED_N)}"
        f" and one-element operands; stages {list(STAGE_VIEWS)}' views of the"
        " plain NTT at 2^21 and 2^23 (4 x 2^21) with no copy; three refused "
        "layouts, each copied once and counted")

    x = random_canonical(1 << 21, 20261026, dev)
    u, xa, wb = ntt_stage_operands(x, 21, 10, domain(21).twiddles(dev))
    t = pm.mont_mul(xa, wb, F.p)
    time_field_kernels(results, "stage_view_2^21_s10", F, xa, wb, errs,
                       k2=(u, t))
    a, b = field_inputs(F, 8192, rng, dev)
    results["host_split_ms"] = {
        "K1 n=8192": field_host_split(a, b, F.p, None, 2000),
        "K2 add n=8192": field_host_split(a, b, F.p, "add", 2000)}
    log("host ms of one call at n = 8192: " + "; ".join(
        f"{k}: " + ", ".join(f"{p} {v:.4f}" for p, v in r.items())
        for k, r in results["host_split_ms"].items()))


# -- the NTT kernels (csrc/ntt.cu) ----------------------------------------------

NTT_KERNEL = "ntt_pass_kernel"
# the single-card transforms of the main paths: the k=21 voter's domain
# (and the Paillier voter's 8x extended one), the Paillier voter's 2^18 and
# the k=13 voter's 2^13; and the local transforms of a mesh of four cards
# at k=21 and at 2^23: over t2 ([2^19], [2^21]), then [chunk, 4] over the
# shards
NTT_MAIN_K = (21, 18, 13)
NTT_MESH = ((19, ()), (21, ()), (2, (1 << 17,)), (2, (1 << 19,)))


def ntt_kernel_report(ptxas: dict) -> dict:
    """The ptxas lines of the NTT kernels' instantiations."""
    return {k: v for k, v in ptxas.items() if NTT_KERNEL in k}


def require_ntt_kernels(report: dict):
    """Every NTT kernel built without a stack frame or spills."""
    require(report and all(
        v.get("stack_bytes") == 0 and v.get("spill_stores") == 0
        and v.get("spill_loads") == 0 for v in report.values()),
        ("NTT kernels with a stack frame or spills", report))


def check_ntt_kernel(dev, results):
    """The NTT kernels (`poly/ntt.py` `ntt_kernel`) bit-exact against their
    plain version (`_ntt_plain`: the bit-reversal gather and K1/K2 stages
    on the card) at the main paths' shapes.  At each k of NTT_MAIN_K the
    prover's own three calls, each one NTT launch a pass and, once the
    twiddle tables exist, no K1 or K2 launch: coset_evals (int16 at-rest coefficients, the coset's powers as
    the kernels' `pre`), evals_to_coeffs (the inverse, n^-1 as `post`) and
    coeffs_to_evals (forward, int32).  NTT_MESH's local transforms both
    ways on every card of the machine (the kernels' shared-memory opt-in
    is each card's own).  A contiguous view whose rows are not 16-byte
    aligned refused with a ValueError.  Then each k's forward transform
    timed against its plain version, with its device time and its bound."""
    from zksnap_tpu_torch.fields import bn254_fr
    from zksnap_tpu_torch.fields.pallas_mont import mont_addsub, mont_mul
    from zksnap_tpu_torch.poly.domain import domain
    from zksnap_tpu_torch.poly.ntt import _ntt_plain, ntt_kernel, ntt_plan
    from zksnap_tpu_torch.prover import poly_device as pd

    F = bn254_fr()
    cases = []

    def same(got, want, what):
        require(torch.equal(got, want), ("NTT kernels differ", what))
        cases.append(what)

    def counts():
        return mont_mul.launches, mont_addsub.launches, ntt_kernel.launches

    for k in NTT_MAIN_K:
        n, d = 1 << k, domain(k)
        x = random_canonical(n, 20261030 + k, dev)
        s_pows = pd.pow_series_uncached(F.generator, n, dev)

        def calls():
            return [pd.coset_evals(pd.pack_poly(x), s_pows, k),
                    pd.evals_to_coeffs(x, k), pd.coeffs_to_evals(x, k)]

        calls()  # the domain's twiddles and the kernels' tables, built once
        torch.cuda.synchronize()
        before = counts()
        got = calls()
        torch.cuda.synchronize()
        after = counts()
        passes = len(ntt_plan(k, 1).widths)
        require(after[:2] == before[:2]
                and after[2] - before[2] == 3 * passes,
                ("the prover's NTT calls launch other kernels", k, before,
                 after))
        tw, tw_inv = d.twiddles(dev), d.twiddles_inv(dev)
        want = [_ntt_plain(F.mul(x, s_pows), tw, k, F),
                F.mul(_ntt_plain(x, tw_inv, k, F),
                      F.const_t(d.n_inv, dev)[None, :]),
                _ntt_plain(x, tw, k, F)]
        for what, g, w in zip(("coset_evals", "evals_to_coeffs",
                               "coeffs_to_evals"), got, want):
            same(g, w, (what, f"2^{k}"))
        del x, s_pows, got, want
    for i in range(torch.cuda.device_count()):
        card = torch.device("cuda", i)
        for k, lead in NTT_MESH:
            d = domain(k)
            x = random_canonical((lead[0] if lead else 1) << k,
                                 20261050 + k, card).reshape(*lead, 1 << k, 16)
            for inverse in (False, True):
                tw = d.twiddles_inv(card) if inverse else d.twiddles(card)
                same(ntt_kernel(x, tw, k, F), _ntt_plain(x, tw, k, F),
                     ("mesh", str(card), k, list(lead), inverse))
            del x
    flat = torch.zeros((1 << 13) * 16 + 2, dtype=torch.int32, device=dev)
    try:
        ntt_kernel(flat[2:].view(1 << 13, 16), domain(13).twiddles(dev), 13,
                   F)
        refused = False
    except ValueError:
        refused = True
    require(refused, "an NTT operand not 16-byte aligned was launched")

    for k in NTT_MAIN_K:
        n = 1 << k
        x = random_canonical(n, 20261040 + k, dev)
        tw = domain(k).twiddles(dev)
        passes = len(ntt_plan(k, 1).widths)

        def fn(x=x, tw=tw, k=k):
            return ntt_kernel(x, tw, k, F)

        r = shape_result(
            results, "NTT", f"2^{k}", n=n, passes=passes, max_abs_err=0,
            ms=cuda_ms(fn, 50 if k <= 13 else 20),
            plain_ms=cuda_ms(lambda: _ntt_plain(x, tw, k, F), 2),
            device_ms=kernel_device_ms(fn, NTT_KERNEL, per_call=True),
            # k n/2 products; the input read and the output written as
            # ROW a row, each pass boundary 32 bytes a row written and read
            **bound(k * (n >> 1) * MUL_OPS, n * (2 * ROW + 64 * (passes - 1))))
        log(f"NTT forward 2^{k} ({passes} passes): kernel {r['ms']:.4f} ms a "
            f"call ({fmt_ms(r['device_ms'])} on the device), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4g} ms "
            f"({r['bound_by']})")
    results["ntt_checks"] = {"cases": len(cases), "max_abs_err": 0,
                             "cards": torch.cuda.device_count()}
    log(f"NTT kernels bit-exact in {len(cases)} cases: coset_evals, "
        f"evals_to_coeffs and coeffs_to_evals at 2^{list(NTT_MAIN_K)} with "
        "no K1 or K2 launch; the mesh's local transforms both ways on "
        f"{torch.cuda.device_count()} card(s); a misaligned operand refused")


def check_bucket_scan(results, tag: str, Qa, ids, M: int):
    """K4 over the sorted stream Qa with bucket ids `ids` (host), M lanes:
    bit-exact against its plain version in the RCB branch, timed; at a
    small shape ("k13") the Jacobian branch (b3 = 0) too, untimed."""
    from zksnap_tpu_torch.curves import fused
    from zksnap_tpu_torch.curves.native import BN254_G1
    from zksnap_tpu_torch.fields import bn254_fq

    p, b3 = bn254_fq().p, 3 * BN254_G1.b
    pairs = ids.shape[0]
    K = pairs // M
    flags = torch.cat([torch.ones(1, dtype=torch.bool),
                       ids[1:] != ids[:-1]]).to(Qa[0].device)
    got = fused.bucket_scan(Qa, flags, M, K, p, b3)
    want, plain_ms = timed(lambda: fused.bucket_scan_plain(Qa, flags, M, K,
                                                           p, b3))
    err = max_abs_err(got, want)
    require(err == 0, ("K4", tag, err))
    del got, want
    jac_err = None
    if tag == "k13":
        jac_err = max_abs_err(fused.bucket_scan(Qa, flags, M, K, p, 0),
                              fused.bucket_scan_plain(Qa, flags, M, K, p, 0))
        require(jac_err == 0, ("K4 Jacobian", tag, jac_err))
    r = shape_result(
        results, "K4", tag, M=M, K=K, max_abs_err=max(err, jac_err or 0),
        jacobian_max_abs_err=jac_err, plain_ms=plain_ms,
        ms=cuda_ms(lambda: fused.bucket_scan(Qa, flags, M, K, p, b3), 20),
        device_ms=kernel_device_ms(
            lambda: fused.bucket_scan(Qa, flags, M, K, p, b3),
            "bucket_scan_kernel"),
        # the adds this stream needs: every position but a segment's first
        **formula_bound([(pairs - int(flags.sum()), PMADD)],
                        pairs * (3 * ROW + 1) + pairs * 3 * ROW))
    log(f"K4 bucket scan bit-exact ({tag}, M={M} lanes x K={K} steps"
        + (", Jacobian too" if jac_err is not None else "")
        + f"): kernel {r['ms']:.4f} ms a call ({fmt_ms(r['device_ms'])} on "
        f"the device), plain {r['plain_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4g} ms")


# n of K3's ragged check: one point, less than a warp, and each side of
# the k=13 path's 8192 and the k=21 path's 32768
RAGGED_N = (1, 31, 8191, 8192, 32769, 32768)


def check_point_ragged(dev, rng, results, ops=None):
    """K3's kinds bit-exact against their plain versions at each n of
    RAGGED_N: rows drawn from 8192 seeded points, the edge rows
    (identities, P == Q, P == -P) first and last.  With no `ops`, BN254's
    six kinds (projective for padd, pmadd, pdbl, Jacobian for add, madd,
    dbl); with RCB `ops`, its curve's padd, pmadd and pdbl at its p and
    b3.  Returns the projective inputs (P, Q_general, Q_affine)."""
    from zksnap_tpu_torch.curves import fused
    from zksnap_tpu_torch.curves.proj import bn254_proj_ops

    proj = ops or bn254_proj_ops()
    F, b3 = proj.F, proj.b3
    P, Qg, Qa = point_inputs(proj.params, F, 8192, rng, dev, False)
    cases = [("padd", P + Qg, b3), ("pmadd", P + Qa, b3), ("pdbl", P, b3)]
    if ops is None:
        PJ, QgJ, QaJ = point_inputs(proj.params, F, 8192, rng, dev, True)
        cases += [("add", PJ + QgJ, 0), ("madd", PJ + QaJ, 0),
                  ("dbl", PJ, 0)]
    gen = torch.Generator().manual_seed(rng.randrange(1 << 31))
    for n in RAGGED_N:
        idx = torch.randint(0, 8192, (n,), generator=gen)
        edge = torch.arange(min(8, n))
        idx[:len(edge)] = edge
        idx[n - len(edge):] = edge
        idx = idx.to(dev)
        for kind, ins, kb3 in cases:
            args = [a[idx] for a in ins]
            err = max_abs_err(fused.point(kind, args, F.p, kb3),
                              fused.point_plain(kind, args, F.p, kb3))
            require(err == 0, ("K3 ragged", proj.params.name, kind, n, err))
    tag = "ragged" if ops is None else f"{proj.params.name}_ragged"
    shape_result(results, "K3", tag, n=list(RAGGED_N), max_abs_err=0)
    log(f"K3's {len(cases)} kinds over {proj.params.name} (b3 = {b3}) "
        f"bit-exact at ragged n = {list(RAGGED_N)}")
    return P, Qg, Qa


# (formula work, coordinate rows moved) of K3's projective kinds
POINT_WORK = {"padd": (PADD, 9), "pmadd": (PMADD, 9), "pdbl": (PDBL, 6)}


def time_point(results, tag: str, kind: str, ins, p: int, b3: int,
               launch=None) -> dict:
    """K3's projective `kind` on the n rows of `ins` (checked already),
    timed through `launch` (default the wrapper at p, b3): call, device
    and plain times, against its bound."""
    from zksnap_tpu_torch.curves import fused

    launch = launch or (lambda: fused.point(kind, ins, p, b3))
    n = ins[0].shape[0]
    work, rows = POINT_WORK[kind]
    r = shape_result(
        results, "K3", tag, n=n, max_abs_err=0, ms=cuda_ms(launch, 50),
        plain_ms=cuda_ms(lambda: fused.point_plain(kind, ins, p, b3), 2),
        device_ms=kernel_device_ms(launch, "point_kernel"),
        **formula_bound([(n, work)], n * rows * ROW))
    log(f"K3 {kind:5s} bit-exact ({tag}, n={n}): kernel {r['ms']:.4f} ms a "
        f"call ({fmt_ms(r['device_ms'])} on the device), plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4g} ms")
    return r


SECP_N = 32768  # the k=21 path's padd width
SECP_SEED = 20261019  # the secp check's own inputs: the other phases' stay


def check_secp_rcb(dev, results):
    """K3's RCB kinds at secp256k1's modulus (p = 2^256 - 2^32 - 977, no
    headroom under 2^256; b3 = 21) through `secp_proj_ops`: bit-exact
    against their plain versions at each n of RAGGED_N (SECP_N among
    them) with the edge rows first and last; 64 rows through the ops'
    group law against the python-int oracle as affine points; each kind
    timed at SECP_N through the group law (phase2_k21 times BN254's padd
    at that n)."""
    from zksnap_tpu_torch.curves import fused
    from zksnap_tpu_torch.curves.jacobian import JacPoint
    from zksnap_tpu_torch.curves.proj import secp_proj_ops

    ops = secp_proj_ops()
    require(ops.b3 == 21, ("secp256k1's b3", ops.b3))
    rng = random.Random(SECP_SEED)
    before = fused.point.launches
    P, Qg, Qa = check_point_ragged(dev, rng, results, ops)
    group_law = {"padd": ops.add, "pmadd": ops.madd, "pdbl": ops.double}

    def entry(kind, args):
        """The kind through the ops' group law (a launch of K3)."""
        r = group_law[kind](*(JacPoint(*args[i:i + 3])
                              for i in range(0, len(args), 3)))
        return r.x, r.y, r.z

    cases = {"padd": P + Qg, "pmadd": P + Qa, "pdbl": P}
    m = 64
    aff_p = ops.to_affine_host(JacPoint(*(a[:m] for a in P)))
    aff_q = ops.to_affine_host(JacPoint(*(a[:m] for a in Qg)))
    gen = torch.Generator().manual_seed(rng.randrange(1 << 31))
    idx = torch.randint(0, P[0].shape[0], (SECP_N,), generator=gen).to(dev)
    for kind, ins in cases.items():
        got = entry(kind, [a[:m] for a in ins])
        oracle = [a + a for a in aff_p] if kind == "pdbl" else [
            a + b for a, b in zip(aff_p, aff_q)]
        require(ops.to_affine_host(JacPoint(*got)) == oracle,
                ("K3 secp256k1 against the oracle", kind))
        args = [a[idx] for a in ins]
        err = max_abs_err(entry(kind, args),
                          fused.point_plain(kind, args, ops.F.p, ops.b3))
        require(err == 0, ("K3 secp256k1", kind, SECP_N, err))
        time_point(results, f"secp_{kind}", kind, args, ops.F.p, ops.b3,
                   launch=lambda: entry(kind, args))
    require(fused.point.launches > before,
            "secp_proj_ops launched no K3 kernel")


def phase2(dev, rng, results):
    """K1-K4 at the k=13 path's shapes: n = 8192 field elements and
    points, the fixed-base bucket stream of 16 * 8192 pairs."""
    from zksnap_tpu_torch.curves import fused
    from zksnap_tpu_torch.curves.native import BN254_G1, SECP256K1
    from zksnap_tpu_torch.fields import bn254_fq, bn254_fr, secp256k1_fp
    from zksnap_tpu_torch.msm.pippenger import CUDA_LANES

    n = 8192

    # K1 / K2: every field, ragged n, NTT views, refused layouts
    check_field_kernels(dev, rng, results)
    check_ntt_kernel(dev, results)
    F = bn254_fr()
    a, b = field_inputs(F, n, rng, dev)
    time_field_kernels(results, "k13", F, a, b, {"K1": 0, "K2": 0})

    # K3: six kinds; projective kinds on BN254, Jacobian on BN254 and secp
    k3_err = 0
    k3_ms = {}
    cases = [(BN254_G1, bn254_fq(), False), (BN254_G1, bn254_fq(), True),
             (SECP256K1, secp256k1_fp(), True)]
    for curve, Fq, jac in cases:
        P, Qg, Qa = point_inputs(curve, Fq, n, rng, dev, jac)
        b3 = 0 if jac else 3 * curve.b
        kinds = (("add", P + Qg), ("madd", P + Qa), ("dbl", P)) if jac else (
            ("padd", P + Qg), ("pmadd", P + Qa), ("pdbl", P))
        for kind, ins in kinds:
            got = fused.point(kind, list(ins), Fq.p, b3)
            want = fused.point_plain(kind, list(ins), Fq.p, b3)
            err = max_abs_err(got, want)
            require(err == 0, (curve.name, kind, err))
            k3_err = max(k3_err, err)
            if curve is BN254_G1:
                k3_ms[kind] = (
                    cuda_ms(lambda: fused.point(kind, list(ins), Fq.p, b3), 50),
                    cuda_ms(lambda: fused.point_plain(kind, list(ins), Fq.p,
                                                      b3), 2),
                    kernel_device_ms(
                        lambda: fused.point(kind, list(ins), Fq.p, b3),
                        "point_kernel"))
    for kind, (ms, pms, dms) in k3_ms.items():
        log(f"K3 {kind:5s} bit-exact (k13, n={n}): kernel {ms:.4f} ms a call "
            f"({fmt_ms(dms)} on the device), plain {pms:.4f} ms")
    shape_result(results, "K3", "k13", n=n, max_abs_err=k3_err,
                 ms=k3_ms["padd"][0], plain_ms=k3_ms["padd"][1],
                 device_ms=k3_ms["padd"][2],
                 **formula_bound([(n, PADD)], n * 9 * ROW))
    results["K3_kinds"] = {kind: {"ms": ms, "plain_ms": pms, "device_ms": dms}
                           for kind, (ms, pms, dms) in k3_ms.items()}

    check_point_ragged(dev, rng, results)

    # K4: the fixed-base stream at k=13: 16 windows * 8192 pairs into
    # 2^15 signed buckets, sorted, identities encoded (0, 0, 0)
    pairs, buckets = 16 * n, 1 << 15
    _, _, Qa = point_inputs(BN254_G1, bn254_fq(), pairs, rng, dev, False)
    ids = torch.sort(torch.randint(0, buckets + 1, (pairs,),
                                   generator=torch.Generator().manual_seed(7)))[0]
    check_bucket_scan(results, "k13", Qa, ids, CUDA_LANES)


def phase2_k21(dev, rng, results):
    """K1-K4 at the k=21 path's shapes: field ops over one 2^21-row poly,
    padd over the lane-carry scan's 32768 lanes (the commonest point
    launch of a 2^21 commit), and one variable-base pass: 2 windows of
    2^21 signed-digit pairs into 2 * 2^15 buckets and the digit-0 bucket,
    sorted, M = 32768 lanes x K = 128 steps.  Rows are drawn from 8192
    seeded rows (edge values, identities, P beside -P among them)."""
    from zksnap_tpu_torch.curves import fused
    from zksnap_tpu_torch.curves.native import BN254_G1
    from zksnap_tpu_torch.fields import bn254_fq, bn254_fr
    from zksnap_tpu_torch.fields import pallas_mont as pm
    from zksnap_tpu_torch.msm.pippenger import CUDA_LANES

    gen = torch.Generator().manual_seed(rng.randrange(1 << 31))

    def draw(arrays, n):
        idx = torch.randint(0, arrays[0].shape[0], (n,), generator=gen)
        idx = idx.to(arrays[0].device)
        return tuple(a[idx] for a in arrays)

    n = 1 << 21
    F = bn254_fr()
    a, b = draw(field_inputs(F, 8192, rng, dev), n)
    errs = {"K1": max_abs_err([pm.mont_mul(a, b, F.p)],
                              [pm.mont_mul_plain(a, b, F.p)]),
            "K2": max(max_abs_err([pm.mont_addsub(a, b, F.p, mode)],
                                  [pm.mont_addsub_plain(a, b, F.p, mode)])
                      for mode in ("add", "sub"))}
    require(errs == {"K1": 0, "K2": 0}, ("k21", errs))
    time_field_kernels(results, "k21", F, a, b, errs)
    del a, b

    Fq = bn254_fq()
    b3 = 3 * BN254_G1.b
    m = CUDA_LANES
    P, Qg, Qa = point_inputs(BN254_G1, Fq, 8192, rng, dev, False)
    ins = list(draw(P + Qg, m))
    err = max_abs_err(fused.point("padd", ins, Fq.p, b3),
                      fused.point_plain("padd", ins, Fq.p, b3))
    require(err == 0, ("K3 padd", "k21", err))
    time_point(results, "k21", "padd", ins, Fq.p, b3)

    pairs, buckets = 2 * n, 2 * (1 << 15)  # id `buckets` is digit 0
    ids = torch.sort(torch.randint(0, buckets + 1, (pairs,), generator=gen))[0]
    check_bucket_scan(results, "k21", draw(Qa, pairs), ids, m)


# (tag, c, W) of the fused reduction: the k=21 commit's window and the
# K=7 commit's, signed digits (B = 2^(c-1) buckets a window)
REDUCE_SHAPES = (("k21", 16, 16), ("k7", 8, 32))


def reduce_inputs(F, curve, n: int, rng, dev, jacobian: bool = False):
    """n points on the card, random multiples of a pool with random l:
    projective (x*l : y*l : l), or Jacobian (x*l^2 : y*l^3 : l); rows 0, 1
    are identities (0 : l : 0), row 3 is -(row 2), rows 4 and 5 are
    equal."""
    from zksnap_tpu_torch.curves.native import AffinePoint

    g = AffinePoint.generator(curve)
    pool = [rng.randrange(1, curve.n) * g for _ in range(64)]
    px = F.to_mont([q.x for q in pool], dev)
    py = F.to_mont([q.y for q in pool], dev)
    gen = torch.Generator().manual_seed(rng.randrange(1 << 31))
    idx = torch.randint(0, len(pool), (n,), generator=gen).to(dev)
    x, y = px[idx], py[idx]
    y[3] = F.neg(y[2])
    x[3] = x[2]
    x[5], y[5] = x[4], y[4]
    lam = F.to_mont([rng.randrange(1, F.p) for _ in range(n)], dev)
    lx = ly = lam
    if jacobian:
        lx = F.mul(lam, lam)
        ly = F.mul(lx, lam)
    X, Y = F.mul(x, lx), F.mul(y, ly)
    X[:2] = 0
    Y[:2] = lam[:2]
    Z = lam.clone()
    Z[:2] = 0
    return X, Y, Z


def phase2_reduce(dev, rng, results):
    """K5 and K6 against their plain versions at the k=21 and K=7 shapes
    of the fused reduction, edge cases included: identity buckets, a
    window of identities, P beside -P, equal buckets; at K=7 K5's and
    K6's Jacobian branches (b3 = 0) too, untimed."""
    from zksnap_tpu_torch.curves import fused
    from zksnap_tpu_torch.curves.native import BN254_G1
    from zksnap_tpu_torch.fields import bn254_fq

    F = bn254_fq()
    b3 = 3 * BN254_G1.b
    for tag, c, W in REDUCE_SHAPES:
        B = 1 << (c - 1)
        branches = ((b3, False), (0, True)) if tag == "k7" else ((b3, False),)
        errs = {}
        for b, jac in branches:
            flat_b = reduce_inputs(F, BN254_G1, W * B, rng, dev, jac)
            for a in flat_b:  # window 1: all identities
                a[B : 2 * B] = a[0]
            want, ms = timed(
                lambda: fused.weighted_suffix_plain(flat_b, B, F.p, b))
            errs[b] = max_abs_err(fused.weighted_suffix(flat_b, B, F.p, b),
                                  want)
            require(errs[b] == 0, ("K5", tag, "b3", b, errs[b]))
            del want
            if b:
                flat, plain_ms = flat_b, ms
        # the function's work: a sequential double suffix, two padd a
        # bucket (the kernels do 4 - 2/C and the carries)
        adds = 2 * W * B
        k5 = shape_result(
            results, "K5", tag, W=W, B=B, C=fused.suffix_chunk(W * B, B),
            max_abs_err=max(errs.values()),
            jacobian_max_abs_err=errs.get(0), plain_ms=plain_ms,
            ms=cuda_ms(lambda: fused.weighted_suffix(flat, B, F.p, b3), 5),
            device_ms=kernel_device_ms(
                lambda: fused.weighted_suffix(flat, B, F.p, b3), K5_KERNELS,
                reps=3, per_call=True),
            **formula_bound([(adds, PADD)], W * B * 6 * ROW))
        wsums = reduce_inputs(F, BN254_G1, W, rng, dev)
        got = fused.ladder_tree(wsums, c, W, F.p, b3)
        want, plain_ms = timed(
            lambda: fused.ladder_tree_plain(wsums, c, W, F.p, b3))
        err = max_abs_err(got, want)
        require(err == 0, ("K6", tag, err))
        jac_err = None
        if tag == "k7":  # K6's Jacobian branch (b3 = 0), untimed
            jsums = reduce_inputs(F, BN254_G1, W, rng, dev, True)
            jac_err = max_abs_err(fused.ladder_tree(jsums, c, W, F.p, 0),
                                  fused.ladder_tree_plain(jsums, c, W, F.p, 0))
            require(jac_err == 0, ("K6", tag, "b3", 0, jac_err))
        # the function's work: Horner's combine, c doublings and one padd
        # for each window past the first (the kernel's masked ladder
        # doubles every lane in parallel, sum_w c*w in all)
        k6 = shape_result(
            results, "K6", tag, c=c, W=W, max_abs_err=err,
            jacobian_max_abs_err=jac_err, plain_ms=plain_ms,
            ms=cuda_ms(lambda: fused.ladder_tree(wsums, c, W, F.p, b3), 20),
            device_ms=kernel_device_ms(
                lambda: fused.ladder_tree(wsums, c, W, F.p, b3),
                "ladder_tree_kernel"),
            **formula_bound([(c * (W - 1), PDBL), (W - 1, PADD)],
                            (W + 1) * 3 * ROW))
        for name, r in (("K5 weighted suffix", k5),
                        ("K6 ladder and tree", k6)):
            log(f"{name} bit-exact ({tag} shape, "
                + ", ".join(f"{key}={r[key]}" for key in ("c", "W", "B")
                            if key in r)
                + f"): kernel {r['ms']:.4f} ms a call "
                f"({fmt_ms(r['device_ms'])} on the device), plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4g} ms")


# (c, W) of K6's latency fit: c = 16 (the k=21 commit's) over 0 to 240
# dependent doublings
LADDER_FIT = tuple((16, w) for w in (1, 2, 4, 8, 16))


def fit_line(xs, ys) -> tuple[float, float]:
    """Least-squares (a, b) of y = a + b x."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    b = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
         / sum((x - mx) ** 2 for x in xs))
    return my - b * mx, b


def check_ladder_fit(dev, rng, results):
    """K6 bit-exact against its plain version at c = 16 for W = 1 (a
    general point), W = 2 (P beside -P; two identities), in RCB and in
    Jacobian coordinates (b3 = 0), then its device
    time a launch over LADDER_FIT, fitted as a + b c (W - 1): b is the
    dependent chain's microseconds a doubling, a the tree's and the
    launch's."""
    from zksnap_tpu_torch.curves import fused
    from zksnap_tpu_torch.curves.native import BN254_G1
    from zksnap_tpu_torch.fields import bn254_fq

    F, b3 = bn254_fq(), 3 * BN254_G1.b
    rows = reduce_inputs(F, BN254_G1, 24, rng, dev)
    jac_rows = reduce_inputs(F, BN254_G1, 24, rng, dev, True)

    def sums(lo, w, src=rows):
        return tuple(a[lo : lo + w].contiguous() for a in src)

    for src, b in ((rows, b3), (jac_rows, 0)):
        for lo, w in ((6, 1), (2, 2), (0, 2)):
            err = max_abs_err(
                fused.ladder_tree(sums(lo, w, src), 16, w, F.p, b),
                fused.ladder_tree_plain(sums(lo, w, src), 16, w, F.p, b))
            require(err == 0, ("K6", "c=16", "b3", b, "W", w, "rows", lo,
                               err))
    by = {}
    for c, w in LADDER_FIT:
        ws = sums(6, w)
        by[c * (w - 1)] = kernel_device_ms(
            lambda: fused.ladder_tree(ws, c, w, F.p, b3), "ladder_tree_kernel")
    xs = sorted(by)
    a, b = fit_line(xs, [by[x] for x in xs])
    results["K6_fit"] = {"device_ms": by, "a_us": a * 1e3,
                         "us_a_doubling": b * 1e3}
    log(f"K6 bit-exact at c=16, W=1 and W=2, RCB and Jacobian; device ms a launch over its "
        f"c*(W-1) dependent doublings {by}: {b * 1e3:.3f} us a doubling, "
        f"{a * 1e3:.1f} us besides")


# (tag, n) of K7 and K8: a batch of 2^20 points, and the 32768 lanes of
# the port's bucket scan
POINT_SHAPES = (("n2^20", 1 << 20), ("n32768", 32768))


def dbl_lanes(P, Q, p: int):
    """Lanes where the complete Jacobian add needs its doubling fallback:
    P == Q, neither the identity."""
    from zksnap_tpu_torch.fields.pallas_mont import mont_mul_plain

    def mul(a, b):
        return mont_mul_plain(a, b, p)

    z1z1, z2z2 = mul(P[2], P[2]), mul(Q[2], Q[2])
    same_x = (mul(P[0], z2z2) == mul(Q[0], z1z1)).all(-1)
    same_y = (mul(mul(P[1], Q[2]), z2z2) == mul(mul(Q[1], P[2]), z1z1)).all(-1)
    finite = (P[2] != 0).any(-1) & (Q[2] != 0).any(-1)
    return same_x & same_y & finite


def point_batch_inputs(n: int, rng, dev):
    """(P, Q, lanes where P == Q) of n seeded BN254 points in Jacobian
    coordinates: rows drawn from 8192 seeded rows, the first eight the
    edge cases of point_inputs (P = inf, Q = inf, both inf, P = Q,
    P = -Q, ...)."""
    from zksnap_tpu_torch.curves.native import BN254_G1
    from zksnap_tpu_torch.fields import bn254_fq

    Fq = bn254_fq()
    P, Q, _ = point_inputs(BN254_G1, Fq, 8192, rng, dev, True)
    gen = torch.Generator().manual_seed(rng.randrange(1 << 31))
    idx = torch.randint(0, 8192, (n,), generator=gen)
    idx[:8] = torch.arange(8)
    idx = idx.to(dev)
    same = int(dbl_lanes(P, Q, Fq.p)[idx].sum())
    return tuple(a[idx] for a in P), tuple(a[idx] for a in Q), same


def same_point_batch(n: int, rng, dev):
    """(P, Q) of n seeded BN254 points in Jacobian coordinates with P == Q
    on every lane, each side with its own z: the complete add's worst
    case, every lane taking the doubling fallback.  Rows drawn from 8192
    seeded rows."""
    from zksnap_tpu_torch.curves.native import BN254_G1, AffinePoint
    from zksnap_tpu_torch.fields import bn254_fq

    Fq, q = bn254_fq(), BN254_G1.p
    g = AffinePoint.generator(BN254_G1)
    pool = [rng.randrange(1, BN254_G1.n) * g for _ in range(48)]
    pts = [pool[rng.randrange(len(pool))] for _ in range(8192)]

    def encode():
        rows = []
        for pt in pts:
            lam = rng.randrange(1, q)
            rows.append((lam * lam * pt.x % q, pow(lam, 3, q) * pt.y % q, lam))
        return tuple(Fq.to_mont([r[i] for r in rows], dev) for i in range(3))

    P, Q = encode(), encode()
    gen = torch.Generator().manual_seed(rng.randrange(1 << 31))
    idx = torch.randint(0, 8192, (n,), generator=gen).to(dev)
    return tuple(a[idx] for a in P), tuple(a[idx] for a in Q)


# lanes of half a warp of K3's Jacobian kinds (one thread a point), and
# how many of them warp_mixed_batch makes edge cases
MIX_LANES = 16
MIX_EDGES = 4


def warp_mixed_batch(n: int, rng, dev):
    """(P, Q, lanes where P == Q) of n seeded BN254 points in Jacobian
    coordinates (n a multiple of MIX_LANES): in every MIX_LANES
    consecutive lanes, MIX_EDGES lanes at random places take one of the
    eight edge rows of point_inputs (identities, P == Q, P == -Q) and the
    others ordinary rows, so that the doubling fallback and the identity
    selects run in warps whose other lanes take the plain formula."""
    from zksnap_tpu_torch.curves.native import BN254_G1
    from zksnap_tpu_torch.fields import bn254_fq

    Fq = bn254_fq()
    P, Q, _ = point_inputs(BN254_G1, Fq, 8192, rng, dev, True)
    gen = torch.Generator().manual_seed(rng.randrange(1 << 31))
    warps = n // MIX_LANES
    idx = torch.randint(8, 8192, (warps, MIX_LANES), generator=gen)
    slots = torch.rand(warps, MIX_LANES, generator=gen).argsort(dim=1)
    idx.scatter_(1, slots[:, :MIX_EDGES],
                 torch.randint(0, 8, (warps, MIX_EDGES), generator=gen))
    idx = idx.reshape(n).to(dev)
    same = int(dbl_lanes(P, Q, Fq.p)[idx].sum())
    return tuple(a[idx] for a in P), tuple(a[idx] for a in Q), same


def phase_point_batch(dev, rng, results) -> dict:
    """K8 (point_add_batch, point_dbl_batch) and K7 (point_add_staged)
    through their public entry points, which launch K3's Jacobian kinds
    (the SRS's double-and-add launches the same kernels through K3's
    `point`): each called once at n = 2^20 with the counts set to 0 just
    before and read just after (the kernels line's launches; K3's count
    takes each of them too); then every form held against its plain
    version at both shapes, staged against fused, and timed, and K8's add
    on a batch with P == Q on every lane (the doubling fallback in every
    block) and on the warp-mixed edge batch.  Returns the launches of that
    one call of each."""
    from zksnap_tpu_torch.curves import fused
    from zksnap_tpu_torch.curves import pallas_point as pp
    from zksnap_tpu_torch.fields import bn254_fq

    Fq = bn254_fq()
    p, n0 = Fq.p, Fq.n0
    launches = None
    for tag, n in POINT_SHAPES:
        P, Q, same = point_batch_inputs(n, rng, dev)
        S = same_point_batch(n, rng, dev)
        E, F, e_same = warp_mixed_batch(n, rng, dev)
        # the function's own work: the add, and a dbl on the lanes where
        # P == Q (the kernel doubles every lane of a block that holds one)
        add_work = [(n, JADD), (same, JDBL)]
        forms = {  # name: (entry point, plain version, work, rows)
            "add": (lambda: pp.point_add_batch(P, Q, p, n0),
                    lambda: pp.point_add_batch_plain(P, Q, p, n0),
                    add_work, 9),
            "dbl": (lambda: pp.point_dbl_batch(P, p, n0),
                    lambda: pp.point_dbl_batch_plain(P, p, n0),
                    [(n, JDBL)], 6),
            # the plain version and the bound are the add's: the TPU's
            # split changes no value, and here it is one launch of the add
            "staged": (lambda: pp.point_add_staged(P, Q, p, n0),
                       lambda: pp.point_add_batch_plain(P, Q, p, n0),
                       add_work, 9),
            "add_p_eq_q": (lambda: pp.point_add_batch(*S, p, n0),
                           lambda: pp.point_add_batch_plain(*S, p, n0),
                           [(n, JADD), (n, JDBL)], 9),
            "add_warp_mixed": (
                lambda: pp.point_add_batch(E, F, p, n0),
                lambda: pp.point_add_batch_plain(E, F, p, n0),
                [(n, JADD), (e_same, JDBL)], 9)}
        if launches is None:
            for fn in (pp.point_add_batch, pp.point_dbl_batch,
                       pp.point_add_staged, fused.point):
                fn.launches = 0
            got = {name: forms[name][0]() for name in ("add", "dbl",
                                                       "staged")}
            torch.cuda.synchronize()
            launches = {"K7": pp.point_add_staged.launches,
                        "K8": pp.point_add_batch.launches
                        + pp.point_dbl_batch.launches}
            log(f"K7/K8 path (one call of each entry point, n={n}): "
                f"launches {launches}, K3's point kernel "
                f"{fused.point.launches}")
            require(launches == {"K7": 1, "K8": 2}
                    and fused.point.launches == 3,
                    (launches, fused.point.launches))
            got.update({name: forms[name][0]() for name in forms
                        if name not in got})
        else:
            got = {name: f[0]() for name, f in forms.items()}
        require(max_abs_err(got["staged"], got["add"]) == 0,
                ("K7 staged != K8 add", tag))
        rows = {}
        for name, (fn, plain, work, nrows) in forms.items():
            want, plain_ms = timed(plain)
            err = max_abs_err(got[name], want)
            require(err == 0, ("K7/K8", name, tag, err))
            del want
            rows[name] = dict(n=n, max_abs_err=err, plain_ms=plain_ms,
                              ms=cuda_ms(fn, 20),
                              device_ms=kernel_device_ms(fn, "point_kernel",
                                                         per_call=True),
                              **formula_bound(work, n * nrows * ROW))
            r = rows[name]
            log(f"{'K7' if name == 'staged' else 'K8'} {name:14s} bit-exact "
                f"({tag}): {r['ms']:.4f} ms a call ({fmt_ms(r['device_ms'])}"
                f" on the device), plain {r['plain_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4g} ms ({r['bound_by']})")
        del got
        log(f"K7/K8 ({tag}): {same} of {n} lanes have P == Q (the add's "
            f"bound counts a dbl on those); every lane in add_p_eq_q; "
            f"{e_same} in add_warp_mixed, {MIX_EDGES} edge lanes in "
            f"every {MIX_LANES}")
        shape_result(results, "K8", tag, **rows["add"], dbl=rows["dbl"],
                     p_eq_q=same, add_p_eq_q=rows["add_p_eq_q"],
                     add_warp_mixed=dict(rows["add_warp_mixed"],
                                         p_eq_q=e_same))
        shape_result(results, "K7", tag, **rows["staged"], p_eq_q=same)
    return launches


# -- the experiments path: K9-K11 ---------------------------------------------

def loop_control(op: str, args: str) -> bool:
    """An instruction of a loop's control, not of its steps: the branch,
    the compare, the uniform datapath's and convergence instructions, and
    the counter's add of an immediate."""
    return (op in ("BRA", "ISETP", "PLOP3", "NOP", "BSSY", "BSYNC",
                   "WARPSYNC", "YIELD") or op.startswith("U")
            or (op in ("IADD3", "VIADD", "IADD") and "0x" in args))


def sass_functions(lib_path: str) -> dict:
    """{function name: [(address, opcode with its modifiers, operands)]}
    of every function in `cuobjdump -sass` of the kernel library."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    require(tool is not None, "cuobjdump, from which the SASS is read")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Za-z0-9.]*)\s*([^;]*);", line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def loop_spans(instrs) -> list:
    """(first, last) addresses of each loop of a listing: the span of
    each backward branch."""
    spans = []
    for addr, op, args in instrs:
        target = re.findall(r"0x[0-9a-f]+", args)
        if (op.split(".")[0] == "BRA" and target
                and int(target[-1], 16) <= addr):
            spans.append((int(target[-1], 16), addr))
    return spans


def main_loop(instrs, control=loop_control) -> list:
    """The opcodes (with modifiers) of a function's main loop, those that
    `control` calls the loop's control left out: the span of the backward
    branch with the most instructions (None when the function has no
    loop)."""
    best = None
    for lo, hi in loop_spans(instrs):
        body = [o for ad, o, a in instrs
                if lo <= ad <= hi and not control(o.split(".")[0], a)]
        if best is None or len(body) > len(best):
            best = body
    return best


def chain_loops(lib_path: str) -> dict:
    """{chain kind: {opcode: count}}: the body of each K11 chain kernel's
    main loop in `cuobjdump -sass`, its control left out.  That loop is
    the span of the backward branch with the most instructions, and it
    runs vr.CHAIN_UNROLL steps a trip."""
    from zksnap_tpu_torch.experiments import exp_vpu_rates as vr

    funcs = {}
    for name, instrs in sass_functions(lib_path).items():
        k = re.search(r"op_chain_kernelILi(\d)E", name)
        if k:
            funcs[vr.CHAIN_KINDS[int(k.group(1))]] = instrs
    loops = {}
    for kind in vr.CHAIN_KINDS:
        best = main_loop(funcs.get(kind, ()))
        require(best, ("no loop in the SASS of K11", kind))
        best = [o.split(".")[0] for o in best]
        loops[kind] = {o: best.count(o) for o in sorted(set(best))}
    return loops


# The SASS read for the bucket scan and the weighted suffix: how many of
# a function's instructions go to each pipe or memory space.
SASS_GROUPS = {"IMAD*": ("IMAD",),
               "IADD3/LOP3/SHF/SEL": ("IADD3", "LOP3", "SHF", "SEL"),
               "LDL/STL": ("LDL", "STL"), "LDG/STG": ("LDG", "STG"),
               "LDS/STS": ("LDS", "STS"), "CALL": ("CALL",)}


def sass_mix(ops) -> dict:
    """{group of SASS_GROUPS: count, "all": count, "opcodes": {...}}."""
    bases = [o.split(".")[0] for o in ops]
    mix = {g: sum(bases.count(b) for b in names)
           for g, names in SASS_GROUPS.items()}
    mix["all"] = len(ops)
    mix["opcodes"] = {o: ops.count(o) for o in sorted(set(ops))}
    return mix


def kernel_sass(lib_path: str, fragments) -> dict:
    """For each kernel whose name holds one of `fragments`: the mix of its
    main loop, of each loop inside it (the rounds of a product stage, for
    example, each run many times a trip of the main loop) and of each
    subroutine of its listing.  A function that is
    not inlined is compiled into the kernel's listing after its EXIT and
    reached by CALL: the subroutines start at the listing's first address
    and at each CALL target, and each is listed with its call sites."""
    out = {}
    for name, instrs in sass_functions(lib_path).items():
        if not any(f in name for f in fragments):
            continue
        calls = [int(re.findall(r"0x[0-9a-f]+", a)[-1], 16)
                 for _, o, a in instrs if o.startswith("CALL")]
        starts = sorted({instrs[0][0], *calls})
        subs = {}
        for lo, hi in zip(starts, starts[1:] + [1 << 62]):
            body = [(ad, o, a) for ad, o, a in instrs if lo <= ad < hi]
            subs[hex(lo)] = dict(sass_mix([o for _, o, _ in body]),
                                 call_sites=calls.count(lo))
        own = [i for i in instrs if i[0] < (starts + [1 << 62])[1]]
        loop = main_loop(own, lambda op, args: op == "BRA")
        spans = sorted(loop_spans(own), key=lambda s: s[0] - s[1])
        inner = [sass_mix([o for ad, o, _ in own
                           if lo <= ad <= hi and o.split(".")[0] != "BRA"])
                 for lo, hi in spans[1:]
                 if spans[0][0] <= lo and hi <= spans[0][1]]
        out[name] = {"loop": None if loop is None else sass_mix(loop),
                     "inner_loops": inner, "subroutines": subs}
    return out


# K5's kernels: the chunk totals, the carries and the chunk reruns; with
# K4's, the kernels whose ptxas lines and SASS the run reports
K5_KERNELS = ("suffix_chunk_total_kernel", "suffix_carry_kernel",
              "suffix_chunk_kernel")
SCAN_KERNELS = ("bucket_scan_kernel",) + K5_KERNELS


# K3's kinds (the Jacobian add, madd, dbl; padd, pmadd, pdbl) and K6's
# RCB kernel, by their mangled names' prefixes: they must run inlined,
# with a 0-byte stack frame and no CALL and no local memory access in
# their SASS
INLINED_KERNELS = ("point_kernelILi0E", "point_kernelILi1E",
                   "point_kernelILi2E", "point_kernelILi3E",
                   "point_kernelILi4E", "point_kernelILi5E",
                   "ladder_tree_kernelILb1E")


def inlined(ptxas: dict, sass: dict, fragments=INLINED_KERNELS) -> dict:
    """{fragment: {"kernel", "registers", "stack_bytes", "calls",
    "local"}} for the one kernel whose name holds each fragment: its
    ptxas line (ptxas_entries) and the CALLs and LDL/STL in its SASS
    listing (kernel_sass: its own code and every subroutine)."""
    out = {}
    for frag in fragments:
        names = [k for k in sass if frag in k]
        require(len(names) == 1 and names[0] in ptxas,
                ("one kernel's ptxas line and SASS", frag, names))
        name = names[0]
        out[frag] = {"kernel": name,
                     "registers": ptxas[name].get("registers"),
                     "stack_bytes": ptxas[name].get("stack_bytes"),
                     **{key: sum(s[group] for s in
                                 sass[name]["subroutines"].values())
                        for key, group in (("calls", "CALL"),
                                           ("local", "LDL/STL"))}}
    return out


def require_inlined(report: dict):
    """Each kernel of inlined()'s report has a 0-byte stack frame, no
    CALL and no local memory access."""
    for frag, r in report.items():
        require(r["stack_bytes"] == 0 and r["calls"] == 0
                and r["local"] == 0, ("not inlined", frag, r))


def ptxas_entries(log_text: str) -> dict:
    """{kernel: {"registers", "stack_bytes", "spill_stores",
    "spill_loads"}} from the build's `-Xptxas -v` output."""
    out, entry, props = {}, None, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = props = m.group(1)
            out[entry] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry and props == entry:
            out[entry].update(stack_bytes=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry]["registers"] = int(m.group(1))
    return out


def chain_step_rate(body: dict, unroll: int) -> float:
    """Lane-steps a second that a loop body of `unroll` steps allows on
    132 SMs: the issue and each pipe of PIPES spend body's instructions'
    lanes at their own rate, and the slowest decides."""
    clocks = sum(body.values()) / ISSUE_LANES
    for lanes, ops in PIPES.values():
        clocks = max(clocks, sum(body.get(o, 0) for o in ops) / lanes)
    require(clocks > 0, ("an empty chain loop", body))
    return SM_CLOCKS_PER_S * unroll / clocks


# K9's and K10's kernels (the 16-bit-limb Montgomery products), by their
# mangled names' prefixes, and the operations of one of K10's `mma.sync`
# m16n8k32 warp instructions
EXP_MUL_KERNELS = ("mul16_kernel", "mxu_mul_kernel")
MMA_OPS = 2 * 16 * 8 * 32
# their ptxas lines (registers, stack frame bytes) since their redesign
# (exp_kernel_key's keys)
EXP_MUL_PTXAS = {"mul16_kernel<0>": (70, 0), "mul16_kernel<1>": (60, 0),
                 "mxu_mul_kernel<0>": (62, 0), "mxu_mul_kernel<1>": (122, 0),
                 "mxu_mul_kernel<2>": (96, 0), "mxu_mul_kernel<3>": (116, 0),
                 "mxu_mul_kernel<4>": (92, 0), "mxu_mul_kernel<5>": (128, 0)}


def weighted_opcodes(instrs, trips) -> dict:
    """{opcode with its modifiers: count} of a listing, each instruction
    counted once for every trip of the loops around it: trips[d] for a
    loop at depth d (0 the outermost; the spans of loop_spans), once for a
    loop deeper than trips gives.  The branch to itself that ends a
    listing is no loop."""
    spans = [(lo, hi) for lo, hi in loop_spans(instrs) if lo < hi]
    out = {}
    for addr, op, _ in instrs:
        depth = sum(lo <= addr <= hi for lo, hi in spans)
        w = 1
        for d in range(min(depth, len(trips))):
            w *= trips[d]
        out[op] = out.get(op, 0) + w
    return out


def issue_clocks(ops: dict) -> dict:
    """SM clocks that one element's instructions (one thread's weighted
    opcodes) take on 132 SMs, for the issue and each pipe: the issue 128
    lanes a clock, the IMAD and ALU pipes 64 (IMAD.WIDE twice on the IMAD
    pipe, its two 32-bit results as MUL_OPS counts them), the tensor cores
    at the int8 rate: MMA_OPS for a warp's IMMA, 2 M N K for a
    warpgroup's IGMMA.MxNxK."""
    def count(names, wide=False):
        return sum(c * (2 if wide and o.startswith("IMAD.WIDE") else 1)
                   for o, c in ops.items() if o.split(".")[0] in names)

    mma = count(("IMMA", "HMMA")) * MMA_OPS / 32
    for o, c in ops.items():
        m = re.match(r"IGMMA\.(\d+)x(\d+)x(\d+)", o)
        if m:
            mma += c * 2 * math.prod(map(int, m.groups())) / 128
    return {"issue": sum(ops.values()) / ISSUE_LANES,
            "imad": count(PIPES["imad"][1], wide=True) / PIPES["imad"][0],
            "alu": count(PIPES["alu"][1]) / PIPES["alu"][0],
            "tensor": mma / (INT8_OPS_PER_S / SM_CLOCKS_PER_S)}


def issue_bound(ops: dict, n: int, nbytes: float) -> dict:
    """The least time n elements' compiled instructions `ops` (one
    element's, issue_clocks) could take, or their bytes at HBM's rate."""
    clk = issue_clocks(ops)
    by = max(clk, key=clk.get)
    t = clk[by] * n / SM_CLOCKS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"issue_bound_ms": max(t, t_bytes),
            "issue_bound_by": by if t >= t_bytes else "bytes",
            "clocks_an_element": clk}


def exp_mul_report(ptxas: dict, lib_path: str) -> dict:
    """{K9 or K10 kernel: its ptxas line, the LDL/STL and CALLs and the
    loops of its listing, and the SASS an element runs at each shape
    (weighted_opcodes)}: mul16_kernel<false> one product a trip of its
    loop over n_muls (B once, the chains x4, x18, x40), <true> (C) once
    with 16 trips of each loop inside, mxu_mul_kernel<V> one trip of its
    loop over the tiles.  A loop that these do not name counts once (the
    count is then a floor), and `loops` says how many loops the listing
    has."""
    from zksnap_tpu_torch.experiments import exp_mul_variants as mv

    out = {}
    for name, instrs in sass_functions(lib_path).items():
        if not any(f in name for f in EXP_MUL_KERNELS):
            continue
        if "mul16_kernelILb0E" in name:
            shapes = {"B": [1], **{f"B x{k}": [k] for k in mv.CHAINS}}
        elif "mul16_kernelILb1E" in name:
            shapes = {"C": [1, 16]}
        else:
            shapes = {"": [1]}
        ops = [o for _, o, _ in instrs]
        out[name] = {
            **{k: ptxas.get(name, {}).get(k) for k in (
                "registers", "stack_bytes", "spill_stores", "spill_loads")},
            "LDL/STL": sum(o.split(".")[0] in ("LDL", "STL") for o in ops),
            "CALL": sum(o.startswith("CALL") for o in ops),
            "loops": sum(lo < hi for lo, hi in loop_spans(instrs)),
            "an_element": {tag: weighted_opcodes(instrs, trips)
                           for tag, trips in shapes.items()}}
    return out


def exp_kernel_key(name: str) -> str:
    """A K9 or K10 kernel's mangled name -> `mul16_kernel<1>`, say: the
    same key for any signature."""
    m = re.search(r"(mul16_kernel|mxu_mul_kernel)IL[bi](\d)E", name)
    require(m, ("not a K9 or K10 kernel", name))
    return f"{m.group(1)}<{m.group(2)}>"


def require_exp_mul(report: dict):
    """K9's and K10's kernels against EXP_MUL_PTXAS (their registers and
    stack frames, every one 0 bytes), and no LDL/STL in any listing."""
    got = {exp_kernel_key(k): r for k, r in report.items()}
    require(set(got) == set(EXP_MUL_PTXAS), ("K9/K10 kernels", sorted(got)))
    lines = {k: (r["registers"], r["stack_bytes"]) for k, r in got.items()}
    require(lines == EXP_MUL_PTXAS, ("K9/K10 ptxas lines changed", {
        k: (v, EXP_MUL_PTXAS[k]) for k, v in lines.items()
        if v != EXP_MUL_PTXAS[k]}))
    require(all(r["LDL/STL"] == 0 for r in got.values()),
            ("K9/K10 local memory", {k: r["LDL/STL"] for k, r in got.items()}))


def u32_rows(rng, W: int, dev) -> torch.Tensor:
    """[16, W] uint32 bits as int32: rows 0-7 over all 32 bits, rows 8-15
    below 2^16 (the scripts' range)."""
    x = rng.integers(0, 1 << 32, (16, W), dtype=np.uint32)
    x[8:] &= 0xFFFF
    return torch.from_numpy(x.view(np.int32)).to(dev)


def limb_rows(rng, n: int, top_mask: int, dev, edge=()) -> torch.Tensor:
    """[16, n] random 16-bit limbs, the top one masked; the first columns
    the values in `edge`."""
    x = rng.integers(0, 1 << 16, (16, n), dtype=np.uint32)
    x[-1] &= top_mask
    for j, v in enumerate(edge):
        x[:, j] = [(v >> (16 * i)) & 0xFFFF for i in range(16)]
    return torch.from_numpy(x.view(np.int32)).to(dev)


# the experiment scripts' default shapes: K11 on [16, 2^14] with a chain of
# 512; K9 at n = 2^20 (chains at n / 4); K10 at B = 2^18
EXP_W_LOG, EXP_CHAIN, EXP_N_LOG, EXP_B_LOG = 14, 512, 20, 18
RATE_CHAIN = 16384  # K11's chains again, long enough to read a rate
# K11's dots are held to their plain versions at these widths: the script's
# 2^14, the docstring's 2^18, and two off every multiple of 64, so a
# 64-column tile runs with idle rows (2^14 - 8: 56 columns; 72: 8)
DOT_CHECK_W = (1 << 14, 1 << 18, (1 << 14) - 8, 72)


def dot_sides(rng, kind: str, W: int):
    """numpy (L, x0) of a K11 dot as the script draws them: i8dot in
    [-8, 8); bf16dot L standard normal, x0 normal * 0.1."""
    if kind == "i8dot":
        return (rng.integers(-8, 8, (64, 32)).astype(np.int8),
                rng.integers(-8, 8, (32, W)).astype(np.int8))
    return (rng.standard_normal((64, 32)).astype(np.float32),
            (rng.standard_normal((32, W)) * 0.1).astype(np.float32))


def dot_bound(kind: str, W: int, n_mm: int) -> dict:
    """bound() of a K11 dot: 2 * 64 * 32 * W operations a product at the
    tensor cores' int8 or bf16 rate; L and x0 read and acc written once."""
    side = 1 if kind == "i8dot" else 2
    nbytes = 64 * 32 * (1 if kind == "i8dot" else 4) + 32 * W * side \
        + 64 * W * 4
    return bound(2 * 64 * 32 * W * n_mm, nbytes,
                 INT8_OPS_PER_S if kind == "i8dot" else BF16_OPS_PER_S)


def dot_error(kind: str, got, want):
    """A K11 dot against its plain version: i8dot's largest difference,
    which must be 0; bf16dot's relative to max |acc|, at most BF16_TOL."""
    if kind == "i8dot":
        err = max_abs_err([got], [want])
        require(err == 0, ("K11 i8dot", err))
        return err
    err = float((got - want).abs().max() / want.abs().max())
    require(err <= BF16_TOL, ("K11 bf16dot", err, BF16_TOL))
    return err


def tensor_macs(op: str) -> int:
    """Multiply-adds that one warp issues in a tensor-core instruction:
    M N K of an `mma.sync` (IMMA.16832, HMMA.16816), a quarter of a
    warpgroup's `wgmma` (IGMMA.64x64x32, HGMMA.64x64x16); 0 otherwise."""
    m = re.match(r"[IH]GMMA\.(\d+)x(\d+)x(\d+)", op)
    if m:
        return math.prod(map(int, m.groups())) // 4
    m = re.match(r"[IH]MMA\.(16)(8)(\d+)", op)
    return math.prod(map(int, m.groups())) if m else 0


def dot_report(ptxas: dict, lib_path: str) -> dict:
    """{K11 dot kernel: its ptxas line, the LDL/STL of its listing, and its
    step loop (the innermost loop with tensor-core instructions): the
    opcodes of one trip, the steps a trip (the trip's
    multiply-adds over a step's: a warp's columns x 64 x 32, times
    exp_vpu_rates.DOT_PRODUCTS_A_STEP) and, for one step, its
    tensor-core instructions, LDS/STS, BAR and WARPSYNC}."""
    from zksnap_tpu_torch.experiments import exp_vpu_rates as vr

    step_macs = (getattr(vr, "DOT_COLUMNS_A_WARP", 8) * 64 * 32
                 * getattr(vr, "DOT_PRODUCTS_A_STEP", 1))
    out = {}
    for name, instrs in sass_functions(lib_path).items():
        if "dot_chain" not in name:
            continue
        ops, macs, span = {}, 0, None
        for lo, hi in loop_spans(instrs):
            body = [o for ad, o, _ in instrs
                    if lo <= ad <= hi and o.split(".")[0] != "BRA"]
            m = sum(tensor_macs(o) for o in body)
            if m and (span is None or hi - lo < span):
                ops = {o: body.count(o) for o in sorted(set(body))}
                macs, span = m, hi - lo
        steps = macs / step_macs

        def a_step(pred):
            n = sum(c for o, c in ops.items() if pred(o.split(".")[0]))
            return n / steps if steps else None

        out[name] = {
            **{k: ptxas.get(name, {}).get(k) for k in (
                "registers", "stack_bytes", "spill_stores", "spill_loads")},
            "LDL/STL": sum(o.split(".")[0] in ("LDL", "STL")
                           for _, o, _ in instrs),
            "steps_a_trip": steps, "trip": ops,
            "a_step": {
                "tensor": a_step(lambda b: b in ("IMMA", "HMMA", "IGMMA",
                                                  "HGMMA")),
                "LDS/STS": a_step(lambda b: b in ("LDS", "STS")),
                "BAR": a_step(lambda b: b == "BAR"),
                "WARPSYNC": a_step(lambda b: b == "WARPSYNC"),
                "all": a_step(lambda b: True)}}
    return out


def require_dots(report: dict):
    """K11's two dot kernels (i8dot, bf16dot): a 0-byte stack frame, no
    LDL/STL, and a step loop with its tensor-core instructions and no
    LDS/STS."""
    require(len(report) == 2, ("K11 dot kernels", sorted(report)))
    for name, r in report.items():
        require(r["stack_bytes"] == 0 and r["LDL/STL"] == 0
                and r["a_step"]["tensor"] and r["a_step"]["LDS/STS"] == 0,
                ("K11 dot kernel's frame, local memory or step loop", name,
                 r))


def exp_mul_ragged(dev) -> dict:
    """K9's B, C and chain x4 at n = 2^20 - 37 and 100, and K10's six
    variants at B = 2^18 - 37 and 100, each bit-exact against its plain
    version: sizes off every multiple of 32, so a tile with idle lanes, a
    block with idle warps and kar+mxu's warpgroup with a warp past n all
    run.  Returns {shape: n}."""
    from zksnap_tpu_torch.experiments import exp_mul_mxu as mx
    from zksnap_tpu_torch.experiments import exp_mul_variants as mv
    from zksnap_tpu_torch.fields import bn254_fr

    rng = np.random.default_rng(20261018)
    out = {}
    F, Fr = mv.FQ, bn254_fr()
    for n in ((1 << EXP_N_LOG) - 37, 100):
        a = limb_rows(rng, n, 0x2FFF, dev, edge=(0, 1, F.p - 1, F.p - 2))
        b = limb_rows(rng, n, 0x2FFF, dev, edge=(F.p - 1, 0, F.p - 1, 1))
        want = mv.mul_limb_major_plain(a, b, F.p)
        for name, rolled in (("B", False), ("C", True)):
            got = mv.mul_limb_major(a, b, F.p, rolled=rolled)
            require(torch.equal(got, want), ("K9 ragged", name, n))
            out[f"K9 {name}"] = out.get(f"K9 {name}", []) + [n]
        got = mv.mul_limb_major(a, b, F.p, n_muls=4)
        require(torch.equal(got, mv.mul_limb_major_plain(a, b, F.p,
                                                         n_muls=4)),
                ("K9 ragged chain x4", n))
        out["K9 B x4"] = out.get("K9 B x4", []) + [n]
    for B in ((1 << EXP_B_LOG) - 37, 100):
        edge = (0, 1, Fr.p - 1, (1 << 256) - 1)
        a = limb_rows(rng, B, 0xFFFF, dev, edge=edge)
        b = limb_rows(rng, B, 0xFFFF, dev, edge=edge[::-1])
        for variant in mx.VARIANTS:
            got = mx.mont_mul_mxu(a, b, variant, Fr.p)
            require(torch.equal(got, mx.mont_mul_mxu_plain(a, b, variant,
                                                           Fr.p)),
                    ("K10 ragged", variant, B))
            out[f"K10 {variant}"] = out.get(f"K10 {variant}", []) + [B]
    return out


def dot_library(kind: str, lhs, x0, n_mm: int):
    """K11's dot chain through torch._int_mm / torch.matmul: a yardstick,
    timed only."""
    acc, x = None, x0
    lb = lhs if kind == "i8dot" else lhs.to(torch.bfloat16)
    for _ in range(n_mm):
        if kind == "i8dot":
            y = torch._int_mm(lb, x)
            x = y[:32].to(torch.int8)
        else:
            y = torch.matmul(lb, x).float()
            x = (y[:32] * 1e-3).to(torch.bfloat16)
        acc = y if acc is None else acc + y
    return acc


# K11's dots are timed again at these widths of DOT_CHECK_W (the kernel,
# its plain version and the library's chain, in one run)
DOT_TIMED_W = (1 << 18, (1 << 14) - 8)
# K10's variants are held to their plain versions and timed at B = 2^20 too
K10_WIDE_B = 1 << 20


def phase_experiments(dev, results, loops: dict, exp_report: dict) -> dict:
    """The experiments path: each module's `main` at the scripts' default
    sizes on the card (exp_vpu_rates: 16 x 2^14 lanes, chain 512, 64
    products; exp_mul_variants: n = 2^20, chains at 2^18; exp_mul_mxu:
    B = 2^18, all six variants after the 256-value oracle check), with
    the counts of K9-K11 set to 0 just before and read just after; then
    every kernel against its plain version at those shapes, with the
    mains' times per call and the profiler's device times.  `loops` are
    K11's chain loop bodies (chain_loops), which bound its chains;
    `exp_report` K9's and K10's kernels (exp_mul_report), whose SASS an
    element gives each shape its issue bound beside the function's.
    Returns the launches of the path."""
    from zksnap_tpu_torch.experiments import exp_mul_mxu as mx
    from zksnap_tpu_torch.experiments import exp_mul_variants as mv
    from zksnap_tpu_torch.experiments import exp_vpu_rates as vr
    from zksnap_tpu_torch.fields import bn254_fr
    from zksnap_tpu_torch.fields.common import limbs_to_ints

    counters = {"K9": mv.mul_limb_major, "K10": mx.mont_mul_mxu,
                "K11 chain": vr.op_chain, "K11 dot": vr.dot_chain}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    d = ["--device", dev.type]
    lines = {"exp_vpu_rates": vr.main([str(EXP_W_LOG), str(EXP_CHAIN), *d]),
             "exp_mul_variants": mv.main(["--log-n", str(EXP_N_LOG), *d]),
             "exp_mul_mxu": mx.main([str(EXP_B_LOG), ",".join(mx.VARIANTS),
                                     *d])}
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"experiments path, the three mains ({time.time() - t0:.1f} s): "
        f"launches {launches}")
    require(min(launches.values()) > 0, launches)
    require(lines["exp_mul_variants"]["B == A"]
            and lines["exp_mul_variants"]["C == A"], "K9: B or C != A")
    require(all(lines["exp_mul_mxu"][v]["ok"] for v in mx.PRODUCTS),
            ("K10 oracle", lines["exp_mul_mxu"]))
    results["experiment_lines"] = lines
    rng = np.random.default_rng(20261017)

    # K11 chains: 16 x 2^14 lanes, chain 512 (and 13, the remainder loop);
    # a step's bound is what its compiled loop issues
    W, chain = 1 << EXP_W_LOG, EXP_CHAIN
    require(chain % vr.CHAIN_UNROLL == 0 and RATE_CHAIN % vr.CHAIN_UNROLL
            == 0, "K11's chains run whole trips of the main loop")
    for kind in ("u32mul", "u16mul"):
        require(loops[kind].get("IMAD") == vr.CHAIN_UNROLL,
                ("K11 loop of", kind, loops[kind]))
    require(loops["f32fma"].get("FFMA") == vr.CHAIN_UNROLL,
            ("K11 loop of f32fma", loops["f32fma"]))
    lanes = 16 * W
    a, b = u32_rows(rng, W, dev), u32_rows(rng, W, dev)
    for kind in vr.CHAIN_KINDS:
        def fn(kind=kind):
            return vr.op_chain(kind, a, b, chain)
        want, plain_ms = timed(lambda: vr.op_chain_plain(kind, a, b, chain))
        err = max(max_abs_err([fn()], [want]), max_abs_err(
            [vr.op_chain(kind, a, b, 13)],
            [vr.op_chain_plain(kind, a, b, 13)]))
        require(err == 0, ("K11", kind, err))
        rate = chain_step_rate(loops[kind], vr.CHAIN_UNROLL)
        r = shape_result(
            results, "K11", kind, lanes=lanes, chain=chain, max_abs_err=err,
            ms=lines["exp_vpu_rates"][kind]["ms"], plain_ms=plain_ms,
            device_ms=kernel_device_ms(fn, "op_chain_kernel"),
            loop=loops[kind], **bound(lanes * chain, lanes * 12, rate))
        # the rate: at chain 512 a launch lasts microseconds, so the rate
        # is read again over a chain of RATE_CHAIN steps, from CUDA events
        # over back-to-back launches of a third of a millisecond each
        long_ms = cuda_ms(lambda: vr.op_chain(kind, a, b, RATE_CHAIN), 10)
        r.update(rate_chain=RATE_CHAIN, rate_ms=long_ms,
                 gop_s=lanes * RATE_CHAIN / long_ms / 1e6,
                 bound_gop_s=rate / 1e9)
        log(f"K11 {kind:7s} bit-exact ({lanes} lanes, chain {chain}): "
            f"{r['ms']:.4f} ms a call ({fmt_ms(r['device_ms'])} on the "
            f"device), plain {plain_ms:.4f} ms, bound {r['bound_ms']:.4g} ms"
            f" (loop of {vr.CHAIN_UNROLL} steps: {loops[kind]}); chain "
            f"{RATE_CHAIN}: {long_ms:.4f} ms a launch, {r['gop_s']:.1f} G "
            f"steps/s (bound {r['bound_gop_s']:.1f})")

    # K11 dots: [64, 32] x [32, 2^14], 64 products in a chain
    n_mm = vr.N_MM
    sides = {kind: dot_sides(rng, kind, W) for kind in vr.DOT_KINDS}
    for kind in vr.DOT_KINDS:
        go, (lhs, x0) = vr.make_dot(kind, W, n_mm, *sides[kind], device=dev)
        got = go(lhs, x0)
        want, plain_ms = timed(lambda: vr.dot_chain_plain(kind, lhs, x0,
                                                          n_mm))
        err = dot_error(kind, got, want)

        def library(kind=kind, lhs=lhs, x0=x0):
            return dot_library(kind, lhs, x0, n_mm)

        macs = 64 * 32 * W * n_mm
        r = shape_result(
            results, "K11dot", kind, W=W, n_mm=n_mm, max_abs_err=err,
            exact=kind == "i8dot", ms=lines["exp_vpu_rates"][kind]["ms"],
            plain_ms=plain_ms, library_ms=cuda_ms(library, 20),
            device_ms=kernel_device_ms(lambda: go(lhs, x0),
                                       "dot_chain_kernel"),
            library=("torch._int_mm" if kind == "i8dot" else "torch.matmul")
            + " chain (a yardstick; the port never calls it)",
            **dot_bound(kind, W, n_mm))
        r["tmac_s"] = None if r["device_ms"] is None else \
            macs / r["device_ms"] / 1e9
        log(f"K11 {kind} {'bit-exact' if kind == 'i8dot' else 'within'} "
            f"(err {err:.3g}; [64,32]x[32,{W}], {n_mm} products): "
            f"{r['ms']:.4f} ms a call ({fmt_ms(r['device_ms'])} on the "
            f"device), plain {plain_ms:.4f} ms, library "
            f"{fmt_ms(r['library_ms'])}, bound {r['bound_ms']:.4g} ms")
    # the dots again at every width of DOT_CHECK_W
    t_dot = time.time()
    checked, rng_w = {}, np.random.default_rng(20261021)
    for W_c in DOT_CHECK_W:
        for kind in vr.DOT_KINDS:
            _, (lhs, x0) = vr.make_dot(kind, W_c, n_mm,
                                       *dot_sides(rng_w, kind, W_c),
                                       device=dev)
            want, plain_ms = timed(lambda: vr.dot_chain_plain(kind, lhs, x0,
                                                              n_mm))
            err = dot_error(kind, vr.dot_chain(kind, lhs, x0, n_mm), want)
            checked.setdefault(kind, []).append([W_c, err])
            if W_c in DOT_TIMED_W:
                def fn(kind=kind, lhs=lhs, x0=x0):
                    return vr.dot_chain(kind, lhs, x0, n_mm)
                r = shape_result(
                    results, "K11dot", f"{kind} W={W_c}", W=W_c, n_mm=n_mm,
                    max_abs_err=err, exact=kind == "i8dot",
                    ms=cuda_ms(fn, 20), plain_ms=plain_ms,
                    library_ms=cuda_ms(
                        lambda: dot_library(kind, lhs, x0, n_mm), 20),
                    device_ms=kernel_device_ms(fn, "dot_chain_kernel"),
                    **dot_bound(kind, W_c, n_mm))
                log(f"K11 {kind} at W = {W_c}: {r['ms']:.4f} ms a call "
                    f"({fmt_ms(r['device_ms'])} on the device), plain "
                    f"{plain_ms:.4f} ms, library {r['library_ms']:.4f} ms, "
                    f"bound {r['bound_ms']:.4g} ms")
    results["k11_dot_checks"] = checked
    log(f"K11 dots against their plain versions at W = {list(DOT_CHECK_W)} "
        f"({time.time() - t_dot:.1f} s): i8dot bit-exact, bf16dot within "
        f"{BF16_TOL} of max |acc|: {checked}")

    # K9: variants A, B, C at n = 2^20 (values below p, edge values first),
    # B's chains at 2^18
    F = mv.FQ
    n = 1 << EXP_N_LOG
    timing = lines["exp_mul_variants"]
    sass = {exp_kernel_key(k): r["an_element"] for k, r in exp_report.items()}
    a = limb_rows(rng, n, 0x2FFF, dev, edge=(0, 1, F.p - 1, F.p - 2))
    b = limb_rows(rng, n, 0x2FFF, dev, edge=(F.p - 1, 0, F.p - 1, 1))
    forms = {"B": lambda: mv.mul_limb_major(a, b, F.p),
             "C": lambda: mv.mul_limb_major(a, b, F.p, rolled=True),
             "A": lambda: mv.variant_a(a, b)}
    want, plain_ms = timed(lambda: mv.mul_limb_major_plain(a, b, F.p))
    for name, fn in forms.items():
        err = max_abs_err([fn()], [want])
        require(err == 0, ("K9", name, err))
        r = shape_result(
            results, "K9", name, n=n, max_abs_err=err,
            ms=timing[name]["ms"], plain_ms=plain_ms,
            device_ms=kernel_device_ms(
                fn, "mont_mul_kernel" if name == "A" else "mul16_kernel"),
            **bound(n * MUL_OPS, n * 3 * ROW))
        if name != "A":
            r.update(issue_bound(sass[f"mul16_kernel<{int(name == 'C')}>"][
                name], n, n * 3 * ROW))
        log(f"K9 {name} bit-exact (n={n}): {r['ms']:.4f} ms a call "
            f"({fmt_ms(r['device_ms'])} on the device), plain "
            f"{plain_ms:.4f} ms, bound {r['bound_ms']:.4g} ms"
            + ("" if name == "A" else
               f", issue bound {r['issue_bound_ms']:.4g} ms "
               f"({r['issue_bound_by']})"))
    q = n // 4
    aq, bq = a[:, :q].contiguous(), b[:, :q].contiguous()
    for k in mv.CHAINS:
        def fn(k=k):
            return mv.mul_limb_major(aq, bq, F.p, n_muls=k)
        want, plain_ms = timed(lambda: mv.mul_limb_major_plain(
            aq, bq, F.p, n_muls=k))
        err = max_abs_err([fn()], [want])
        require(err == 0, ("K9 chain", k, err))
        r = shape_result(
            results, "K9", f"B x{k}", n=q, max_abs_err=err,
            ms=timing[f"B x{k}"]["ms"], plain_ms=plain_ms,
            device_ms=kernel_device_ms(fn, "mul16_kernel"),
            **bound(q * k * MUL_OPS, q * 3 * ROW),
            **issue_bound(sass["mul16_kernel<0>"][f"B x{k}"], q, q * 3 * ROW))
        log(f"K9 B chain x{k} bit-exact (n={q}): {r['ms']:.4f} ms a call "
            f"({fmt_ms(r['device_ms'])} on the device), plain "
            f"{plain_ms:.4f} ms, bound {r['bound_ms']:.4g} ms, issue bound "
            f"{r['issue_bound_ms']:.4g} ms ({r['issue_bound_by']})")

    # K10: six variants at B = 2^18 over all 16-bit limbs (the script's
    # timing inputs), and the product variants on the 256 oracle values
    Fr = bn254_fr()
    B = 1 << EXP_B_LOG
    timing = lines["exp_mul_mxu"]
    a = limb_rows(rng, B, 0xFFFF, dev, edge=(0, 1, Fr.p - 1, (1 << 256) - 1))
    b = limb_rows(rng, B, 0xFFFF, dev, edge=(Fr.p - 1, 0, Fr.p - 1,
                                             (1 << 256) - 1))
    a_small, b_small, oracle = mx.oracle_inputs()
    a_small, b_small = a_small.to(dev), b_small.to(dev)
    for variant in mx.VARIANTS:
        def fn(variant=variant):
            return mx.mont_mul_mxu(a, b, variant, Fr.p)
        want, plain_ms = timed(lambda: mx.mont_mul_mxu_plain(
            a, b, variant, Fr.p))
        err = max_abs_err([fn()], [want])
        require(err == 0, ("K10", variant, err))
        if variant in mx.PRODUCTS:
            got = mx.mont_mul_mxu(a_small, b_small, variant, Fr.p)
            require(limbs_to_ints(got.t().contiguous()) == oracle,
                    ("K10 oracle", variant))
        # the product variants' function is the Montgomery product; the
        # ablations' least work is the 256-bit product (mxunocarry's two
        # tensor-core products, 8192 int8 operations an element, take less
        # time at the int8 rate)
        ops = B * (MUL_OPS if variant in mx.PRODUCTS else PRODUCT_OPS)
        r = shape_result(
            results, "K10", variant, B=B, max_abs_err=err,
            ms=timing[variant]["ms"], plain_ms=plain_ms,
            oracle_256=variant in mx.PRODUCTS or None,
            device_ms=kernel_device_ms(fn, "mxu_mul_kernel"),
            **bound(ops, B * 3 * ROW),
            **issue_bound(sass[f"mxu_mul_kernel<{mx.VARIANTS.index(variant)}>"]
                          [""], B, B * 3 * ROW))
        log(f"K10 {variant:10s} bit-exact (B={B}"
            + (", 256 values = oracle" if variant in mx.PRODUCTS else "")
            + f"): {r['ms']:.4f} ms a call ({fmt_ms(r['device_ms'])} on the "
            f"device), plain {plain_ms:.4f} ms, bound {r['bound_ms']:.4g} ms,"
            f" issue bound {r['issue_bound_ms']:.4g} ms "
            f"({r['issue_bound_by']})")
    # K10 at B = 2^20: each variant against its plain version, timed
    Bw = K10_WIDE_B
    a = limb_rows(rng, Bw, 0xFFFF, dev, edge=(0, 1, Fr.p - 1,
                                              (1 << 256) - 1))
    b = limb_rows(rng, Bw, 0xFFFF, dev, edge=(Fr.p - 1, 0, Fr.p - 1,
                                              (1 << 256) - 1))
    for variant in mx.VARIANTS:
        def fn(variant=variant):
            return mx.mont_mul_mxu(a, b, variant, Fr.p)
        want, plain_ms = timed(lambda: mx.mont_mul_mxu_plain(
            a, b, variant, Fr.p))
        err = max_abs_err([fn()], [want])
        require(err == 0, ("K10", variant, Bw, err))
        ops = Bw * (MUL_OPS if variant in mx.PRODUCTS else PRODUCT_OPS)
        r = shape_result(
            results, "K10", f"{variant} B={Bw}", B=Bw, max_abs_err=err,
            ms=cuda_ms(fn, 20), plain_ms=plain_ms,
            device_ms=kernel_device_ms(fn, "mxu_mul_kernel"),
            **bound(ops, Bw * 3 * ROW))
        log(f"K10 {variant:10s} bit-exact (B={Bw}): {r['ms']:.4f} ms a call "
            f"({fmt_ms(r['device_ms'])} on the device), plain "
            f"{plain_ms:.4f} ms, bound {r['bound_ms']:.4g} ms")
    del a, b
    results["experiments_ragged"] = exp_mul_ragged(dev)
    log(f"K9 and K10 bit-exact at ragged sizes: "
        f"{results['experiments_ragged']}")
    return launches


def phase3(dev, srs_dir):
    from zksnap_tpu_torch.curves.fused import ladder_tree, weighted_suffix
    from zksnap_tpu_torch.prover.plonk import keygen, verify
    from zksnap_tpu_torch.prover.srs import gen_srs

    with open(os.path.join(VECTORS, "transcript_v1.json")) as f:
        v = json.load(f)["proof_k7"]
    srs = gen_srs(7, cache_dir=srs_dir, device=dev)
    pk = keygen(build_fixed_circuit(), 7, srs)
    got = vk_digest(pk.vk)
    require(got == v["vk_sha256"], (got, v["vk_sha256"]))
    proof = bytes.fromhex(v["proof_hex"])
    inst = [int(x) for x in v["instances"]]
    require(verify(pk.vk, srs.g2, srs.tau_g2, inst, proof),
            "the frozen K=7 proof does not verify")
    log(f"K=7: vk digest {got[:16]}... equals the frozen JAX digest; "
        "the frozen proof verifies")
    # every K=7 commit is variable-base: with the fused reduction on, the
    # digest holds K5 and K6 to the frozen JAX keygen
    weighted_suffix.launches = ladder_tree.launches = 0
    with fused_reduce("1"):
        fused_pk = keygen(build_fixed_circuit(), 7, srs)
    got = vk_digest(fused_pk.vk)
    launches = (weighted_suffix.launches, ladder_tree.launches)
    require(got == v["vk_sha256"], ("fused", got, v["vk_sha256"]))
    require(min(launches) > 0, ("K5, K6 launches in the fused keygen",
                                launches))
    log(f"K=7 with {FUSED}=1: vk digest equals the frozen JAX digest "
        f"(K5 x{launches[0]}, K6 x{launches[1]})")


@contextlib.contextmanager
def fused_reduce(value: str):
    """ZKSNAP_TPU_FUSED_REDUCE set to `value` inside the block."""
    saved = os.environ.get(FUSED)
    os.environ[FUSED] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(FUSED)
        else:
            os.environ[FUSED] = saved


def phase4(dev, srs_dir, times):
    from zksnap_tpu_torch.circuits.voter import VoterFlags, voter_circuit
    from zksnap_tpu_torch.natives import generate_random_voter_circuit_inputs
    from zksnap_tpu_torch.prover.plonk import keygen, prove, verify
    from zksnap_tpu_torch.prover.srs import gen_srs
    from zksnap_tpu_torch.trace import Context, check

    with open(os.path.join(VECTORS, "torch_port_v1.json")) as f:
        v = json.load(f)["voter_k13"]
    k = v["k"]
    t0 = time.time()
    inp = generate_random_voter_circuit_inputs(random.Random(v["inputs_seed"]))
    ctx = Context(lookup_bits=v["lookup_bits"])
    pub = []
    voter_circuit(ctx, inp, pub, VoterFlags(check_plume=False))
    inst = [c.value for c in pub]
    check(ctx, inst)
    require([str(x) for x in inst] == v["instances"],
            "voter instances differ from the frozen ones")
    times["synthesis_s"] = time.time() - t0

    t0 = time.time()
    srs = gen_srs(k, cache_dir=srs_dir, device=dev)
    torch.cuda.synchronize()
    times["srs_s"] = time.time() - t0
    t0 = time.time()
    pk = keygen(ctx, k, srs)
    torch.cuda.synchronize()
    times["keygen_s"] = time.time() - t0
    got = vk_digest(pk.vk)
    shape = {key: getattr(pk.vk, key) for key in v["vk_shape"]}
    require(shape == v["vk_shape"], (shape, v["vk_shape"]))
    require(got == v["vk_sha256"], (got, v["vk_sha256"]))
    log(f"voter k={k}: vk {shape}; digest {got[:16]}... equals the frozen "
        "JAX digest")

    t0 = time.time()
    proof = prove(pk, inst)
    torch.cuda.synchronize()
    times["prove_cold_s"] = time.time() - t0
    t0 = time.time()
    proof = prove(pk, inst)
    torch.cuda.synchronize()
    times["prove_warm_s"] = time.time() - t0
    t0 = time.time()
    ok = verify(pk.vk, srs.g2, srs.tau_g2, inst, proof)
    times["verify_s"] = time.time() - t0
    require(ok, "voter proof does not verify")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    require(not verify(pk.vk, srs.g2, srs.tau_g2, inst, bytes(bad)),
            "tampered proof accepted")
    log(f"voter k={k}: proof of {len(proof)} bytes verifies; one flipped "
        "byte is rejected")
    log("voter k={k}: synthesis {synthesis_s:.3f} s, SRS {srs_s:.3f} s, "
        "keygen {keygen_s:.3f} s, prove cold {prove_cold_s:.3f} s, warm "
        "{prove_warm_s:.3f} s, verify {verify_s:.3f} s".format(k=k, **times))
    return pk, inst


def srs_under_profiler(make):
    """(make(), its wall seconds, K3's launches over it and the profiler's
    [launches, device ms] of each kind of K3's kernel): a fresh SRS's
    double-and-add is K3's Jacobian dbl and add, a launch each a scalar
    bit and chunk of 2^20 points.  The profiler (device activity only)
    adds its own overhead to the wall seconds."""
    from zksnap_tpu_torch.curves.fused import point

    got = []
    before = point.launches
    wall, by_name = device_time(lambda: got.append(make()))
    kinds = {}
    for name, (count, ms) in by_name.items():
        m = re.search(r"point_kernel<(\d)", name)
        if m:
            c = kinds.setdefault(KIND_NAMES[int(m.group(1))], [0, 0.0])
            c[0] += count
            c[1] += ms
    jac = {"launches": point.launches - before, "device_ms": kinds}
    log(f"SRS: {wall:.3f} s under the profiler; K3 launches "
        f"{jac['launches']}, by kind [launches, device ms]: {kinds}")
    return got[0], wall, jac


def phase_plume(dev, srs_dir, times):
    """The voter circuit with PLUME on at k=21, the reference's default
    voter at its full shape, with the fused reduction on."""
    from zksnap_tpu_torch.circuits.voter import VoterFlags, voter_circuit
    from zksnap_tpu_torch.natives import generate_random_voter_circuit_inputs
    from zksnap_tpu_torch.prover.plonk import keygen, prove, verify
    from zksnap_tpu_torch.prover.srs import gen_srs
    from zksnap_tpu_torch.trace import Context, check

    with open(os.path.join(VECTORS, "torch_port_v1.json")) as f:
        v = json.load(f)["voter_plume_k21"]
    k = v["k"]
    t0 = time.time()
    inp = generate_random_voter_circuit_inputs(random.Random(v["inputs_seed"]))
    ctx = Context(lookup_bits=v["lookup_bits"])
    pub = []
    voter_circuit(ctx, inp, pub, VoterFlags(check_plume=True))
    inst = [c.value for c in pub]
    times["synthesis_s"] = time.time() - t0
    t0 = time.time()
    check(ctx, inst)
    times["check_s"] = time.time() - t0
    stats = {key: int(x) for key, x in ctx.stats().items()
             if isinstance(x, int)}
    require(stats == v["stats"], (stats, v["stats"]))
    require([str(x) for x in inst] == v["instances"],
            "PLUME voter instances differ from the frozen ones")
    log(f"voter k={k} PLUME: {stats['advice_cells']} advice cells, stats and "
        "instances equal the frozen JAX ones")

    srs, times["srs_s"], times["srs_jacobian"] = srs_under_profiler(
        lambda: gen_srs(k, cache_dir=srs_dir, device=dev))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pk = keygen(ctx, k, srs)
    torch.cuda.synchronize()
    times["keygen_s"] = time.time() - t0
    times["keygen_peak_bytes"] = torch.cuda.max_memory_allocated()
    shape = {key: getattr(pk.vk, key) for key in v["vk_shape"]}
    require(shape == v["vk_shape"], (shape, v["vk_shape"]))
    log(f"voter k={k} PLUME: vk {shape} equals the frozen JAX shape")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    proof = prove(pk, inst)
    torch.cuda.synchronize()
    times["prove_cold_s"] = time.time() - t0
    times["prove_peak_bytes"] = torch.cuda.max_memory_allocated()
    t0 = time.time()
    proof = prove(pk, inst)
    torch.cuda.synchronize()
    times["prove_warm_s"] = time.time() - t0
    t0 = time.time()
    ok = verify(pk.vk, srs.g2, srs.tau_g2, inst, proof)
    times["verify_s"] = time.time() - t0
    require(ok, "PLUME voter proof does not verify")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    require(not verify(pk.vk, srs.g2, srs.tau_g2, inst, bytes(bad)),
            "tampered PLUME voter proof accepted")
    log(f"voter k={k} PLUME: proof of {len(proof)} bytes verifies; one "
        "flipped byte is rejected")
    log("voter k={k} PLUME: synthesis {synthesis_s:.3f} s, check {check_s:.3f}"
        " s, SRS {srs_s:.3f} s, keygen {keygen_s:.3f} s (peak {kp:.2f} GB), "
        "prove cold {prove_cold_s:.3f} s (peak {pp:.2f} GB), warm "
        "{prove_warm_s:.3f} s, verify {verify_s:.3f} s; polys at rest in "
        "the int16 form".format(
            k=k, kp=times["keygen_peak_bytes"] / 1e9,
            pp=times["prove_peak_bytes"] / 1e9, **times))
    return srs, pk, inst


def load_script(name: str):
    """scripts/<name>.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_enc(dev, srs_dir, times):
    """The voter circuit with the Paillier encryption check on and PLUME
    off at k=18 (the JAX package's `prove_voter_tpu.py 18 --no-plume
    --enc`) through scripts/prove_voter_torch.py's main: its stats,
    instances and vk shape the frozen JAX ones (21 advice, 3 lookup, 26
    permutation columns, ext 2^3); the proof verifies and a flipped byte
    is rejected; K1-K6's launches over its warm prove (fixed-base
    commits at 2^18: K1-K4 each > 0)."""
    from zksnap_tpu_torch.prover.plonk import verify

    with open(os.path.join(VECTORS, "torch_port_v1.json")) as f:
        v = json.load(f)["voter_enc_k18"]
    k = v["k"]
    out = load_script("prove_voter_torch").main(
        [str(k), "--no-plume", "--enc", "--srs-cache", srs_dir])
    ctx, inst, pk, srs = out["ctx"], out["instances"], out["pk"], out["srs"]
    stats = {key: int(x) for key, x in ctx.stats().items()
             if isinstance(x, int)}
    require(stats == v["stats"], (stats, v["stats"]))
    require([str(x) for x in inst] == v["instances"],
            "Paillier voter instances differ from the frozen ones")
    shape = {key: getattr(pk.vk, key) for key in v["vk_shape"]}
    require(shape == v["vk_shape"], (shape, v["vk_shape"]))
    proof = out["proof"]
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    require(not verify(pk.vk, srs.g2, srs.tau_g2, inst, bytes(bad)),
            "tampered Paillier voter proof accepted")
    st = out["stages"]
    warm = st["prove_warm"][0]
    require(all(warm["launches"][kn] > 0 for kn in ("K1", "K2", "K3", "K4")),
            ("K1-K4 over the Paillier voter's warm prove", warm["launches"]))
    for name in ("witness", "check", "srs", "keygen", "prove", "verify",
                 "prove_warm"):
        times[name] = st[name]
    log(f"voter k={k} Paillier: {stats['advice_cells']} advice cells, stats, "
        f"instances and vk {shape} equal the frozen JAX ones; proof of "
        f"{len(proof)} bytes verifies, one flipped byte is rejected")
    log("voter k={k} Paillier: synthesis {w:.3f} s, check {c:.3f} s, SRS "
        "{s:.3f} s, keygen {kg:.3f} s (peak {kp:.2f} GB), prove cold {pc:.3f}"
        " s (peak {pp:.2f} GB), warm {pw:.3f} s (peak {pwp:.2f} GB), verify "
        "{vf:.3f} s; K1-K6 over the warm prove {ln}".format(
            k=k, w=st["witness"][0]["s"], c=st["check"][0]["s"],
            s=st["srs"][0]["s"], kg=st["keygen"][0]["s"],
            kp=st["keygen"][0]["peak_bytes"] / 1e9,
            pc=st["prove"][0]["s"], pp=st["prove"][0]["peak_bytes"] / 1e9,
            pw=warm["s"], pwp=warm["peak_bytes"] / 1e9,
            vf=st["verify"][0]["s"], ln=warm["launches"]))
    return pk, inst


POLY_K, POLY_EXT = 18, 3  # the Paillier voter's domain and extension
POLY_SMALL_K = 7


@contextlib.contextmanager
def plain_field():
    """Every field operation through K1's and K2's plain versions, on
    whatever device its operands lie: the plain path of a function built
    on the field."""
    from zksnap_tpu_torch.fields import field
    from zksnap_tpu_torch.fields import pallas_mont as pm

    saved = field.mont_mul, field.mont_addsub
    field.mont_mul, field.mont_addsub = pm.mont_mul_plain, pm.mont_addsub_plain
    try:
        yield
    finally:
        field.mont_mul, field.mont_addsub = saved


def poly_five(k: int, dev, seed: int) -> dict:
    """The five poly_device functions the prover does not call, at 2^k
    rows (the coset pair at ext POLY_EXT) on seeded inputs made on the
    host and moved to `dev`: name -> a thunk."""
    from zksnap_tpu_torch.fields import bn254_fr
    from zksnap_tpu_torch.prover import poly_device as pd

    F = bn254_fr()
    n = 1 << k
    vals = random_canonical(n, seed, "cpu").to(dev)
    polys = random_canonical(3 * n, seed + 1, "cpu").reshape(3, n, 16).to(dev)
    base = random_canonical(1, seed + 2, "cpu")[0].to(dev)
    rng = random.Random(seed)
    x = rng.randrange(F.p)
    coefs = [rng.randrange(F.p) for _ in range(3)]
    ext = pd.coset_extended_evals(vals, k, POLY_EXT)
    return {
        "coset_extended_evals": lambda: pd.coset_extended_evals(
            vals, k, POLY_EXT),
        "coset_interpolate": lambda: pd.coset_interpolate(ext, k, POLY_EXT),
        "pow_series_traced": lambda: pd.pow_series_traced(base, n),
        "batch_eval": lambda: pd.batch_eval(polys, x, k),
        "rlc": lambda: pd.rlc(polys, coefs, k)}, vals, ext


def same_result(a, b) -> bool:
    """Two results of a poly function (limb tensors or lists of ints) are
    equal, bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())
    return a == b


def phase_poly_extra(dev, times):
    """poly_device's five functions that the prover does not call: at
    k = POLY_SMALL_K on the card against the CPU; at k = POLY_K (the coset
    pair over 2^21 rows at ext POLY_EXT) against their plain path on the
    card (K1's and K2's plain versions), bit for bit, both timed; the round
    trip against the zero-padded coefficients; coset_interpolate sharded
    over a virtual mesh of MESH_SHARDS x the card against one card."""
    from zksnap_tpu_torch.fields.pallas_mont import mont_addsub, mont_mul
    from zksnap_tpu_torch.prover import poly_device as pd

    small, _, _ = poly_five(POLY_SMALL_K, "cpu", 20261020)
    card, _, _ = poly_five(POLY_SMALL_K, dev, 20261020)
    for name, fn in small.items():
        require(same_result(card[name](), fn()),
                (f"{name} at k={POLY_SMALL_K}: the card against the CPU"))
    fns, vals, ext = poly_five(POLY_K, dev, 20261021)
    for name, fn in fns.items():
        fn()  # its tables made once, as a prover's second call finds them
        before = mont_mul.launches + mont_addsub.launches
        got, ms = timed(fn)
        launches = mont_mul.launches + mont_addsub.launches - before
        with plain_field():
            want, plain_ms = timed(fn)
        require(same_result(got, want),
                (f"{name} at k={POLY_K}: the kernels against the plain path"))
        times[name] = {"ms": ms, "plain_ms": plain_ms,
                       "k1_k2_launches": launches}
    n = 1 << POLY_K
    back = fns["coset_interpolate"]()
    require(torch.equal(back[:n], pd.evals_to_coeffs(vals, POLY_K))
            and not back[n:].any(), "coset_interpolate(coset_extended_evals"
            "(v)) is not v's zero-padded coefficients")
    with pd.prover_mesh(card_mesh([dev] * MESH_SHARDS)):
        require(pd._mesh_for(n << POLY_EXT) is not None,
                "the mesh does not split the extended domain")
        sharded, times["coset_interpolate_sharded_ms"] = timed(
            lambda: pd.coset_interpolate(ext, POLY_K, POLY_EXT))
    require(torch.equal(sharded, back),
            "sharded coset_interpolate differs from one card's")
    log(f"poly_device at k={POLY_K}, ext 2^{POLY_EXT}: the five functions "
        f"bit-exact against their plain path, and at k={POLY_SMALL_K} against "
        "the CPU; the round trip gives the zero-padded coefficients; "
        f"coset_interpolate on a virtual mesh of {MESH_SHARDS} equals one "
        "card's (" + "; ".join(
            f"{k} {v['ms']:.1f} ms, plain {v['plain_ms']:.1f} ms"
            for k, v in times.items() if isinstance(v, dict))
        + f"; sharded interpolate {times['coset_interpolate_sharded_ms']:.1f}"
        " ms)")


def fused_commit_parity(srs, times):
    """One commit of 2^21 seeded scalars over the Lagrange SRS, fused and
    unfused in turns: the same affine point."""
    from zksnap_tpu_torch.curves.jacobian import bn254_ops
    from zksnap_tpu_torch.prover.poly_device import commit_evals

    n = srs.n
    gen = torch.Generator().manual_seed(20261017)
    vals = torch.randint(0, 1 << 16, (n, 16), generator=gen,
                         dtype=torch.int32)
    vals[:, 15] %= 0x3000  # canonical: below the top limb of r
    vals = vals.to(srs.g1.x.device)
    ops = bn254_ops()
    pts, ms = {}, {"1": [], "0": []}
    for mode in ("1", "0", "1", "0"):
        with fused_reduce(mode):
            c, t = timed(lambda: commit_evals(srs.g1_lagrange, vals))
        pts.setdefault(mode, ops.to_affine_host(
            type(c)(c.x[None], c.y[None], c.z[None]))[0])
        ms[mode].append(t)
    require(pts["1"] == pts["0"], "fused and unfused 2^21 commits differ")
    times["commit_fused_ms"] = ms["1"]
    times["commit_unfused_ms"] = ms["0"]
    log(f"2^{srs.k} commit: fused and unfused give the same point; fused "
        f"{ms['1'][0]:.1f}, {ms['1'][1]:.1f} ms, unfused {ms['0'][0]:.1f}, "
        f"{ms['0'][1]:.1f} ms")


def profile_prove(pk, inst, times):
    """Where the warm prove's time goes: device activity under the
    profiler, against the wall time of the same (profiled) prove."""
    from zksnap_tpu_torch.prover.plonk import prove

    wall, by_name = device_time(lambda: prove(pk, inst))
    busy = sum(v[1] for v in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    times["profiled_prove_s"] = wall
    times["device_busy_s"] = busy
    times["device_top"] = dict(top)
    times["k3_to_k6_device"] = {
        k: v for k, v in by_name.items()
        if any(s in k for s in SCAN_KERNELS + ("point_kernel",
                                               "ladder_tree_kernel"))}
    copies = [v for k, v in by_name.items() if "direct_copy" in k]
    times["direct_copy"] = [sum(v[0] for v in copies),
                            sum(v[1] for v in copies)]
    log(f"voter k={pk.vk.k}: warm prove under the profiler {wall:.3f} s, device "
        f"busy {busy:.3f} s ({100 * busy / wall:.1f}%); "
        + ("; ".join(f"{k[:40]} x{v[0]} {v[1]:.1f} ms" for k, v in top)
           if top else "no device activity seen: not measured"))
    log("  PyTorch's direct_copy kernels in it: {} launches, {:.1f} ms".format(
        *times["direct_copy"]))
    log("  K3-K6 in it: " + "; ".join(
        f"{k.split('(')[0]} x{v[0]} {v[1]:.1f} ms"
        for k, v in times["k3_to_k6_device"].items()))


def _subtree(leaves):
    """The native MerkleTree's levels over `leaves` (a worker process's
    share of phase_poseidon's tree)."""
    from zksnap_tpu_torch.natives.merkle import MerkleTree

    return MerkleTree(leaves).tree


def native_tree_levels(leaves, parts: int) -> list:
    """The native MerkleTree's levels over `leaves` (a power of two),
    computed as `parts` subtrees in worker processes and a top tree over
    their roots: the same node hashes in the same places."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    from zksnap_tpu_torch.natives.merkle import MerkleTree

    size = len(leaves) // parts
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(parts, mp_context=ctx) as ex:
        subs = list(ex.map(_subtree, [leaves[i * size:(i + 1) * size]
                                      for i in range(parts)]))
    levels = [sum((t[j] for t in subs), []) for j in range(len(subs[0]))]
    return levels[:-1] + MerkleTree(levels[-1]).tree


def phase_poseidon(dev, times, n: int = 1 << 16):
    """Poseidon's batched path on the card: hash_fixed_batched over n pairs
    (the shape of scripts/bench_kernels.py:62) against hash_fixed_native
    on a seeded sample of rows; the frozen permutation and sponge vectors
    (tests/vectors/transcript_v1.json); build_tree_device over n leaves
    against the native MerkleTree's levels and root."""
    from zksnap_tpu_torch.fields.field import bn254_fr
    from zksnap_tpu_torch.hash import (default_spec, hash_fixed_batched,
                                       hash_fixed_native)
    from zksnap_tpu_torch.natives.merkle import build_tree_device

    F = bn254_fr()
    rng = random.Random(20261018)
    vals = [rng.randrange(F.p) for _ in range(2 * n)]
    x = F.to_mont(vals, device=dev).reshape(n, 2, 16)
    h, ms = timed(lambda: hash_fixed_batched(x))
    times["hash_2^16_ms"] = ms
    h = h.cpu()
    rows = rng.sample(range(n), 64)
    for i in rows:
        require(F.from_mont(h[i]) == hash_fixed_native(vals[2 * i:2 * i + 2]),
                ("hash_fixed_batched row", i))
    with open(os.path.join(VECTORS, "transcript_v1.json")) as f:
        v = json.load(f)
    perm = v["poseidon_permute"]
    st = F.to_mont([int(a) for a in perm["in"]], device=dev)
    got = F.from_mont(default_spec().permute(st[None])[0])
    require([str(a) for a in got] == perm["out"], "frozen permutation")
    sp = v["poseidon_sponge"]
    for upd, want in zip(sp["updates"], sp["squeezes"]):
        xs = F.to_mont([int(u) for u in upd], device=dev)[None]
        require(str(F.from_mont(hash_fixed_batched(xs)[0])) == want,
                ("frozen sponge", upd))
    log(f"Poseidon: hash_fixed_batched over {n} pairs {ms:.1f} ms; 64 "
        "sampled rows equal hash_fixed_native; the frozen permutation and "
        "sponge vectors hold")
    leaves = vals[:n]
    leaves_dev = F.to_mont(leaves, device=dev)
    lv, ms = timed(lambda: build_tree_device(leaves_dev))
    times["tree_2^16_ms"] = ms
    t0 = time.time()
    want = native_tree_levels(leaves, 8)
    times["native_tree_s"] = time.time() - t0
    got = [F.from_mont(t.reshape(-1, 16)) for t in lv]
    got = [g if isinstance(g, list) else [g] for g in got]
    require(got == want, "build_tree_device levels differ from the native "
            "MerkleTree's")
    log(f"Poseidon: build_tree_device over {n} leaves {ms:.1f} ms, "
        f"{len(lv)} levels and the root equal the native MerkleTree's "
        f"(native {times['native_tree_s']:.1f} s in 8 processes)")


def fixed_base_commit_2p21(srs, times):
    """One 2^21 commit through the fixed-base path, enabled up to 2^21
    (configure_fixed_base), against the fused variable-base commit of the
    same scalars: the same point; the table's build and both commits
    timed, twice each; the JAX defaults restored after."""
    from zksnap_tpu_torch.curves.jacobian import bn254_ops
    from zksnap_tpu_torch.prover import poly_device
    from zksnap_tpu_torch.prover.poly_device import (commit_evals,
                                                     configure_fixed_base)

    n = srs.n
    gen = torch.Generator().manual_seed(20261018)
    vals = torch.randint(0, 1 << 16, (n, 16), generator=gen,
                         dtype=torch.int32)
    vals[:, 15] %= 0x3000
    vals = vals.to(srs.g1.x.device)
    ops = bn254_ops()

    def affine(c):
        return ops.to_affine_host(type(c)(c.x[None], c.y[None], c.z[None]))[0]

    with fused_reduce("1"):
        fused = [timed(lambda: commit_evals(srs.g1_lagrange, vals))
                 for _ in range(2)]
    configure_fixed_base(enabled=True, max_n=n)
    try:
        _, build_ms = timed(lambda: poly_device._fb_table(srs.g1_lagrange, n))
        fixed = [timed(lambda: commit_evals(srs.g1_lagrange, vals))
                 for _ in range(2)]
    finally:
        configure_fixed_base(enabled=True, max_n=1 << 20, c=16)
    require(affine(fixed[0][0]) == affine(fused[0][0]),
            "fixed-base and fused 2^21 commits differ")
    times["commit_2p21_fixed_base_ms"] = [t for _, t in fixed]
    times["commit_2p21_fused_ms"] = [t for _, t in fused]
    times["fixed_base_table_2p21_ms"] = build_ms
    log(f"2^{srs.k} commit: fixed-base (table built in {build_ms:.1f} ms) "
        f"{fixed[0][1]:.1f}, {fixed[1][1]:.1f} ms; fused variable-base "
        f"{fused[0][1]:.1f}, {fused[1][1]:.1f} ms; the same point")


# -- the mesh: a virtual mesh (one card named MESH_SHARDS times) and, where
# the machine has them, distinct cards ---------------------------------------

MESH_SHARDS = 4
MESH_SEED = 20261019   # the rng of the seeded proofs compared across meshes
NTT_CHECK_K = (21, 23)


def synced(fn):
    """(fn(), its wall seconds) with every CUDA device synchronised before
    and after: the time of work that may span several cards."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    t0 = time.time()
    out = fn()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return out, time.time() - t0


def card_mesh(devices):
    from zksnap_tpu_torch.parallel import make_mesh

    return make_mesh((len(devices),), ("x",), devices)


def random_canonical(n: int, seed: int, dev):
    """n seeded rows of 16-bit limbs below Fr's modulus (canonical scalars,
    or Montgomery representatives of field elements)."""
    gen = torch.Generator().manual_seed(seed)
    vals = torch.randint(0, 1 << 16, (n, 16), generator=gen,
                         dtype=torch.int32)
    vals[:, 15] %= 0x3000  # below the top limb of r
    return vals.to(dev)


def phase_mesh_k7(dev, srs_dir, times):
    """K=7 on a virtual mesh of MESH_SHARDS x the card (n = 128 >= 4^2, so
    every commit and NTT is sharded): keygen gives the frozen JAX vk
    digest, and a proof seeded as the frozen JAX proof has its bytes."""
    from zksnap_tpu_torch.prover.plonk import keygen, prove
    from zksnap_tpu_torch.prover.srs import gen_srs

    with open(os.path.join(VECTORS, "transcript_v1.json")) as f:
        digest = json.load(f)["proof_k7"]["vk_sha256"]
    with open(os.path.join(VECTORS, "torch_port_v1.json")) as f:
        sp = json.load(f)["seeded_proof_k7"]
    mesh = card_mesh([dev] * MESH_SHARDS)
    srs = gen_srs(7, cache_dir=srs_dir, device=dev)
    pk, times["keygen_s"] = synced(
        lambda: keygen(build_fixed_circuit(), 7, srs, mesh=mesh))
    require(vk_digest(pk.vk) == digest, ("K=7 on a virtual mesh",
                                         vk_digest(pk.vk), digest))
    proof, times["prove_s"] = synced(lambda: prove(
        pk, [int(x) for x in sp["instances"]], random.Random(sp["rng_seed"]),
        mesh=mesh))
    require(proof.hex() == sp["proof_hex"],
            "the seeded K=7 proof on a virtual mesh is not the frozen JAX one")
    log(f"K=7 on a virtual mesh of {MESH_SHARDS} x {dev}: vk digest and the "
        f"seeded proof's {len(proof)} bytes equal the frozen JAX ones "
        f"(keygen {times['keygen_s']:.3f} s, prove {times['prove_s']:.3f} s)")


def mesh_prove(pk, inst, mesh, times):
    """On `mesh`: a first sharded prove, then a warm one seeded with
    MESH_SEED, timed with each card's peak memory; it verifies and one
    flipped byte is rejected.  Returns the seeded proof."""
    from zksnap_tpu_torch.prover.plonk import prove, verify

    srs = pk.srs
    _, times["prove_first_s"] = synced(lambda: prove(pk, inst, mesh=mesh))
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)
    proof, times["prove_warm_s"] = synced(
        lambda: prove(pk, inst, random.Random(MESH_SEED), mesh=mesh))
    times["prove_peak_bytes"] = [torch.cuda.max_memory_allocated(i)
                                 for i in range(torch.cuda.device_count())]
    require(verify(pk.vk, srs.g2, srs.tau_g2, inst, proof),
            "the sharded proof does not verify")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    require(not verify(pk.vk, srs.g2, srs.tau_g2, inst, bytes(bad)),
            "a tampered sharded proof is accepted")
    log(f"k={pk.vk.k} on {mesh}: first sharded prove "
        f"{times['prove_first_s']:.3f} s, warm {times['prove_warm_s']:.3f} s "
        f"(peak {max(times['prove_peak_bytes']) / 1e9:.2f} GB); the proof "
        "verifies, one flipped byte is rejected")
    return proof


def mesh_parity(srs, pk, inst, mesh, proof, times):
    """On `mesh` against one card: a 2^k commit (as points), the
    four-step NTT at 2^21 and 2^23 both ways against the single-device
    NTT (bit for bit), and `proof` (seeded with MESH_SEED) against an
    unsharded proof with the same seed (byte for byte); all timed."""
    from zksnap_tpu_torch.curves.jacobian import bn254_ops
    from zksnap_tpu_torch.fields import bn254_fr
    from zksnap_tpu_torch.poly.domain import domain
    from zksnap_tpu_torch.poly.ntt import (_ntt_impl, four_step_input_perm,
                                           four_step_ntt,
                                           four_step_output_perm)
    from zksnap_tpu_torch.prover.plonk import prove
    from zksnap_tpu_torch.prover.poly_device import commit_evals, prover_mesh

    ops = bn254_ops()
    home = srs.g1.x.device
    ndev = mesh.shape["x"]

    def affine(c):
        return ops.to_affine_host(type(c)(c.x[None], c.y[None], c.z[None]))[0]

    vals = random_canonical(srs.n, 20261017, home)
    one, t_one = synced(lambda: commit_evals(srs.g1_lagrange, vals))
    with prover_mesh(mesh):
        sharded = [synced(lambda: commit_evals(srs.g1_lagrange, vals))
                   for _ in range(2)]
    require(all(affine(c) == affine(one) for c, _ in sharded),
            "the sharded commit differs from the single-device one")
    times["commit_one_card_s"] = t_one
    times["commit_sharded_s"] = [t for _, t in sharded]

    F = bn254_fr()
    ntt_times = {}
    for k in NTT_CHECK_K:
        x = random_canonical(1 << k, 20261020 + k, home)
        inp = torch.from_numpy(four_step_input_perm(k, ndev)).to(home)
        outp = torch.from_numpy(four_step_output_perm(k, ndev)).to(home)
        for inverse in (False, True):
            dom = domain(k)
            tw = dom.twiddles_inv(home) if inverse else dom.twiddles(home)
            # each twice: the first call also builds the cached tables
            singles = [synced(lambda: _ntt_impl(x, tw, k, F))
                       for _ in range(2)]
            want = singles[0][0]
            runs = [synced(lambda: four_step_ntt(x[inp], k, mesh,
                                                 inverse=inverse)[outp])
                    for _ in range(2)]
            require(all(torch.equal(got, want) for got, _ in runs),
                    ("four-step NTT differs", k, inverse))
            ntt_times[f"{k}_{'inverse' if inverse else 'forward'}"] = {
                "one_card_s": [t for _, t in singles],
                "four_step_s": [t for _, t in runs]}
            del want, runs, singles
        del x
    times["ntt"] = ntt_times

    plain, times["prove_one_card_s"] = synced(
        lambda: prove(pk, inst, random.Random(MESH_SEED)))
    require(plain == proof, "the seeded sharded proof differs from the "
            "seeded single-device proof")
    log(f"k={pk.vk.k} on {mesh}: the 2^{srs.k} commit equals the "
        f"single-device one ({1e3 * t_one:.1f} ms; sharded "
        + ", ".join(f"{1e3 * t:.1f}" for t in times["commit_sharded_s"])
        + " ms); the four-step NTT equals the single-device NTT at 2^"
        + " and 2^".join(map(str, NTT_CHECK_K)) + ", both ways ("
        + "; ".join(f"2^{key}: "
                    + ", ".join(f"{t * 1e3:.1f}" for t in v["one_card_s"])
                    + " ms one card, "
                    + ", ".join(f"{t * 1e3:.1f}" for t in v["four_step_s"])
                    + " ms four-step" for key, v in ntt_times.items())
        + "); the seeded sharded proof equals the single-device one "
        f"(that one {times['prove_one_card_s']:.3f} s)")


def check_last_card(times):
    """K1 and K3 (padd) on the last card alone, against their plain
    versions there: the kernels launch on their operands' device."""
    from zksnap_tpu_torch.curves import fused
    from zksnap_tpu_torch.curves.native import BN254_G1
    from zksnap_tpu_torch.fields import bn254_fq, bn254_fr
    from zksnap_tpu_torch.fields import pallas_mont as pm

    last = torch.device("cuda", torch.cuda.device_count() - 1)
    rng = random.Random(20261021)
    F = bn254_fr()
    a, b = field_inputs(F, 8192, rng, last)
    got = pm.mont_mul(a, b, F.p)
    require(got.device == last and torch.equal(
        got, pm.mont_mul_plain(a, b, F.p)), ("K1 on", last))
    Fq = bn254_fq()
    P, Qg, _ = point_inputs(BN254_G1, Fq, 8192, rng, last, False)
    got = fused.point("padd", list(P + Qg), Fq.p, 3 * BN254_G1.b)
    want = fused.point_plain("padd", list(P + Qg), Fq.p, 3 * BN254_G1.b)
    require(all(g.device == last and torch.equal(g, w)
                for g, w in zip(got, want)), ("K3 on", last))
    times["last_card"] = str(last)
    log(f"K1 and K3 on {last} alone: bit-exact against their plain versions")


def distinct_cards() -> list:
    """The first 2, or 4, of the visible cards (the largest power of two
    up to 4)."""
    count = min(torch.cuda.device_count(), MESH_SHARDS)
    ndev = 1 << (count.bit_length() - 1)
    return [torch.device("cuda", i) for i in range(ndev)]


def mesh_scaling(srs, times):
    """scaling_efficiency of the 2^k commit and the four-step 2^23 NTT over
    1, 2 and 4 distinct cards (1 card: the single-device path)."""
    from zksnap_tpu_torch.fields import bn254_fr
    from zksnap_tpu_torch.parallel import scaling_efficiency
    from zksnap_tpu_torch.poly.domain import domain
    from zksnap_tpu_torch.poly.ntt import _ntt_impl, four_step_ntt
    from zksnap_tpu_torch.prover.poly_device import commit_evals, prover_mesh

    cards = distinct_cards()
    sizes = [n for n in (1, 2, 4) if n <= len(cards)]
    home = srs.g1.x.device
    vals = random_canonical(srs.n, 20261017, home)
    k = NTT_CHECK_K[-1]
    x = random_canonical(1 << k, 20261020 + k, home)
    F = bn254_fr()

    def commit(n, mesh):
        with prover_mesh(mesh):
            synced(lambda: commit_evals(srs.g1_lagrange, vals))

    def ntt(n, mesh):
        if n == 1:
            synced(lambda: _ntt_impl(x, domain(k).twiddles(home), k, F))
        else:
            synced(lambda: four_step_ntt(x, k, mesh))

    def mesh_for(n):
        return card_mesh(cards[:n])

    times["scaling_commit"] = scaling_efficiency(commit, sizes, mesh_for)
    times["scaling_ntt"] = scaling_efficiency(ntt, sizes, mesh_for)
    for name in ("commit", "ntt"):
        log(f"scaling_efficiency, {name}: " + "; ".join(
            f"{r['n']} card(s) {r['seconds'] * 1e3:.1f} ms, efficiency "
            f"{r['efficiency']:.3f}" for r in times["scaling_" + name]))


def phase_mesh_k21(dev, srs, pk, inst, path, times):
    """The k=21 key on a virtual mesh of MESH_SHARDS x `dev` (the sharded
    prove driven through `path`, which counts its launches), then the
    same on distinct cards when the machine has two or more: first K1
    and K3 on the last card alone, then the mesh over the first 2 or 4
    cards and the scaling of its commit and NTT."""
    needs = ("K1", "K2", "K3", "K4", "K5", "K6")
    virtual = times.setdefault("virtual", {})
    vmesh = card_mesh([dev] * MESH_SHARDS)
    proof = path(f"PLUME voter k={pk.vk.k} on a virtual mesh",
                 lambda: mesh_prove(pk, inst, vmesh, virtual), needs)
    mesh_parity(srs, pk, inst, vmesh, proof, virtual)
    phase_mesh_cards(srs, pk, inst, path, times)


def phase_mesh_cards(srs, pk, inst, path, times):
    """With two or more cards: K1 and K3 on the last card alone, then the
    k=21 checks of phase_mesh_k21 over the first 2 or 4 cards and the
    scaling of their commit and NTT; with one card, a line that says
    they did not run."""
    needs = ("K1", "K2", "K3", "K4", "K5", "K6")
    if torch.cuda.device_count() < 2:
        log("mesh over distinct cards: not run (1 device)")
        times["cards"] = "not run (1 device)"
        return
    cards = times.setdefault("cards", {})
    check_last_card(cards)
    cmesh = card_mesh(distinct_cards())
    proof = path(f"PLUME voter k={pk.vk.k} on {len(cmesh.device_list())} "
                 "cards", lambda: mesh_prove(pk, inst, cmesh, cards), needs)
    mesh_parity(srs, pk, inst, cmesh, proof, cards)
    mesh_scaling(srs, cards)


_WARM_CHILD = r"""
import json, random, sys, time
import torch
from zksnap_tpu_torch.circuits.voter import VoterFlags, voter_circuit
from zksnap_tpu_torch.natives import generate_random_voter_circuit_inputs
from zksnap_tpu_torch.prover.plonk import keygen, prove, verify
from zksnap_tpu_torch.prover.srs import gen_srs
from zksnap_tpu_torch.prover.warmup import warm_prove
from zksnap_tpu_torch.trace import Context

warm, srs_dir, seed, lookup_bits, k = (sys.argv[1] == "warm", sys.argv[2],
                                       int(sys.argv[3]), int(sys.argv[4]),
                                       int(sys.argv[5]))
t_start = time.time()
ctx = Context(lookup_bits=lookup_bits)
pub = []
voter_circuit(ctx, generate_random_voter_circuit_inputs(random.Random(seed)),
              pub, VoterFlags(check_plume=False))
inst = [c.value for c in pub]
srs = gen_srs(k, cache_dir=srs_dir)
torch.cuda.synchronize()
out = {"setup_s": time.time() - t_start}
if warm:
    t0 = time.time()
    out["warm_tasks_s"] = warm_prove(ctx, k)
    out["warm_prove_s"] = time.time() - t0
t0 = time.time()
pk = keygen(ctx, k, srs)
torch.cuda.synchronize()
out["keygen_s"] = time.time() - t0
t0 = time.time()
proof = prove(pk, inst)
torch.cuda.synchronize()
out["first_prove_s"] = time.time() - t0
out["verifies"] = verify(pk.vk, srs.g2, srs.tau_g2, inst, proof)
print(json.dumps(out))
"""


def phase_warm_prove(work, times):
    """warm_prove's effect on a first proof: two child processes on the
    kernel library already built, the voter at k=13 (its SRS already in
    `work`): one runs warm_prove, then keygen and the first prove; the
    other keygen and the first prove alone."""
    with open(os.path.join(VECTORS, "torch_port_v1.json")) as f:
        v = json.load(f)["voter_k13"]
    for mode in ("warm", "cold"):
        res = subprocess.run(
            [sys.executable, "-c", _WARM_CHILD, mode, work,
             str(v["inputs_seed"]), str(v["lookup_bits"]), str(v["k"])],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        require(res.returncode == 0, ("warm_prove child", mode,
                                      res.stderr[-2000:]))
        times[mode] = json.loads(res.stdout.strip().splitlines()[-1])
        require(times[mode]["verifies"], ("warm_prove child", mode))
    warm, cold = times["warm"], times["cold"]
    log("warm_prove, voter k={k}: tasks {tasks} ({total:.3f} s); then keygen "
        "{wk:.3f} s, first prove {wp:.3f} s; without it keygen {ck:.3f} s, "
        "first prove {cp:.3f} s".format(
            k=v["k"], total=warm["warm_prove_s"], wk=warm["keygen_s"],
            wp=warm["first_prove_s"], ck=cold["keygen_s"],
            cp=cold["first_prove_s"], tasks=", ".join(
                f"{name} {s:.3f} s" for name, s in warm["warm_tasks_s"].items())))


def phase_lazy_k7(dev, srs_dir, times):
    """The K=7 keygen with its fixed columns lazy (the threshold forced to
    0): the frozen JAX vk digest; the key saved with save_pk and loaded
    back proves, seeded as the frozen JAX proof, the same bytes, and the
    proof verifies."""
    from zksnap_tpu_torch.prover import plonk
    from zksnap_tpu_torch.prover.serialize import load_pk, save_pk
    from zksnap_tpu_torch.prover.srs import gen_srs

    with open(os.path.join(VECTORS, "torch_port_v1.json")) as f:
        v = json.load(f)["seeded_proof_k7"]
    srs = gen_srs(7, cache_dir=srs_dir, device=dev)
    saved = plonk.LAZY_FIXED_BYTES
    plonk.LAZY_FIXED_BYTES = 0
    try:
        t0 = time.time()
        pk = plonk.keygen(build_fixed_circuit(), 7, srs)
        times["lazy_keygen_s"] = time.time() - t0
    finally:
        plonk.LAZY_FIXED_BYTES = saved
    require(isinstance(pk.fixed_coeffs, plonk.LazyFixedCoeffs),
            "the forced K=7 keygen is not lazy")
    require(vk_digest(pk.vk) == v["vk_sha256"], "lazy K=7 vk digest")
    path = os.path.join(srs_dir, "lazy_k7.pk")
    save_pk(pk, path)
    again = load_pk(path)
    inst = [int(a) for a in v["instances"]]
    t0 = time.time()
    proof = plonk.prove(again, inst, random.Random(v["rng_seed"]))
    times["lazy_prove_s"] = time.time() - t0
    require(proof.hex() == v["proof_hex"],
            "the reloaded lazy key's proof differs from the frozen JAX proof")
    require(plonk.verify(again.vk, srs.g2, srs.tau_g2, inst, proof),
            "the reloaded lazy key's proof does not verify")
    log(f"K=7 lazy: keygen {times['lazy_keygen_s']:.3f} s, vk digest the "
        "frozen JAX one; saved, loaded, proved "
        f"({times['lazy_prove_s']:.3f} s): the frozen JAX proof's bytes, "
        "verifies")


def phase_wrapper_toy(work, times, rounds: int = 2):
    """The wrapper circuit at scripts/prove_wrapper_tpu.py --toy's shape
    through scripts/prove_wrapper_torch.py (main(["2", "18", "--toy"])): the children's
    vk digests and the solved shape the frozen JAX ones; each round's
    wrapper proof verifies with the port's host verifier, a flipped byte
    fails, and its instance rows outside the accumulator limbs (12 and
    up) equal wrapper_native's.  The decide is skipped, as the JAX --toy
    path skips it: truncated MSMs are unsound by design."""
    import dataclasses

    from zksnap_tpu_torch.prover.plonk import verify

    with open(os.path.join(VECTORS, "torch_port_v1.json")) as f:
        v = json.load(f)["wrapper_toy"]
    out = load_script("prove_wrapper_torch").main([str(rounds), str(v["k_wrap"]), "--toy",
                              "--cache", os.path.join(work, "wrapper")])
    cfg, srs = out["cfg"], out["srs"]
    vvk, svk = out["child_vks"]
    require((vk_digest(vvk), vk_digest(svk))
            == (v["voter_vk_sha256"], v["state_vk_sha256"]),
            "toy child vk digests")
    require(dataclasses.asdict(cfg.shape) == v["shape"],
            ("toy wrapper shape", cfg.shape, v["shape"]))
    for r, (snark, native) in enumerate(zip(out["snarks"], out["natives"])):
        inst, proof = snark.instances, snark.proof
        require(verify(snark.vk, srs.g2, srs.tau_g2, inst, proof),
                ("toy wrapper proof does not verify", r))
        bad = bytearray(proof)
        bad[len(bad) // 2] ^= 1
        require(not verify(snark.vk, srs.g2, srs.tau_g2, inst, bytes(bad)),
                ("tampered toy wrapper proof accepted", r))
        require(inst[12:] == native[12:] and inst[-1] == r,
                ("toy wrapper rows 12+ differ from wrapper_native's", r))
    require(out["decide"] is None, "the toy path runs no decide")
    times["stages"] = out["stages"]
    times["commit_path"] = out["commit_path"]
    log(f"wrapper toy: shape {cfg.shape} the frozen JAX one; {rounds} rounds "
        "proved, each verifies and a flipped byte does not, rows 12+ equal "
        "wrapper_native's; decide skipped (truncated MSMs are unsound by "
        "design)")


def phase_ceremony_srs(dev, work, times, k: int = 15):
    """A ceremony-format SRS at k=15: the dev SRS written by save_srs,
    read back by load_srs (curve checks on the card, the G2 checks, the
    pairing sanity check and the Lagrange-sum tree of K3 adds), the same
    points; a file with one flipped G1 byte is refused."""
    from zksnap_tpu_torch.prover.srs import (_lagrange_sum_check, gen_srs,
                                             load_srs, save_srs,
                                             srs_sanity_check)

    t0 = time.time()
    srs = gen_srs(k, cache_dir=work, device=dev)
    torch.cuda.synchronize()
    times["gen_s"] = time.time() - t0
    path = os.path.join(work, f"kzg_bn254_{k}.srs")
    t0 = time.time()
    save_srs(srs, path)
    times["save_s"] = time.time() - t0
    t0 = time.time()
    back = load_srs(path, device=dev)
    torch.cuda.synchronize()
    times["load_s"] = time.time() - t0
    require(back.k == k and (back.g2, back.tau_g2) == (srs.g2, srs.tau_g2),
            "reloaded SRS G2 points differ")
    for a, b in ((back.g1, srs.g1), (back.g1_lagrange, srs.g1_lagrange)):
        require(all(torch.equal(u, w) for u, w in (
            (a.x, b.x), (a.y, b.y), (a.z, b.z))), "reloaded G1 points differ")
    t0 = time.time()
    require(srs_sanity_check(back), "pairing sanity check failed")
    times["sanity_s"] = time.time() - t0
    t0 = time.time()
    require(_lagrange_sum_check(back), "Lagrange-sum check failed")
    torch.cuda.synchronize()
    times["lagrange_sum_s"] = time.time() - t0
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[4 + 64 + 3] ^= 1  # x of [tau]G1
    bad = os.path.join(work, "corrupt.srs")
    with open(bad, "wb") as f:
        f.write(bytes(data))
    try:
        load_srs(bad, device=dev)
    except ValueError as e:
        times["corrupt_error"] = str(e)
    require("corrupt_error" in times, "a corrupted SRS file was accepted")
    log(f"ceremony SRS k={k}: {len(data)} bytes; gen {times['gen_s']:.3f} s, "
        f"save {times['save_s']:.3f} s, load with both checks "
        f"{times['load_s']:.3f} s (sanity {times['sanity_s']:.3f} s, "
        f"Lagrange sum {times['lagrange_sum_s']:.3f} s); same points; one "
        f"flipped G1 byte refused ({times['corrupt_error']})")


def phase_protocol(dev, times, rounds: int = 2, k: int = 13):
    """scripts/protocol_demo.py at its defaults on the port: per round a
    voter proof (PLUME off) and a state-transition proof, keys made once
    and rebound, each proof succinctly verified and folded by
    RecursionChain; one pairing decides the chain."""
    from zksnap_tpu_torch.circuits.state_transition import (
        expected_instances as st_expected, state_transition_circuit)
    from zksnap_tpu_torch.circuits.voter import (
        VoterFlags, expected_instances as voter_expected, voter_circuit)
    from zksnap_tpu_torch.natives import generate_wrapper_circuit_input
    from zksnap_tpu_torch.prover import (RecursionChain, Snark, gen_srs,
                                         keygen, prove, rebind_witness)
    from zksnap_tpu_torch.trace import Context, check

    rng = random.Random(20260817)
    t0 = time.time()
    voter_inputs, state_inputs = generate_wrapper_circuit_input(rounds, rng)
    times["inputs_s"] = time.time() - t0
    srs = gen_srs(k, device=dev)
    chain = RecursionChain(srs.g2, srs.tau_g2)
    pks = {}
    for rnd in range(rounds):
        t0 = time.time()
        vctx, vpub = Context(lookup_bits=min(14, k - 1)), []
        voter_circuit(vctx, voter_inputs[rnd], vpub,
                      VoterFlags(check_plume=False))
        check(vctx, voter_expected(voter_inputs[rnd]))
        sctx, spub = Context(lookup_bits=min(14, k - 1)), []
        state_transition_circuit(sctx, state_inputs[rnd], spub)
        check(sctx, st_expected(state_inputs[rnd]))
        times[f"round{rnd}_witness_s"] = time.time() - t0
        if not pks:
            t0 = time.time()
            pks["voter"] = keygen(vctx, k, srs)
            pks["state"] = keygen(sctx, k, srs)
            torch.cuda.synchronize()
            times["keygen_s"] = time.time() - t0
            # the circuit's structure does not depend on its inputs
            with open(os.path.join(VECTORS, "torch_port_v1.json")) as f:
                want = json.load(f)[f"state_k{k}"]["vk_sha256"]
            require(vk_digest(pks["state"].vk) == want,
                    ("protocol state-transition vk digest",
                     vk_digest(pks["state"].vk), want))
        vpk = rebind_witness(pks["voter"], vctx)
        spk = rebind_witness(pks["state"], sctx)
        vinst, sinst = [c.value for c in vpub], [c.value for c in spub]
        t0 = time.time()
        vproof = prove(vpk, vinst)
        sproof = prove(spk, sinst)
        torch.cuda.synchronize()
        times[f"round{rnd}_proofs_s"] = time.time() - t0
        t0 = time.time()
        chain.add_round(Snark(vpk.vk, vinst, vproof),
                        Snark(spk.vk, sinst, sproof))
        times[f"round{rnd}_accumulate_s"] = time.time() - t0
        log(f"protocol round {rnd}: witnesses "
            f"{times[f'round{rnd}_witness_s']:.3f} s, voter + state proofs "
            f"{times[f'round{rnd}_proofs_s']:.3f} s, accumulated "
            f"{times[f'round{rnd}_accumulate_s']:.3f} s")
    t0 = time.time()
    ok = chain.finalize()
    times["decide_s"] = time.time() - t0
    require(ok, "the protocol chain's final pairing failed")
    log(f"protocol k={k}: {rounds} rounds, {2 * rounds} proofs folded, "
        f"keygen (voter + state) {times['keygen_s']:.3f} s, the state "
        f"transition's vk digest equals the frozen JAX one; finalize() True "
        f"in {times['decide_s']:.3f} s")


def _http(url, obj=None):
    """GET (obj None) or POST obj as JSON: (status, decoded body)."""
    import urllib.error
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data,
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_server(dev, times):
    """The proving service in this process on a free port: /health, the
    voter at k=13 (seed 3) proved and verified, a tampered proof and an
    unknown circuit refused, and a second (warm) prove."""
    import threading

    from zksnap_tpu_torch import server

    httpd = server.make_server(0, device=dev)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, health = _http(url + "/health")
        require(code == 200 and health["status"] == "ok", health)
        t0 = time.time()
        code, out = _http(url + "/prove", {"circuit": "voter", "k": 13,
                                           "seed": 3})
        times["prove_first_s"] = time.time() - t0  # keygen included
        require(code == 200 and len(out["instances"]) == 30, (code, out))
        req = {"circuit": "voter", "k": 13, "proof": out["proof"],
               "instances": out["instances"]}
        code, chk = _http(url + "/verify", req)
        require(code == 200 and chk["valid"] is True, chk)
        bad = bytearray(bytes.fromhex(out["proof"]))
        bad[40] ^= 1
        code, chk = _http(url + "/verify", dict(req, proof=bytes(bad).hex()))
        require(code == 200 and chk["valid"] is False, chk)
        code, err = _http(url + "/prove", {"circuit": "nope"})
        require(code == 400, (code, err))
        t0 = time.time()
        code, out = _http(url + "/prove", {"circuit": "voter", "k": 13,
                                           "seed": 4})
        times["prove_warm_request_s"] = time.time() - t0
        times["prove_warm_ms"] = out["ms"]
        code, chk = _http(url + "/verify", dict(
            req, proof=out["proof"], instances=out["instances"]))
        require(code == 200 and chk["valid"] is True, chk)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    log(f"server: /health ok; voter k=13 proved (first request with keygen "
        f"{times['prove_first_s']:.3f} s), verified, tampered proof and "
        f"unknown circuit refused; warm /prove {times['prove_warm_ms']} ms "
        f"({times['prove_warm_request_s']:.3f} s a request)")


def phase_cli(work, times):
    """The state-transition circuit at k=15 through `python -m
    zksnap_tpu_torch.cli` in child processes on the card: keygen, prove,
    verify exit 0, the vk digest and the instances are the frozen JAX
    ones, and verify exits 1 on a proof with one flipped byte."""
    import re

    from zksnap_tpu_torch.prover import load_vk

    with open(os.path.join(VECTORS, "torch_port_v1.json")) as f:
        v = json.load(f)["state_k15"]
    out = os.path.join(work, "cli")
    common = ["--circuit", "state_transition", "--k", str(v["k"]),
              "--seed", str(v["inputs_seed"])]

    def run(name, *args):
        t0 = time.time()
        res = subprocess.run(
            [sys.executable, "-m", "zksnap_tpu_torch.cli", *args], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        times[f"{name}_s"] = time.time() - t0
        inner = re.search(r"^(?:keygen|prove) ([0-9.]+)s$", res.stderr, re.M)
        if inner:
            times[f"{name}_inner_s"] = float(inner.group(1))
        return res

    res = run("keygen", "keygen", *common, "--out", out)
    require(res.returncode == 0, ("cli keygen", res.stderr[-2000:]))
    vk = load_vk(os.path.join(out, "state_transition_vk.bin"))
    shape = {key: getattr(vk, key) for key in v["vk_shape"]}
    require(shape == v["vk_shape"], (shape, v["vk_shape"]))
    require(vk_digest(vk) == v["vk_sha256"], (vk_digest(vk), v["vk_sha256"]))
    proof = os.path.join(out, "state_transition.proof")
    res = run("prove", "prove", *common, "--pk",
              os.path.join(out, "state_transition_pk.bin"), "--out", proof)
    require(res.returncode == 0, ("cli prove", res.stderr[-2000:]))
    with open(proof + ".inst.json") as f:
        require([str(x) for x in json.load(f)] == v["instances"],
                "CLI instances differ from the frozen ones")
    verify = ["verify", "--vk", os.path.join(out, "state_transition_vk.bin"),
              "--proof", proof, "--instances", proof + ".inst.json"]
    res = run("verify", *verify)
    require(res.returncode == 0, ("cli verify", res.stdout, res.stderr[-2000:]))
    with open(proof, "rb") as f:
        bad = bytearray(f.read())
    bad[len(bad) // 2] ^= 1
    with open(proof, "wb") as f:
        f.write(bytes(bad))
    res = run("verify_tampered", *verify)
    require(res.returncode == 1, ("cli verify of a tampered proof",
                                  res.returncode, res.stderr[-2000:]))
    log(f"CLI state_transition k={v['k']}: vk {shape}, digest "
        f"{vk_digest(vk)[:16]}... equals the frozen JAX digest; keygen "
        f"{times['keygen_s']:.3f} s ({times.get('keygen_inner_s')} s in "
        f"keygen), prove {times['prove_s']:.3f} s "
        f"({times.get('prove_inner_s')} s in prove), verify "
        f"{times['verify_s']:.3f} s exit 0; tampered proof exit 1 "
        f"({times['verify_tampered_s']:.3f} s)")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; a CUDA GPU "
                 "is required")
    sys.path.insert(0, ROOT)
    from zksnap_tpu_torch import kernels
    from zksnap_tpu_torch.curves.fused import (bucket_scan, ladder_tree,
                                               point, weighted_suffix)
    from zksnap_tpu_torch.curves.pallas_point import (point_add_batch,
                                                      point_add_staged,
                                                      point_dbl_batch)
    from zksnap_tpu_torch.fields.pallas_mont import mont_addsub, mont_mul
    from zksnap_tpu_torch.poly.ntt import ntt_kernel

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t_start = time.time()

    # 1. build
    t0 = time.time()
    lib_path = kernels.build()
    build_s = time.time() - t0
    kernels.library()
    log(f"build: {os.path.relpath(lib_path, ROOT)}; nvcc {build_s:.1f} s "
        f"(with loading {time.time() - t0:.1f} s)")
    ptxas = []
    with open(os.path.join(os.path.dirname(lib_path),
                           f"build_{kernels.source_hash()}.log")) as f:
        build_log = f.read()
    for line in build_log.splitlines():
        if any(w in line for w in ("Compiling entry function", "registers",
                                   "spill")):
            ptxas.append(line.strip())
            log("  ptxas:", line.strip())
    all_ptxas = ptxas_entries(build_log)
    scan_ptxas = {k: v for k, v in all_ptxas.items()
                  if any(s in k for s in SCAN_KERNELS)}
    sass = kernel_sass(lib_path, SCAN_KERNELS + INLINED_KERNELS
                       + FIELD_KERNELS)
    field_report = field_kernel_report(all_ptxas, sass)
    for name, r in field_report.items():
        log(f"  K1/K2 {name}: {r}")
    require_field_kernels(field_report, all_ptxas)
    log(f"  K3-K6: the {len(K3_K6_PTXAS)} ptxas lines (registers, stack "
        "frames) of K3's projective kinds and K4-K6, unchanged")
    sass = {k: v for k, v in sass.items() if k not in field_report}
    scan_sass = {k: v for k, v in sass.items()
                 if any(s in k for s in SCAN_KERNELS)}
    for name, v in scan_sass.items():
        log(f"  K4/K5 {name}: ptxas {scan_ptxas.get(name)}; main loop "
            + str({g: n for g, n in (v["loop"] or {}).items()
                   if g != "opcodes"}))
    inline_report = inlined(all_ptxas, sass)
    for r in inline_report.values():
        log(f"  K3/K6 {r['kernel']}: {r['registers']} registers, "
            f"{r['stack_bytes']}-byte stack frame, {r['calls']} CALL, "
            f"{r['local']} LDL/STL")
    require_inlined(inline_report)
    ntt_report = ntt_kernel_report(all_ptxas)
    for name, r in ntt_report.items():
        log(f"  NTT {name}: {r}")
    require_ntt_kernels(ntt_report)

    rng = random.Random(20261016)
    results = {}
    t_checks = time.time()
    phase2(dev, rng, results)
    phase2_k21(dev, rng, results)
    check_secp_rcb(dev, results)
    phase2_reduce(dev, rng, results)
    check_ladder_fit(dev, rng, results)
    launches_k7_k8 = phase_point_batch(dev, rng, results)
    loops = chain_loops(lib_path)
    exp_report = exp_mul_report(all_ptxas, lib_path)
    for name, r in exp_report.items():
        log(f"  K9/K10 {exp_kernel_key(name)}: {r['registers']} registers, "
            f"{r['stack_bytes']}-byte stack frame, {r['LDL/STL']} LDL/STL, "
            f"{r['CALL']} CALL, {r['loops']} loops")
    require_exp_mul(exp_report)
    dots = dot_report(all_ptxas, lib_path)
    for name, r in dots.items():
        log(f"  K11 {name}: {r['registers']} registers, {r['stack_bytes']}"
            f"-byte stack frame, {r['LDL/STL']} LDL/STL; {r['steps_a_trip']}"
            f" steps a trip of its step loop, a step {r['a_step']}")
    require_dots(dots)
    checks_s = time.time() - t_checks
    log(f"kernel checks (phase 2): {checks_s:.1f} s")
    t_exp = time.time()
    launches_exp = phase_experiments(dev, results, loops, exp_report)
    exp_s = time.time() - t_exp
    log(f"experiments phase: {exp_s:.1f} s")
    # the kernels line gives K1-K6 and the NTT at the k=21 path's shape
    # (their launches are that path's), K7, K8 at n = 2^20 (their launches
    # their own path's, each a launch of K3's point kernel), K9-K11 at
    # the experiments' default shapes (their
    # launches the experiments path's); the largest error is over every
    # shape of a kernel that is exact (bf16dot's relative error is held to
    # BF16_TOL instead)
    for name, tag in (("K1", "k21"), ("K2", "k21"), ("K3", "k21"),
                      ("K4", "k21"), ("K5", "k21"), ("K6", "k21"),
                      ("K7", "n2^20"), ("K8", "n2^20"), ("K9", "B"),
                      ("K10", "mxu"), ("K11", "u32mul"),
                      ("K11dot", "i8dot"), ("NTT", "2^21")):
        shapes = results[name + "_shapes"]
        results[name] = dict(shapes[tag], max_abs_err=max(
            r["max_abs_err"] for r in shapes.values()
            if r.get("exact", True)))

    counters = {"K1": (mont_mul,), "K2": (mont_addsub,), "K3": (point,),
                "K4": (bucket_scan,), "K5": (weighted_suffix,),
                "K6": (ladder_tree,), "K7": (point_add_staged,),
                "K8": (point_add_batch, point_dbl_batch),
                "NTT": (ntt_kernel,)}

    def zero_counts():
        for fns in counters.values():
            for fn in fns:
                fn.launches = 0
        mont_mul.copies = mont_addsub.copies = 0

    def read_counts():
        return {name: sum(fn.launches for fn in fns)
                for name, fns in counters.items()}

    def path(name, fn, needs):
        """Drive one path with the counts set to 0 just before it and read
        just after; each kernel in `needs` must have launched."""
        zero_counts()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        path_seconds[name] = time.time() - t0
        counts = read_counts()
        copies = copy_counts()
        log(f"kernel launches over the {name} path ({path_seconds[name]:.1f}"
            f" s): {counts}; operands copied: {copies}")
        require(all(counts[k] > 0 for k in needs), (name, counts))
        path_launches[name] = counts
        path_copies[name] = copies
        return out

    work = tempfile.mkdtemp(prefix="chip_smoke_srs_",
                            dir=os.path.join(ROOT, "build"))
    k13, k21, srs15, protocol, serving, cli_times = {}, {}, {}, {}, {}, {}
    lazy, poseidon, wrap = {}, {}, {}
    mesh7, mesh21, warm13 = {}, {}, {}
    enc18, poly18 = {}, {}
    path_launches, path_copies, path_seconds = {}, {}, {}
    k1_k4 = ("K1", "K2", "K3", "K4")
    try:
        phase3(dev, work)
        path("K=7 on a virtual mesh",
             lambda: phase_mesh_k7(dev, work, mesh7), k1_k4)
        phase_lazy_k7(dev, work, lazy)
        pk, inst = path("voter k=13", lambda: phase4(dev, work, k13), k1_k4)
        profile_prove(pk, inst, k13)
        del pk
        phase_warm_prove(work, warm13)
        with fused_reduce("1"):
            srs, pk, inst = path(
                "PLUME voter k=21", lambda: phase_plume(dev, work, k21),
                k1_k4 + ("K5", "K6", "NTT"))
            profile_prove(pk, inst, k21)
            phase_mesh_k21(dev, srs, pk, inst, path, mesh21)
        del pk
        fused_commit_parity(srs, k21)
        fixed_base_commit_2p21(srs, k21)
        del srs
        path("poly_device k=18", lambda: phase_poly_extra(dev, poly18),
             ("K1", "K2"))
        pk, inst = path("Paillier voter k=18",
                        lambda: phase_enc(dev, work, enc18), k1_k4)
        profile_prove(pk, inst, enc18)
        del pk
        path("ceremony SRS k=15",
             lambda: phase_ceremony_srs(dev, work, srs15), ("K1", "K2", "K3"))
        path("protocol k=13", lambda: phase_protocol(dev, protocol), k1_k4)
        path("server voter k=13", lambda: phase_server(dev, serving), k1_k4)
        path("Poseidon 2^16", lambda: phase_poseidon(dev, poseidon),
             ("K1", "K2"))
        t0 = time.time()
        path("wrapper toy", lambda: phase_wrapper_toy(work, wrap), k1_k4)
        wrap["phase_s"] = time.time() - t0
        log(f"wrapper toy phase: {wrap['phase_s']:.1f} s")
        # the CLI runs in child processes, whose counts this one cannot read
        phase_cli(work, cli_times)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = dict(path_launches["PLUME voter k=21"], **launches_k7_k8,
                    K9=launches_exp["K9"], K10=launches_exp["K10"],
                    K11=launches_exp["K11 chain"],
                    K11dot=launches_exp["K11 dot"])

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip())

    meta = {
        "K1": ("mont_mul", "zksnap_tpu_torch/csrc/mont.cu",
               "zksnap_tpu/fields/pallas_mont.py:87"),
        "K2": ("mont_addsub", "zksnap_tpu_torch/csrc/mont.cu",
               "zksnap_tpu/fields/pallas_mont.py:171"),
        "K3": ("point", "zksnap_tpu_torch/csrc/point.cu",
               "zksnap_tpu/curves/fused.py:382"),
        "K4": ("bucket_scan", "zksnap_tpu_torch/csrc/bucket_scan.cu",
               "zksnap_tpu/curves/fused.py:490"),
        "K5": ("weighted_suffix", "zksnap_tpu_torch/csrc/reduce.cu",
               "zksnap_tpu/curves/fused.py:566"),
        "K6": ("ladder_tree", "zksnap_tpu_torch/csrc/reduce.cu",
               "zksnap_tpu/curves/fused.py:678"),
        "K7": ("point_add_staged", "zksnap_tpu_torch/csrc/point.cu",
               "zksnap_tpu/curves/pallas_point.py:280"),
        "K8": ("point_add_batch", "zksnap_tpu_torch/csrc/point.cu",
               "zksnap_tpu/curves/pallas_point.py:322"),
        "K9": ("mul_limb_major (variant B)",
               "zksnap_tpu_torch/csrc/exp_mul_variants.cu",
               "scripts/exp_mul_variants.py:163"),
        "K10": ("mont_mul_mxu (mxu)", "zksnap_tpu_torch/csrc/exp_mul_mxu.cu",
                "scripts/exp_mul_mxu.py:329"),
        "K11": ("op_chain (u32mul)", "zksnap_tpu_torch/csrc/exp_rates.cu",
                "scripts/exp_vpu_rates.py:75"),
        "K11dot": ("dot_chain (i8dot)", "zksnap_tpu_torch/csrc/exp_rates.cu",
                   "scripts/exp_vpu_rates.py:102"),
        "NTT": ("ntt_pass_kernel", "zksnap_tpu_torch/csrc/ntt.cu",
                "none: zksnap_tpu/poly/ntt.py is jnp"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k],
         **{key: results[k][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": results[k].get("library_ms")}
        for k, (name, src, rep) in meta.items()]}
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({**line, "voter_k13": k13, "voter_plume_k21": k21,
                   "voter_enc_k18": enc18, "poly_device_k18": poly18,
                   "ceremony_srs_k15": srs15, "protocol_k13": protocol,
                   "server_k13": serving, "cli_state_k15": cli_times,
                   "lazy_k7": lazy, "poseidon_2p16": poseidon,
                   "wrapper_toy": wrap, "mesh_k7": mesh7,
                   "mesh_k21": mesh21, "warm_prove_k13": warm13,
                   "path_launches": path_launches,
                   "path_copies": path_copies, "path_seconds": path_seconds,
                   "k1_k2_kernels": field_report,
                   "field_checks": results["field_checks"],
                   "ntt_checks": results["ntt_checks"],
                   "ntt_kernels": ntt_report,
                   "field_host_split_ms": results["host_split_ms"],
                   "launches_k7_k8": launches_k7_k8, "ptxas": ptxas,
                   "k4_k5_ptxas": scan_ptxas, "k4_k5_sass": scan_sass,
                   "k3_k6_inlined": inline_report,
                   "k3_k6_sass": {k: v for k, v in sass.items()
                                  if k not in scan_sass},
                   "k6_fit": results["K6_fit"],
                   "k9_k10_kernels": exp_report, "k11_dot_kernels": dots,
                   "k11_dot_checks": results["k11_dot_checks"],
                   "k3_kinds": results["K3_kinds"],
                   "shapes": {k: results[k + "_shapes"] for k in meta
                              if k + "_shapes" in results},
                   "experiment_lines": results["experiment_lines"],
                   "launches_experiments": launches_exp, "chain_loops": loops,
                   "experiments_s": exp_s, "kernel_checks_s": checks_s,
                   "device_ms": {k: results[k]["device_ms"] for k in meta},
                   "build_s": build_s, "total_s": time.time() - t_start,
                   "nvidia_smi": smi.stdout.strip()}, f, indent=1)
    log(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
