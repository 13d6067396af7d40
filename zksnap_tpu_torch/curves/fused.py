"""Point kernel K3, bucket-scan kernel K4 and the fused Pippenger
reduction kernels K5 and K6 (PyTorch port of zksnap_tpu/curves/fused.py).

`point(kind, arrays, p, b3)` runs one complete group operation per
element, for six kinds:

  * padd, pmadd, pdbl -- RCB 2015 complete projective formulas for a = 0
    (Algorithms 7, 8, 9); identity (0:1:0); pmadd passes P through where
    the affine Q has z == 0;
  * add, madd, dbl -- Jacobian add-2007-bl / madd-2007-bl / dbl-2009-l
    with branchless completeness selects; identity z == 0.

`bucket_scan(pts, flags, M, K, p, b3)` is the Pippenger accumulation
loop: a segmented running pmadd (madd for b3 == 0) down M lanes of K
steps, emitting every step's partial sum.

`weighted_suffix(flat, B, p, b3)` and `ladder_tree(wsums, c, W, p, b3)`
are the post-scan stages of Pippenger: the window-local double suffix
of the bucket sums, and the masked doubling ladder plus suffix tree that
combines the windows.  The double suffix is work-efficient (chunked
suffix sums with two-level carries): it adds in another order than the
JAX kernel's Hillis-Steele rounds, so its projective representatives
differ from the JAX package's while the points are the same.

All four dispatch on the tensor's device: CUDA launches the hand-written
kernel (csrc/point.cu, csrc/bucket_scan.cu, csrc/reduce.cu), CPU runs the
plain version below, which evaluates the same formula bodies with the
plain field ops in the kernel's order (all values canonical, so the two
agree bit for bit).  Each wrapper's `.launches` counts its calls that
launch their kernels (K5's call is seven launches on the stream).
"""

from __future__ import annotations

import functools

import torch

from ..fields.common import N_LIMBS
from ..fields.pallas_mont import mont_addsub_plain, mont_mul_plain

KINDS = {"add": 0, "madd": 1, "dbl": 2, "padd": 3, "pmadd": 4, "pdbl": 5}


class _PlainField:
    """Field ops for the plain formula bodies: the plain versions of K1
    and K2 (canonical).  Each op takes one or more operand pairs of one
    shape and returns a tuple: the pairs of one formula stage go through a
    single call, since eager PyTorch pays per call, not per element."""

    def __init__(self, p: int):
        self.p = p

    def _run(self, fn, pairs):
        if len(pairs) == 1:
            return (fn(*pairs[0]),)
        a = torch.stack([x for x, _ in pairs])
        b = torch.stack([y for _, y in pairs])
        return tuple(fn(a, b).unbind(0))

    def mul(self, *pairs):
        return self._run(lambda a, b: mont_mul_plain(a, b, self.p), pairs)

    def add(self, *pairs):
        return self._run(lambda a, b: mont_addsub_plain(a, b, self.p, "add"),
                         pairs)

    def sub(self, *pairs):
        return self._run(lambda a, b: mont_addsub_plain(a, b, self.p, "sub"),
                         pairs)

    def dbl(self, a):
        return self.add((a, a))[0]

    def scale(self, *pairs):
        """a * c for (a, c) pairs of a tensor and a small host constant:
        one multiply by the Montgomery constants where the kernels chain
        doublings and adds (the values are the same, canonical mod p)."""
        consts = [_mont_const(self.p, c, a.device).expand(a.shape)
                  for a, c in pairs]
        return self.mul(*[(a, k) for (a, _), k in zip(pairs, consts)])

    @staticmethod
    def is_zero(a):
        return (a == 0).all(dim=-1)

    @staticmethod
    def select(cond, a, b):
        return torch.where(cond[..., None], a, b)


@functools.lru_cache(maxsize=64)
def _mont_const(p: int, c: int, device) -> torch.Tensor:
    """c in Montgomery form, a [16] int32 tensor."""
    v = c * (1 << 256) % p
    return torch.tensor([(v >> (16 * i)) & 0xFFFF for i in range(N_LIMBS)],
                        dtype=torch.int32, device=device)


# The plain formula bodies.  Each computes the values of the kernel
# formulas (csrc/point_inline.cuh's RCB ones and csrc/point.cuh's Jacobian
# ones, translations of the JAX package's fused.py bodies) with canonical
# field ops, so kernel and plain version agree bit for bit; independent
# ops of one stage share a call, and small constant factors are one
# multiply (F.scale).

def _dbl_body_proj(F, x, y, z, b3: int):
    """RCB 2015 Algorithm 9 (a=0): complete projective doubling."""
    t0, t1, zz, xy = F.mul((y, y), (y, z), (z, z), (x, y))
    z3, t2, t2_3 = F.scale((t0, 8), (zz, b3), (zz, 3 * b3))
    x3, z3 = F.mul((t2, z3), (t1, z3))
    (y3,) = F.add((t0, t2))
    (t0,) = F.sub((t0, t2_3))
    a, b = F.mul((t0, y3), (t0, xy))
    y3, x3 = F.add((x3, a), (b, b))
    return x3, y3, z3


def _add_body_proj(F, x1, y1, z1, x2, y2, z2, mixed: bool, b3: int):
    """RCB 2015 complete projective addition for a=0 curves: Algorithm 7
    (mixed=False), or Algorithm 8 (mixed=True, Q affine; Q == identity,
    z2 == 0 in the stream encoding, passes P through)."""
    if mixed:
        s_q, s_p = F.add((x2, y2), (x1, y1))
        t0, t1, t3, y2z1, x2z1 = F.mul(
            (x1, x2), (y1, y2), (s_q, s_p), (y2, z1), (x2, z1))
        (u01,) = F.add((t0, t1))
        (t3,) = F.sub((t3, u01))
        t4, y3 = F.add((y2z1, y1), (x2z1, x1))
        t2m, y3, t0_3 = F.scale((z1, b3), (y3, b3), (t0, 3))
    else:
        a1, a2, b1, b2, c1, c2 = F.add(
            (x1, y1), (x2, y2), (y1, z1), (y2, z2), (x1, z1), (x2, z2))
        t0, t1, t2, t3, t4, y3 = F.mul(
            (x1, x2), (y1, y2), (z1, z2), (a1, a2), (b1, b2), (c1, c2))
        u01, u12, u02 = F.add((t0, t1), (t1, t2), (t0, t2))
        t3, t4, y3 = F.sub((t3, u01), (t4, u12), (y3, u02))
        t2m, y3, t0_3 = F.scale((t2, b3), (y3, b3), (t0, 3))
    (z3,) = F.add((t1, t2m))
    (t1,) = F.sub((t1, t2m))
    m = F.mul((t3, t1), (t4, y3), (t1, z3), (y3, t0_3), (z3, t4), (t0_3, t3))
    (x3,) = F.sub((m[0], m[1]))
    y3, z3 = F.add((m[2], m[3]), (m[4], m[5]))
    if mixed:
        q_inf = F.is_zero(z2)
        x3 = F.select(q_inf, x1, x3)
        y3 = F.select(q_inf, y1, y3)
        z3 = F.select(q_inf, z1, z3)
    return x3, y3, z3


def _dbl_body(F, x, y, z):
    """dbl-2009-l (a=0).  Identity (z=0) doubles to z=0."""
    A, B, yz = F.mul((x, x), (y, y), (y, z))
    (xB,) = F.add((x, B))
    C, t = F.mul((B, B), (xB, xB))
    (D,) = F.sub((t, A))
    (D,) = F.sub((D, C))
    D = F.dbl(D)
    (E,) = F.add((F.dbl(A), A))
    (FF,) = F.mul((E, E))
    (X3,) = F.sub((FF, F.dbl(D)))
    (dx,) = F.sub((D, X3))
    (ed,) = F.mul((E, dx))
    (Y3,) = F.sub((ed, F.dbl(F.dbl(F.dbl(C)))))
    return X3, Y3, F.dbl(yz)


def _add_body(F, x1, y1, z1, x2, y2, z2, mixed: bool):
    """Complete Jacobian add.  mixed=True assumes z2 in {0, 1} (affine
    stream), skipping the z2^2/z2^3 muls (madd-2007-bl)."""
    if mixed:
        (z1z1,) = F.mul((z1, z1))
        u1, s1 = x1, y1
        u2, s2a = F.mul((x2, z1z1), (y2, z1))
        (s2,) = F.mul((s2a, z1z1))
    else:
        z1z1, z2z2 = F.mul((z1, z1), (z2, z2))
        u1, u2, s1a, s2a = F.mul((x1, z2z2), (x2, z1z1), (y1, z2), (y2, z1))
        s1, s2 = F.mul((s1a, z2z2), (s2a, z1z1))
    h, r = F.sub((u2, u1), (s2, s1))
    h2, r2 = F.add((h, h), (r, r))
    (i,) = F.mul((h2, h2))
    j, v, rr = F.mul((h, i), (u1, i), (r2, r2))
    (x3,) = F.sub((rr, j))
    (x3,) = F.sub((x3, F.dbl(v)))
    (vx,) = F.sub((v, x3))
    a, b = F.mul((r2, vx), (s1, j))
    (y3,) = F.sub((a, F.dbl(b)))
    if mixed:
        (z3,) = F.mul((F.dbl(z1), h))
    else:
        (zs,) = F.add((z1, z2))
        (zz,) = F.mul((zs, zs))
        (zz,) = F.sub((zz, z1z1))
        (zz,) = F.sub((zz, z2z2))
        (z3,) = F.mul((zz, h))

    dx, dy, dz = _dbl_body(F, x1, y1, z1)

    h_zero = F.is_zero(h)
    r_zero = F.is_zero(r)
    p_inf = F.is_zero(z1)
    q_inf = F.is_zero(z2)

    use_dbl = h_zero & r_zero & ~p_inf & ~q_inf
    to_inf = h_zero & ~r_zero & ~p_inf & ~q_inf

    x = F.select(use_dbl, dx, x3)
    y = F.select(use_dbl, dy, y3)
    z = F.select(use_dbl, dz, z3)
    z = F.select(to_inf, torch.zeros_like(z), z)
    x = F.select(q_inf, x1, F.select(p_inf, x2, x))
    y = F.select(q_inf, y1, F.select(p_inf, y2, y))
    z = F.select(q_inf, z1, F.select(p_inf, z2, z))
    return x, y, z


def _run_body(kind: str, F, arrays, b3: int):
    if kind == "dbl":
        return _dbl_body(F, *arrays)
    if kind == "pdbl":
        return _dbl_body_proj(F, *arrays, b3=b3)
    if kind in ("padd", "pmadd"):
        return _add_body_proj(F, *arrays, mixed=(kind == "pmadd"), b3=b3)
    return _add_body(F, *arrays, mixed=(kind == "madd"))


def _check_inputs(kind: str, arrays):
    n_in = 3 if kind in ("dbl", "pdbl") else 6
    if kind not in KINDS or len(arrays) != n_in:
        raise ValueError(f"point kind {kind!r} takes {n_in} coordinate "
                         f"tensors, got {len(arrays)}")


def point_plain(kind: str, arrays, p: int, b3: int = 0):
    """The plain PyTorch version of K3 (any device)."""
    _check_inputs(kind, arrays)
    return _run_body(kind, _PlainField(p), arrays, b3)


def _device_of(arrays) -> torch.device:
    dev = arrays[0].device
    if any(a.device != dev for a in arrays):
        raise ValueError("point operands on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no point kernel for device {dev}")
    return dev


def point(kind: str, arrays, p: int, b3: int = 0):
    """Complete group operation `kind` over (x, y, z[, x2, y2, z2]) limb
    tensors [..., 16] (kernel K3).  b3 = 3b of the curve for the
    projective kinds, unused by the Jacobian ones."""
    dev = _device_of(arrays)
    if dev.type == "cpu":
        return point_plain(kind, arrays, p, b3)
    from .. import kernels

    _check_inputs(kind, arrays)
    shape = torch.broadcast_shapes(*[a.shape for a in arrays])
    batch = shape[:-1]
    n = 1
    for d in batch:
        n *= int(d)
    ins = [a.expand(shape).reshape(n, N_LIMBS).contiguous() for a in arrays]
    ptrs = [kernels.rows(a, n) for a in ins]
    if len(ptrs) == 3:
        ptrs = ptrs + ptrs  # dbl kinds read only the first three
    outs = [torch.empty((n, N_LIMBS), dtype=torch.int32, device=dev)
            for _ in range(3)]
    with kernels.on_device(*ins, *outs) as stream:
        err = kernels.library().zk_point(
            KINDS[kind], *ptrs, *[o.data_ptr() for o in outs], n, int(b3),
            kernels.sm_count(dev.index), kernels.mod_ptr(p), stream)
    kernels.check(err, f"zk_point({kind})")
    point.launches += 1
    return tuple(o.reshape(*batch, N_LIMBS) for o in outs)


point.launches = 0


def _zero_one_zero(n: int, p: int, device):
    """n rows of (0, 1, 0) in Montgomery form: x, y and z limb tensors."""
    one = _mont_const(p, 1, device).expand(n, N_LIMBS)
    zero = torch.zeros((n, N_LIMBS), dtype=torch.int32, device=device)
    return zero, one, zero


def _identity_rows(M: int, p: int, b3: int, device):
    """M identities: RCB (0 : 1 : 0) for b3 != 0, Jacobian (1 : 1 : 0)."""
    zero, one, _ = _zero_one_zero(M, p, device)
    return (zero if b3 else one), one, zero


def bucket_scan_plain(pts, flags, M: int, K: int, p: int, b3: int = 0):
    """The plain PyTorch version of K4: K steps of a width-M mixed add."""
    F = _PlainField(p)
    kind = "pmadd" if b3 else "madd"
    lanes = [a.reshape(M, K, N_LIMBS) for a in pts]
    fl = flags.reshape(M, K)
    acc = _identity_rows(M, p, b3, pts[0].device)
    outs = []
    for k in range(K):
        q = tuple(a[:, k] for a in lanes)
        s = _run_body(kind, F, acc + q, b3)
        restart = fl[:, k]
        acc = tuple(F.select(restart, qi, si) for qi, si in zip(q, s))
        outs.append(acc)
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


def bucket_scan(pts, flags, M: int, K: int, p: int, b3: int = 0):
    """Segmented mixed-add scan over the bucket-sorted point stream
    (kernel K4).

    pts: (x, y, z) each [M*K, 16], sorted by bucket id, z in {0, mont 1}.
        Lane l owns positions [l*K, (l+1)*K); step k handles position
        l*K + k of every lane.
    flags: [M*K] bool, True where a new segment starts (the running sum
        restarts from the stream point).
    Returns (x, y, z) each [K, M, 16]: the running lane-local sums.
    """
    dev = _device_of(list(pts) + [flags])
    if dev.type == "cpu":
        return bucket_scan_plain(pts, flags, M, K, p, b3)
    from .. import kernels

    n = M * K
    ins = [kernels.rows(a, n) for a in pts]
    fl = flags.reshape(n).to(torch.uint8).contiguous()
    outs = [torch.empty((K, M, N_LIMBS), dtype=torch.int32, device=dev)
            for _ in range(3)]
    with kernels.on_device(*pts, fl, *outs) as stream:
        err = kernels.library().zk_bucket_scan(
            fl.data_ptr(), *ins, *[o.data_ptr() for o in outs], M, K,
            1 if b3 else 0, int(b3), kernels.mod_ptr(p), stream)
    kernels.check(err, "zk_bucket_scan")
    bucket_scan.launches += 1
    return tuple(outs)


bucket_scan.launches = 0


# -- the fused Pippenger reduction: K5 and K6 --------------------------------
#
# Lanes that are masked out or padded hold (0 : 1 : 0) in both coordinate
# systems, as the JAX kernels write them: the RCB formulas are complete
# only for valid projective points, and z = 0 is the Jacobian identity.

LADDER_LANES = 128


# K5's chunked suffix sums (csrc/reduce.cu): C consecutive buckets a
# chunk, chosen so that about SUFFIX_LANES threads run the chunk passes;
# the carries of a window's chunks come in groups of CARRY_GROUP chunk
# totals, a block of at most CARRY_THREADS threads a group (the kernel
# takes at most 32), then the same over each window's group totals.  The
# plain version below adds in the kernel's order, so the two agree bit
# for bit.
SUFFIX_LANES = 1 << 15
CARRY_GROUP = 64
CARRY_THREADS = 32


def suffix_chunk(total: int, B: int) -> int:
    """K5's chunk length C for `total` buckets in windows of B (a power of
    two): the power of two nearest above total / SUFFIX_LANES, at most B."""
    want = -(-total // SUFFIX_LANES)
    return min(B, 1 << (want - 1).bit_length())


def _suffix_sum(F, kind: str, b3: int, rows, n: int):
    """Sum of each run of n consecutive rows, added from the top down:
    u = r[n-1] + r[n-2] + ... + r[0]."""
    v = tuple(a.reshape(-1, n, N_LIMBS) for a in rows)
    u = tuple(a[:, n - 1] for a in v)
    for i in range(n - 2, -1, -1):
        u = _run_body(kind, F, u + tuple(a[:, i] for a in v), b3)
    return u


def _suffix_carries(F, kind: str, b3: int, t, per: int):
    """One carry block of K5 over each run of `per` totals: for each total
    the sum of the run's totals above it ((0 : 1 : 0) for the last), and
    each run's sum.  G threads of L totals each: a thread's sum, a
    Hillis-Steele suffix over the G sums, then each thread's L totals
    rerun from the sum above."""
    G = min(per, CARRY_THREADS)
    L = per // G
    n = t[0].shape[0] // L  # threads over all runs
    u = _suffix_sum(F, kind, b3, t, L)
    g = torch.arange(n, device=t[0].device) % G
    ident = _zero_one_zero(n, F.p, t[0].device)
    d = 1
    while d < G:
        valid = (g + d < G)[:, None]
        sh = tuple(torch.where(valid, torch.roll(a, -d, 0), i)
                   for a, i in zip(u, ident))
        u = _run_body(kind, F, u + sh, b3)
        d <<= 1
    totals = tuple(a[g == 0] for a in u)
    valid = (g + 1 < G)[:, None]
    run = tuple(torch.where(valid, torch.roll(a, -1, 0), i)
                for a, i in zip(u, ident))
    tv = tuple(a.reshape(n, L, N_LIMBS) for a in t)
    outs = [None] * L
    for i in range(L - 1, -1, -1):
        outs[i] = run
        if i:
            run = _run_body(kind, F, run + tuple(a[:, i] for a in tv), b3)
    return tuple(torch.stack([o[c] for o in outs], 1).reshape(-1, N_LIMBS)
                 for c in range(3)), totals


def _window_carries(F, kind: str, b3: int, t, per_window: int):
    """(b) of K5: for each chunk total, the sum of its window's totals
    above it, by groups of CARRY_GROUP totals and then over each window's
    group sums; a group's carry is added before the chunk's own."""
    group = min(per_window, CARRY_GROUP)
    e, sums = _suffix_carries(F, kind, b3, t, group)
    if per_window == group:
        return e
    eg, _ = _suffix_carries(F, kind, b3, sums, per_window // group)
    eg = tuple(a.repeat_interleave(group, 0) for a in eg)
    return _run_body(kind, F, eg + e, b3)


def _suffix_rerun(F, kind: str, b3: int, rows, carry, C: int,
                  total: bool):
    """(c) of K5: each chunk's suffix sums seeded by its carry,
    out[i] = carry + r[C-1] + ... + r[i]; with `total`, also the sum of
    each chunk's outputs, out[C-1] + ... + out[0]."""
    v = tuple(a.reshape(-1, C, N_LIMBS) for a in rows)
    run, tot = carry, None
    outs = [None] * C
    for i in range(C - 1, -1, -1):
        run = _run_body(kind, F, run + tuple(a[:, i] for a in v), b3)
        outs[i] = run
        if total:
            tot = run if tot is None else _run_body(kind, F, tot + run, b3)
    out = tuple(torch.stack([o[c] for o in outs], 1).reshape(-1, N_LIMBS)
                for c in range(3))
    return out, tot


def _check_suffix(total: int, B: int):
    if B < 1 or B & (B - 1) or total % B:
        raise ValueError(f"{total} buckets are not whole windows of {B} "
                         "(a power of two)")


def weighted_suffix_plain(flat, B: int, p: int, b3: int = 0):
    """The plain PyTorch version of K5: two chunked suffix sums, the
    kernel's additions in the kernel's order."""
    total = flat[0].shape[0]
    _check_suffix(total, B)
    if B == 1:  # the double suffix of one bucket is itself
        return tuple(a.clone() for a in flat)
    F = _PlainField(p)
    kind = "padd" if b3 else "add"
    C = suffix_chunk(total, B)
    t = _suffix_sum(F, kind, b3, flat, C)
    e = _window_carries(F, kind, b3, t, B // C)
    s1, t = _suffix_rerun(F, kind, b3, flat, e, C, True)
    e = _window_carries(F, kind, b3, t, B // C)
    return _suffix_rerun(F, kind, b3, s1, e, C, False)[0]


def weighted_suffix(flat, B: int, p: int, b3: int = 0):
    """Window-local double suffix of the bucket sums (kernel K5).

    flat: (x, y, z) each [W*B, 16], window-major bucket sums, B a power of
    two.  Returns (x, y, z) each [W*B, 16] with
    s2[w*B + b] = sum_{b' >= b} (b' - b + 1) * S[w, b'].
    Projective (RCB padd) for b3 != 0, Jacobian add for b3 == 0.  One
    call counts one launch: the kernel's seven passes on the stream."""
    dev = _device_of(list(flat))
    if dev.type == "cpu":
        return weighted_suffix_plain(flat, B, p, b3)
    from .. import kernels

    total = flat[0].shape[0]
    _check_suffix(total, B)
    if B == 1:
        return tuple(a.clone() for a in flat)
    C = suffix_chunk(total, B)
    ins = [a.contiguous() for a in flat]
    outs = [torch.empty((total, N_LIMBS), dtype=torch.int32, device=dev)
            for _ in range(3)]
    group = min(B // C, CARRY_GROUP)
    # s1, then the chunk totals and carries, then the groups' (three
    # coordinates each)
    chunks = total // C
    scratch = torch.empty((3 * (total + 2 * chunks + 2 * (chunks // group)),
                           N_LIMBS), dtype=torch.int32, device=dev)
    with kernels.on_device(*ins, *outs, scratch) as stream:
        err = kernels.library().zk_weighted_suffix(
            *[kernels.rows(a, total) for a in ins],
            *[kernels.rows(o, total) for o in outs], scratch.data_ptr(),
            total, B, C, group, CARRY_THREADS, 1 if b3 else 0, int(b3),
            kernels.mod_ptr(p), stream)
    kernels.check(err, "zk_weighted_suffix")
    weighted_suffix.launches += 1
    return tuple(outs)


weighted_suffix.launches = 0


def _check_ladder(wsums, W: int):
    if not 1 <= W <= LADDER_LANES or wsums[0].shape[0] != W:
        raise ValueError(f"ladder of {W} windows over {LADDER_LANES} lanes")


def _ladder_lanes(wsums, W: int, p: int):
    """[W, 16] window sums -> [128, 16] lanes, (0 : 1 : 0) past W."""
    _check_ladder(wsums, W)
    pad = _zero_one_zero(LADDER_LANES - W, p, wsums[0].device)
    return tuple(torch.cat([a, b]) for a, b in zip(wsums, pad))


def ladder_tree_plain(wsums, c: int, W: int, p: int, b3: int = 0):
    """The plain PyTorch version of K6."""
    F = _PlainField(p)
    st = _ladder_lanes(wsums, W, p)
    widx = torch.arange(LADDER_LANES, device=st[0].device)
    for i in range(c * (W - 1)):
        dbl = _run_body("pdbl" if b3 else "dbl", F, st, b3)
        need = ((widx * c) > i)[:, None]
        st = tuple(torch.where(need, a, b) for a, b in zip(dbl, st))
    ident = _zero_one_zero(LADDER_LANES, p, st[0].device)
    for r in range(7):
        d = 1 << r
        valid = ((widx + d) < LADDER_LANES)[:, None]
        sh = tuple(torch.where(valid, torch.roll(a, -d, 0), i)
                   for a, i in zip(st, ident))
        st = _run_body("padd" if b3 else "add", F, st + sh, b3)
    return tuple(a[0] for a in st)


def ladder_tree(wsums, c: int, W: int, p: int, b3: int = 0):
    """Window combine T = sum_w 2^(c*w) S_w (kernel K6).

    wsums: (x, y, z) each [W, 16].  Lane w of 128 doubles while
    i < c*w for i < c*(W-1), then a 7-round suffix tree sums the lanes.
    Returns the single combined point, (x, y, z) each [16]."""
    dev = _device_of(list(wsums))
    if dev.type == "cpu":
        return ladder_tree_plain(wsums, c, W, p, b3)
    from .. import kernels

    # the kernel reads the W rows and holds (0 : 1 : 0) past them
    _check_ladder(wsums, W)
    ins = [a.contiguous() for a in wsums]
    outs = [torch.empty((LADDER_LANES, N_LIMBS), dtype=torch.int32,
                        device=dev) for _ in range(3)]
    with kernels.on_device(*ins, *outs) as stream:
        err = kernels.library().zk_ladder_tree(
            *[kernels.rows(a, W) for a in ins],
            *[kernels.rows(o, LADDER_LANES) for o in outs], c, W,
            1 if b3 else 0, int(b3), kernels.mod_ptr(p), stream)
    kernels.check(err, "zk_ladder_tree")
    ladder_tree.launches += 1
    return tuple(o[0] for o in outs)


ladder_tree.launches = 0
