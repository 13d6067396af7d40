"""Generate tests/vectors/torch_port_v1.json -- frozen JAX results that the
PyTorch port (zksnap_tpu_torch) is held to without rerunning the JAX prover.

  (a) the frozen K=7 circuit (scripts/gen_protocol_vectors.py) proved with
      its blinding drawn from `random.Random(seed).randrange` instead of
      `secrets.randbelow`, so the port's `prove(pk, inst, rng=...)` with the
      same seed must reproduce the proof byte for byte;
  (b) the sha256 of the K=7 dev SRS arrays as the JAX package caches them
      (x, y, z, lx, ly, lz of build/srs_7_<sha8>.npz, uint32, in order);
  (c) the voter circuit at k=13 (`VoterFlags(check_plume=False)`, inputs
      from `generate_random_voter_circuit_inputs(random.Random(20260817))`):
      its vk shape, vk digest and instances;
  (d) the compiled `bn254_msm_proj()` of 20 seeded points (duplicates and
      an identity among them) and scalars (zeros, one, n - 1), as an
      affine point: `msm_inputs` below makes the inputs from the seed;
  (e) the fused Pippenger reduction on seeded bucket sums, chained as
      `msm_impl` chains it: `weighted_suffix_fused` (K5), the selection
      of each window's weighted sum, then `ladder_tree_fused` (K6), for
      c=3, W=3 with signed digits and c=3, W=2 unsigned (identity
      buckets, a window of identities, P beside -P, equal buckets);
      inputs and outputs as canonical projective integers;
  (f) the voter circuit with PLUME on at k=21 (`VoterFlags()`, inputs
      from `random.Random(20260817)`, lookup_bits=14, as
      scripts/prove_voter_tpu.py makes it): synthesis stats, instances
      and the layout's vk shape (host code only; no keygen);
  (g) `pallas_point`: `point_add_batch`, `point_dbl_batch` and
      `point_add_staged` of curves/pallas_point.py in interpret mode on
      a seeded batch of 8 BN254 G1 Jacobian points (P = inf, Q = inf, both
      inf, P = Q, P = -Q, then random), inputs and outputs as canonical
      integers;
  (h) `state_k15`: the state-transition circuit at k=15 (inputs from
      `generate_wrapper_circuit_input(1, random.Random(20260817))`,
      lookup_bits=14, as scripts/prove_state_tpu.py makes them): stats,
      instances, vk shape and vk digest (one keygen at k=15);
  (i) `srs_file_k7`: the sha256 of the ceremony-format file that
      `save_srs(gen_srs(7))` writes;
  (j) `state_k13`: as (h) at k=13 (lookup_bits=12), the size of the
      protocol's rounds (scripts/protocol_demo.py);
  (k) `exp_mul`: the six variants of scripts/exp_mul_mxu.py's
      `make_kernel` (BN254 Fr) under jax.disable_jit() on 256 seeded pairs
      below p (the port's oracle set, `random.Random(0)`) and 256 of all
      16-bit limbs (numpy-seeded, 2^256 - 1 first), limb-major [16, 256]
      uint32, each array stored as base64 of its zlib-compressed
      little-endian bytes;
  (l) `ladder_small`: `ladder_tree_fused` (K6) alone at (c, W) = (16, 1)
      and (3, 2), a few doublings, on seeded window sums (x*l, y*l, l)
      as canonical integers (an eager call takes about 25 s);
  (m) `wrapper_toy`: the wrapper circuit's toy configuration of
      scripts/prove_wrapper_tpu.py --toy (K=7 children of
      tests/test_wrapper.py, truncated in-circuit MSMs) at k_wrap=18:
      at the script's k_wrap=16 its first dummy synthesis (10,098,951
      cells, 757,742 lookups) needs 12 lookup columns, over the logUp
      budget of 6, and the solve stops (so does the slow
      test_two_round_ivc_checker); at 17 it reaches 78 advice and 6
      lookup columns.  Frozen: the
      children's vks (whole, and their digests), their proofs for two
      rounds seeded as in (a), the shape `solve_wrapper_shape` reaches
      from that script's guess with the `layout_circuit` digest of its
      last dummy synthesis, and each round's wrapper instances and
      advice digest (round 1's previous snark a dummy proof over round
      0's instances, as test_two_round_ivc_checker builds it); host
      work but the K=7 keygens and proofs.  No wrapper keygen at k=18
      is frozen: part (h), one JAX keygen at k=15, takes about 35
      minutes of CPU, and this one is 8x its rows;
  (n) `poseidon`: `hash_fixed_batched` on seeded inputs of widths 1 to 5
      (three hashes each), `PoseidonSpec.permute` on two seeded states
      and `build_tree_device` over 8 seeded leaves, as canonical integers
      (each input shape costs a jit compile of the 65-round chain);
  (o) `four_step`: `four_step_ntt` of zksnap_tpu/poly/ntt.py, forward and
      inverse, at k=9 over meshes of 2 and 4 of the 8 virtual CPU devices
      (as tests/conftest.py makes them), on the input permuted by
      `four_step_input_perm`: the sha256 of each output's uint32 limbs in
      the transform's own (permuted) layout; the input is 512 values from
      `random.Random(FOUR_STEP_SEED).randrange(p)` in Montgomery form
      (each shape's shard_map compiles for about 14 s);
  (p) `srs_k7_arrays`: the six arrays of (b) themselves, each as base64
      of its zlib-compressed little-endian uint32 bytes, with their
      sha256 (the port's delivery tests start from them; the port's own
      K=7 SRS generation is held to (b) by tests/test_torch_prover.py);
  (q) `voter_enc_k18`: the voter circuit with the Paillier encryption
      check on and PLUME off at k=18 (`VoterFlags(check_plume=False,
      check_encryption=True)`, inputs from `random.Random(20260817)`,
      lookup_bits=14, as scripts/prove_voter_tpu.py 18 --no-plume --enc
      makes it): synthesis stats, instances and the layout's vk shape
      (host code only; no keygen);
  (r) `poly_extra`: `coset_extended_evals` and `coset_interpolate` of
      zksnap_tpu/prover/poly_device.py at K=7 with ext_log 2 and 3,
      `batch_eval` and `rlc` of three polys at K=7 and
      `pow_series_traced` of one value to 1, 2, 5 and 128 powers, on
      inputs from `poly_extra_inputs` below: the sha256 of each output's
      uint32 limbs and batch_eval's integers (each function's jit
      compiles for 10-30 s).

Run on the CPU:  python scripts/gen_torch_port_vectors.py [part ...]
with parts among k7, voter_k13, msm, reduce, ladder, plume, pallas_point,
state_k15, state_k13, srs_file, exp_mul, wrapper_toy, poseidon, four_step,
srs_k7_arrays, voter_enc_k18, poly_extra (all by default); the parts named replace their entries in
the existing file.
"""

import hashlib
import json
import os
import random
import secrets
import sys
import time

sys.path.insert(0, ".")
sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS",
                                                                ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8"
                               ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

K7_SEED = 20261016
VOTER_K = 13
VOTER_SEED = 20260817
MSM_SEED, MSM_N = 25, 20
REDUCE_SEED = 26
REDUCE_CASES = ((3, 3, True), (3, 2, False))  # (c, W, signed)
LADDER_SEED, LADDER_CASES = 29, ((16, 1), (3, 2))  # (c, W)
PLUME_K, PLUME_LOOKUP_BITS = 21, 14
ENC_K, ENC_LOOKUP_BITS = 18, 14
POLY_SEED, POLY_K, POLY_EXT, POLY_POWS = 33, 7, (2, 3), (1, 2, 5, 128)
POINT_SEED, POINT_N = 27, 8
STATE_K, STATE_SMALL_K, STATE_SEED = 15, 13, 20260817
EXP_MUL_SEED, EXP_MUL_N = 28, 256
WRAP_CHILD_SEED = 30
WRAP_TOY_K = 18
POSEIDON_SEED = 31
FOUR_STEP_SEED, FOUR_STEP_K, FOUR_STEP_NDEV = 32, 9, (2, 4)
PARTS = ("k7", "voter_k13", "msm", "reduce", "ladder", "plume",
         "pallas_point",
         "state_k15", "state_k13", "srs_file", "exp_mul", "wrapper_toy",
         "poseidon", "four_step", "srs_k7_arrays", "voter_enc_k18",
         "poly_extra")


def vk_digest(vk) -> str:
    """sha256 over the sorted preprocessed commitments (the digest of
    tests/test_protocol_vectors.py)."""
    h = hashlib.sha256()
    for name in sorted(vk.commitments):
        pt = vk.commitments[name]
        x, y = (0, 0) if pt.is_identity() else (pt.x, pt.y)
        h.update(name.encode() + x.to_bytes(32, "little")
                 + y.to_bytes(32, "little"))
    return h.hexdigest()


def srs_sha256(k: int, seed: bytes = b"dev") -> str:
    """sha256 over the six uint32 arrays of the JAX SRS cache file."""
    import numpy as np

    path = os.path.join("build",
                        f"srs_{k}_{hashlib.sha256(seed).hexdigest()[:8]}.npz")
    d = np.load(path)
    h = hashlib.sha256()
    for name in ("x", "y", "z", "lx", "ly", "lz"):
        h.update(np.ascontiguousarray(d[name], dtype=np.uint32).tobytes())
    return h.hexdigest()


def msm_inputs(seed: int, n: int, curve, affine_point):
    """n points (a duplicate, an identity) and scalars (zeros, one,
    n - 1) from the seed; the port's tests make the same ones with the
    port's copy of curves.native."""
    rng = random.Random(seed)
    g = affine_point.generator(curve)
    base = [rng.randrange(1, curve.n) * g for _ in range(n // 3)]
    pts = [rng.choice(base) for _ in range(n)]
    pts[1] = pts[0]
    pts[4] = affine_point.identity(curve)
    ks = [rng.randrange(curve.n) for _ in range(n)]
    ks[2] = ks[5] = 0
    ks[3] = 1
    ks[6] = curve.n - 1
    return pts, ks


def reduce_inputs(seed: int, W: int, B: int, curve, affine_point):
    """W*B window-major projective bucket sums (x*l, y*l, l) as canonical
    ints: window 0 holds an identity (0 : l : 0), P beside -P and two
    equal buckets; window 1 is all identities; the rest are random."""
    rng = random.Random(seed)
    g = affine_point.generator(curve)
    q = curve.p
    pool = [rng.randrange(1, curve.n) * g for _ in range(6)]
    pts = [rng.choice(pool) for _ in range(W * B)]
    ident = affine_point.identity(curve)
    pts[0] = ident
    pts[1], pts[2] = pool[0], -pool[0]
    pts[3] = pts[4] = pool[1]
    for b in range(B, 2 * B):
        pts[b] = ident
    out = []
    for pt in pts:
        lam = rng.randrange(1, q)
        out.append([0, lam, 0] if pt.is_identity()
                   else [pt.x * lam % q, pt.y * lam % q, lam])
    return out


def reduce_case(c: int, W: int, signed: bool) -> dict:
    """K5 then K6 of the JAX package, eagerly on the CPU (the direct
    path), as msm_impl chains them."""
    import jax.numpy as jnp

    from zksnap_tpu.curves.fused import ladder_tree_fused, weighted_suffix_fused
    from zksnap_tpu.curves.native import BN254_G1, AffinePoint
    from zksnap_tpu.curves.proj import bn254_proj_ops

    ops = bn254_proj_ops()
    F = ops.F
    B = (1 << (c - 1)) if signed else (1 << c)
    rows = reduce_inputs(REDUCE_SEED + c * 100 + W, W, B, BN254_G1,
                         AffinePoint)
    flat = tuple(F.to_mont([r[i] for r in rows]) for i in range(3))
    with jax.disable_jit():
        s2 = weighted_suffix_fused(flat, B, F.p, int(F.n0), b3=ops.b3)
        sel = jnp.arange(W) * B + (0 if signed else 1)
        t = ladder_tree_fused(tuple(a[sel] for a in s2), c, W, F.p,
                              int(F.n0), b3=ops.b3)
    s2_ints = [F.from_mont(a) for a in s2]
    return {"c": c, "W": W, "B": B, "signed": signed,
            "inputs": [[str(v) for v in r] for r in rows],
            "s2": [[str(s2_ints[i][j]) for i in range(3)]
                   for j in range(W * B)],
            "ladder": [str(F.from_mont(a)) for a in t]}


def point_inputs(seed: int, n: int, curve, affine_point):
    """n (P, Q) pairs of Jacobian points (l^2 x, l^3 y, l) as canonical
    ints, rows 0-4: P = inf, Q = inf, both inf, P = Q, P = -Q (an
    identity is (l^2, l^3, 0)); the rest random."""
    rng = random.Random(seed)
    g = affine_point.generator(curve)
    q = curve.p
    pool = [rng.randrange(1, curve.n) * g for _ in range(4)]
    ident = affine_point.identity(curve)
    a, b = pool[0], pool[1]
    pairs = [(ident, a), (b, ident), (ident, ident), (a, a), (b, -b)]
    while len(pairs) < n:
        pairs.append((rng.choice(pool), rng.choice(pool)))

    def enc(pt):
        lam = rng.randrange(1, q)
        l2, l3 = lam * lam % q, lam * lam * lam % q
        if pt.is_identity():
            return [l2, l3, 0]
        return [l2 * pt.x % q, l3 * pt.y % q, lam]

    return [enc(pa) + enc(pb) for pa, pb in pairs]


def vk_shape(vk) -> dict:
    return {"n_advice": vk.n_advice, "n_lookup": vk.n_lookup,
            "n_perm": vk.n_perm, "n_z": vk.n_z, "usable": vk.usable,
            "ext_log": vk.ext_log}


def main():
    parts = sys.argv[1:] or list(PARTS)
    assert set(parts) <= set(PARTS), parts
    path = os.path.join("tests", "vectors", "torch_port_v1.json")
    out = {"version": 1}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    for part in parts:
        t0 = time.time()
        out.update(globals()[f"part_{part}"]())
        print(f"{part} done in {time.time() - t0:.1f}s", flush=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


def part_k7() -> dict:
    from gen_protocol_vectors import build_fixed_circuit

    from zksnap_tpu.prover.plonk import keygen, prove, verify
    from zksnap_tpu.prover.srs import gen_srs

    srs = gen_srs(7)
    pk = keygen(build_fixed_circuit(), 7, srs)
    instances = [68]
    rng = random.Random(K7_SEED)
    saved = secrets.randbelow
    secrets.randbelow = rng.randrange
    try:
        proof = prove(pk, instances)
    finally:
        secrets.randbelow = saved
    assert verify(pk.vk, srs.g2, srs.tau_g2, instances, proof)
    return {"seeded_proof_k7": {
        "k": 7, "srs_seed": "dev", "rng_seed": K7_SEED,
        "instances": [str(v) for v in instances],
        "vk_sha256": vk_digest(pk.vk),
        "proof_hex": proof.hex(),
    }, "srs_k7": {"k": 7, "srs_seed": "dev", "sha256": srs_sha256(7)}}


def part_voter_k13() -> dict:
    from zksnap_tpu.circuits.voter import VoterFlags, voter_circuit
    from zksnap_tpu.natives import generate_random_voter_circuit_inputs
    from zksnap_tpu.prover.plonk import keygen
    from zksnap_tpu.prover.srs import gen_srs
    from zksnap_tpu.trace import Context, check

    inp = generate_random_voter_circuit_inputs(random.Random(VOTER_SEED))
    ctx = Context(lookup_bits=VOTER_K - 1)
    pub = []
    voter_circuit(ctx, inp, pub, VoterFlags(check_plume=False))
    inst = [c.value for c in pub]
    check(ctx, inst)
    stats = ctx.stats()
    srs = gen_srs(VOTER_K)
    pk = keygen(ctx, VOTER_K, srs)
    return {"voter_k13": {
        "k": VOTER_K, "srs_seed": "dev", "inputs_seed": VOTER_SEED,
        "lookup_bits": VOTER_K - 1, "check_plume": False,
        "stats": {k_: int(v) for k_, v in stats.items()
                  if isinstance(v, int)},
        "instances": [str(v) for v in inst],
        "vk_shape": vk_shape(pk.vk),
        "vk_sha256": vk_digest(pk.vk),
    }}


def part_msm() -> dict:
    from zksnap_tpu.curves.native import BN254_G1, AffinePoint
    from zksnap_tpu.curves.proj import bn254_proj_ops
    from zksnap_tpu.fields import ints_to_limbs
    from zksnap_tpu.msm.pippenger import bn254_msm_proj

    pts, ks = msm_inputs(MSM_SEED, MSM_N, BN254_G1, AffinePoint)
    ops = bn254_proj_ops()
    r = bn254_msm_proj()(ops.from_affine_host(pts), ints_to_limbs(ks))
    got = ops.to_affine_host(type(r)(r.x[None], r.y[None], r.z[None]))[0]
    want = AffinePoint.identity(BN254_G1)
    for k, p in zip(ks, pts):
        want = want + k * p
    assert got == want
    return {"msm_proj": {"seed": MSM_SEED, "n": MSM_N,
                         "x": hex(got.x), "y": hex(got.y)}}


def part_reduce() -> dict:
    return {"fused_reduce": [reduce_case(*case) for case in REDUCE_CASES]}


def ladder_case(c: int, W: int) -> dict:
    """K6 of the JAX package alone, eagerly on the CPU (the direct path),
    on W seeded window sums."""
    import jax.numpy as jnp

    from zksnap_tpu.curves.fused import ladder_tree_fused
    from zksnap_tpu.curves.native import BN254_G1, AffinePoint
    from zksnap_tpu.curves.proj import bn254_proj_ops

    ops = bn254_proj_ops()
    F = ops.F
    rng = random.Random(LADDER_SEED + c * 100 + W)
    g = AffinePoint.generator(BN254_G1)
    q = BN254_G1.p
    rows = []
    for _ in range(W):
        pt, lam = rng.randrange(1, BN254_G1.n) * g, rng.randrange(1, q)
        rows.append([pt.x * lam % q, pt.y * lam % q, lam])
    ws = tuple(jnp.asarray(F.to_mont([r[i] for r in rows]))
               for i in range(3))
    with jax.disable_jit():
        t = ladder_tree_fused(ws, c, W, F.p, int(F.n0), b3=ops.b3)
    return {"c": c, "W": W, "inputs": [[str(v) for v in r] for r in rows],
            "ladder": [str(F.from_mont(a)) for a in t]}


def part_ladder() -> dict:
    return {"ladder_small": [ladder_case(*case) for case in LADDER_CASES]}


def voter_layout_part(k: int, lookup_bits: int, flags) -> dict:
    """A voter synthesis at 2^k rows from the seeded inputs, checked: its
    stats, instances and the layout's vk shape (host code only)."""
    from zksnap_tpu.circuits.voter import expected_instances, voter_circuit
    from zksnap_tpu.natives import generate_random_voter_circuit_inputs
    from zksnap_tpu.prover.keygen import (PERM_CHUNK, layout_circuit,
                                          quotient_ext_log)
    from zksnap_tpu.trace import Context, check

    inp = generate_random_voter_circuit_inputs(random.Random(VOTER_SEED))
    ctx = Context(lookup_bits=lookup_bits)
    pub = []
    voter_circuit(ctx, inp, pub, flags)
    inst = [c.value for c in pub]
    assert inst == expected_instances(inp)
    check(ctx, inst)
    lay = layout_circuit(ctx, k)
    n_perm = len(lay.perm_columns)
    return {
        "k": k, "srs_seed": "dev", "inputs_seed": VOTER_SEED,
        "lookup_bits": lookup_bits, "check_plume": flags.check_plume,
        "stats": {k_: int(v) for k_, v in ctx.stats().items()
                  if isinstance(v, int)},
        "instances": [str(v) for v in inst],
        "vk_shape": {"n_advice": lay.n_advice, "n_lookup": lay.n_lookup,
                     "n_perm": n_perm, "n_z": -(-n_perm // PERM_CHUNK),
                     "usable": lay.usable,
                     "ext_log": quotient_ext_log(lay.n_lookup)},
    }


def part_plume() -> dict:
    from zksnap_tpu.circuits.voter import VoterFlags

    return {"voter_plume_k21": voter_layout_part(
        PLUME_K, PLUME_LOOKUP_BITS, VoterFlags())}


def part_voter_enc_k18() -> dict:
    from zksnap_tpu.circuits.voter import VoterFlags

    out = voter_layout_part(ENC_K, ENC_LOOKUP_BITS, VoterFlags(
        check_plume=False, check_encryption=True))
    out["check_encryption"] = True
    return {"voter_enc_k18": out}


class _BlockRef:
    """One block of a pallas_call operand as interpret mode hands it to a
    kernel body: reads give jax arrays, writes land in the block."""

    def __init__(self, block):
        import numpy as np

        self.block = np.array(block, dtype=np.uint32)

    def __getitem__(self, idx):
        import jax.numpy as jnp

        return jnp.asarray(self.block[idx])

    def __setitem__(self, idx, value):
        import numpy as np

        self.block[idx] = np.asarray(value)


def _one_block_call(kernel, ins, n_out: int):
    """A pallas_call over a grid of one block, as interpret mode runs it:
    the kernel body on the whole [16, block] operands, op by op.  (Jitted
    interpret mode hands XLA the unrolled body, which takes the CPU
    compiler tens of minutes for one point kernel.)"""
    import jax.numpy as jnp

    refs = [_BlockRef(a) for a in ins]
    outs = [_BlockRef(0 * refs[0].block) for _ in range(n_out)]
    kernel(*refs, *outs)
    return [jnp.asarray(o.block) for o in outs]


def part_pallas_point() -> dict:
    """K7 and K8: the kernel bodies of curves/pallas_point.py, each
    pallas_call run as interpret mode runs it on the one block of 128 (the
    TPU's lane width) that holds the batch, with the module's own
    padding, layout and unpadding; the staged add wired as
    `_staged_add_fn` wires it."""
    from zksnap_tpu.curves import pallas_point as pp
    from zksnap_tpu.curves.native import BN254_G1, AffinePoint
    from zksnap_tpu.fields import bn254_fq

    F = bn254_fq()
    block = 128
    rows = point_inputs(POINT_SEED, POINT_N, BN254_G1, AffinePoint)
    cols = [F.to_mont([r[i] for r in rows]) for i in range(6)]
    arrs, batch, n = pp._prep(cols, block)
    assert arrs[0].shape == (16, block)
    add_kernel, dbl_kernel = pp._point_kernels(F.p, F.n0)
    stage_a, stage_b = pp._staged_kernels(F.p, F.n0)
    x1, y1, z1, x2, y2, z2 = arrs
    t0 = time.time()
    res = {"dbl": _one_block_call(dbl_kernel, arrs[:3], 3),
           "add": _one_block_call(add_kernel, arrs, 3)}
    cross = _one_block_call(stage_a, arrs, 6)
    res["staged"] = _one_block_call(
        stage_b, cross + [z1, z2, x1, y1, x2, y2] + res["dbl"], 3)
    print(f"  pallas_point: {time.time() - t0:.1f}s", flush=True)
    out = {}
    for name, got in res.items():
        ints = [F.from_mont(a) for a in pp._unprep(got, batch, n)]
        out[name] = [[str(ints[i][j]) for i in range(3)]
                     for j in range(POINT_N)]
    assert out["staged"] == out["add"]
    return {"pallas_point": {
        "seed": POINT_SEED, "n": POINT_N, "field": "bn254_fq", "block": 128,
        "inputs": [[str(v) for v in r] for r in rows], **out}}


def state_part(k: int) -> dict:
    from zksnap_tpu.circuits.state_transition import (
        expected_instances,
        state_transition_circuit,
    )
    from zksnap_tpu.natives import generate_wrapper_circuit_input
    from zksnap_tpu.prover.plonk import keygen
    from zksnap_tpu.prover.srs import gen_srs
    from zksnap_tpu.trace import Context, check

    _, sts = generate_wrapper_circuit_input(1, random.Random(STATE_SEED))
    ctx = Context(lookup_bits=min(14, k - 1))
    pub = []
    state_transition_circuit(ctx, sts[0], pub)
    inst = [c.value for c in pub]
    assert inst == expected_instances(sts[0])
    check(ctx, inst)
    pk = keygen(ctx, k, gen_srs(k))
    return {f"state_k{k}": {
        "k": k, "srs_seed": "dev", "inputs_seed": STATE_SEED,
        "lookup_bits": min(14, k - 1),
        "stats": {k_: int(v) for k_, v in ctx.stats().items()
                  if isinstance(v, int)},
        "instances": [str(v) for v in inst],
        "vk_shape": vk_shape(pk.vk),
        "vk_sha256": vk_digest(pk.vk),
    }}


def part_state_k15() -> dict:
    return state_part(STATE_K)


def part_state_k13() -> dict:
    return state_part(STATE_SMALL_K)


def part_srs_file() -> dict:
    import tempfile

    from zksnap_tpu.prover.srs import gen_srs, save_srs

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "kzg_bn254_7.srs")
        save_srs(gen_srs(7), path)
        with open(path, "rb") as f:
            data = f.read()
    return {"srs_file_k7": {"k": 7, "srs_seed": "dev", "bytes": len(data),
                            "sha256": hashlib.sha256(data).hexdigest()}}


def part_srs_k7_arrays() -> dict:
    import numpy as np

    from zksnap_tpu.prover.srs import gen_srs

    gen_srs(7)  # writes build/srs_7_<sha8>.npz where it is not there yet
    path = os.path.join(
        "build", f"srs_7_{hashlib.sha256(b'dev').hexdigest()[:8]}.npz")
    d = np.load(path)
    return {"srs_k7_arrays": {
        "k": 7, "srs_seed": "dev", "sha256": srs_sha256(7),
        "arrays": {name: pack_u32(d[name])
                   for name in ("x", "y", "z", "lx", "ly", "lz")}}}


def pack_u32(arr) -> str:
    import base64
    import zlib

    import numpy as np

    raw = np.ascontiguousarray(arr, dtype="<u4").tobytes()
    return base64.b64encode(zlib.compress(raw, 9)).decode()


def exp_mul_inputs(seed: int, n: int, p: int):
    """(a_small, b_small, a_wide, b_wide), [16, n] uint32 16-bit limbs:
    small the n pairs below p that the port's exp_mul_mxu checks against
    the oracle (`random.Random(0).randrange(p)`, all a's, then all b's);
    wide every limb random from numpy's `seed` (2^256 - 1 first)."""
    import numpy as np

    from zksnap_tpu.fields.common import ints_to_limbs

    rng = random.Random(0)
    avals = [rng.randrange(p) for _ in range(n)]
    bvals = [rng.randrange(p) for _ in range(n)]
    nrng = np.random.default_rng(seed)

    def wide():
        x = nrng.integers(0, 1 << 16, (16, n), dtype=np.uint32)
        x[:, 0] = 0xFFFF
        return x

    return (np.asarray(ints_to_limbs(avals)).T, np.asarray(
        ints_to_limbs(bvals)).T, wide(), wide())


def part_exp_mul() -> dict:
    """K10: the JAX kernels of scripts/exp_mul_mxu.py, eagerly."""
    import exp_mul_mxu as jmx
    import jax.numpy as jnp
    import numpy as np

    p, n0 = jmx.FR.p, int(jmx.FR.n0)
    a_s, b_s, a_w, b_w = exp_mul_inputs(EXP_MUL_SEED, EXP_MUL_N, p)
    out = {}
    for variant in ("base", "kar", "mxu", "kar+mxu", "convonly",
                    "mxunocarry"):
        t0 = time.time()
        fn = jmx.make_kernel(variant, p, n0)
        with jax.disable_jit():
            out[variant] = {
                part: pack_u32(np.asarray(fn(jnp.asarray(a), jnp.asarray(b),
                                             block=EXP_MUL_N)))
                for part, a, b in (("small", a_s, b_s), ("wide", a_w, b_w))}
        print(f"  exp_mul {variant}: {time.time() - t0:.1f}s", flush=True)
    return {"exp_mul": {
        "seed": EXP_MUL_SEED, "n": EXP_MUL_N, "field": "bn254_fr",
        "a_small": pack_u32(a_s), "b_small": pack_u32(b_s),
        "a_wide": pack_u32(a_w), "b_wide": pack_u32(b_w), "out": out}}


def vk_dict(vk) -> dict:
    """A VerifyingKey as JSON: its fields, ints as strings, commitments
    as [x, y] ("0", "0" for the identity)."""
    out = {}
    for name in ("k", "ext_log", "n_advice", "n_lookup", "lookup_bits",
                 "n_perm", "n_z", "usable", "num_instance"):
        out[name] = getattr(vk, name)
    out["deltas"] = [str(d) for d in vk.deltas]
    out["omega"] = str(vk.omega)
    out["commitments"] = {
        nm: (["0", "0"] if pt.is_identity() else [str(pt.x), str(pt.y)])
        for nm, pt in sorted(vk.commitments.items())}
    return out


def layout_digest(layout) -> str:
    """sha256 over a layout's structure (the digest chip_smoke.py's
    `layout_digest` computes)."""
    import chip_smoke

    return chip_smoke.layout_digest(layout)


def seeded_proof(pk, instances, seed: int) -> bytes:
    from zksnap_tpu.prover.plonk import prove

    saved = secrets.randbelow
    secrets.randbelow = random.Random(seed).randrange
    try:
        return prove(pk, instances)
    finally:
        secrets.randbelow = saved


def part_wrapper_toy() -> dict:
    import numpy as np
    from dataclasses import asdict

    sys.path.insert(0, "tests")
    from test_wrapper import _toy_state_ctx, _toy_voter_ctx

    from zksnap_tpu.circuits.wrapper import (
        WrapperConfig,
        WrapperRoundInput,
        WrapperShape,
        build_wrapper,
        default_accumulator,
        gen_dummy_proof,
        initial_snark,
        solve_wrapper_shape,
        toy_linkage,
    )
    from zksnap_tpu.fields.field import bn254_fr
    from zksnap_tpu.prover.keygen import layout_circuit
    from zksnap_tpu.prover.plonk import keygen, rebind_witness
    from zksnap_tpu.prover.recursion import Snark
    from zksnap_tpu.prover.srs import gen_srs
    from zksnap_tpu.trace import Context, check

    p = bn254_fr().p
    srs = gen_srs(7)
    outs = [(11, 40), (40, 99)]      # test_two_round_ivc_checker's values
    vpk = keygen(_toy_voter_ctx(outs[0][0]), 7, srs)
    spk = keygen(_toy_state_ctx(*outs[0]), 7, srs)
    children = []
    for r, (vi, vo) in enumerate(outs):
        vp = seeded_proof(rebind_witness(vpk, _toy_voter_ctx(vi)), [vi % p],
                          WRAP_CHILD_SEED + 2 * r)
        sp = seeded_proof(rebind_witness(spk, _toy_state_ctx(vi, vo)),
                          [vi % p, vo % p], WRAP_CHILD_SEED + 2 * r + 1)
        children.append((Snark(vpk.vk, [vi % p], vp),
                         Snark(spk.vk, [vi % p, vo % p], sp)))
    guess = WrapperShape(n_advice=40, n_lookup=5, n_z=24, n_perm=47,
                         ext_log=3)
    cfg = WrapperConfig(
        k=WRAP_TOY_K, lookup_bits=14, voter_vk=vpk.vk, state_vk=spk.vk,
        shape=guess, default_acc=default_accumulator(srs),
        linkage=toy_linkage, n_payload=1, msm_window=2,
        msm_unsound_truncate=8)
    t0 = time.time()
    cfg, ctx = solve_wrapper_shape(cfg, verbose=True)
    solve_s = time.time() - t0
    lay = layout_circuit(ctx, cfg.k)
    comms = cfg.self_vk(None).commitments
    rounds = []
    prev = initial_snark(cfg, comms)
    for r, (voter, state) in enumerate(children):
        win = WrapperRoundInput(round=r, voter=voter, state=state,
                                prev=prev, self_commitments=comms)
        t0 = time.time()
        c = Context(lookup_bits=cfg.lookup_bits)
        inst = [x.value for x in build_wrapper(c, cfg, win)]
        trace_s = time.time() - t0
        check(c, inst)
        rounds.append({
            "instances": [str(v) for v in inst],
            "cells": len(c.advice), "lookups": len(c.lookups),
            "advice_sha256": hashlib.sha256(np.ascontiguousarray(
                c.advice.limbs()).tobytes()).hexdigest(),
            "trace_s": round(trace_s, 1)})
        prev = Snark(cfg.self_vk(comms), inst,
                     gen_dummy_proof(cfg.self_vk(comms), seed=11))
    return {"wrapper_toy": {
        "k_child": 7, "k_wrap": WRAP_TOY_K, "lookup_bits": 14,
        "msm_window": 2,
        "msm_unsound_truncate": 8, "outs": outs,
        "guess": asdict(guess), "shape": asdict(cfg.shape),
        "solve_s": round(solve_s, 1),
        "dummy_cells": len(ctx.advice), "dummy_lookups": len(ctx.lookups),
        "layout_sha256": layout_digest(lay),
        "voter_vk": vk_dict(vpk.vk), "state_vk": vk_dict(spk.vk),
        "voter_vk_sha256": vk_digest(vpk.vk),
        "state_vk_sha256": vk_digest(spk.vk),
        "child_proofs": [[v.proof.hex(), s_.proof.hex()]
                         for v, s_ in children],
        "child_seed": WRAP_CHILD_SEED, "rounds": rounds}}



def poseidon_inputs(seed: int, p: int) -> dict:
    """Widths 1..5 (three hashes each), two permutation states and 8
    leaves, from the seed; the port's tests make the same ones."""
    rng = random.Random(seed)
    return {
        "widths": {str(n): [[rng.randrange(p) for _ in range(n)]
                            for _ in range(3)] for n in range(1, 6)},
        "states": [[rng.randrange(p) for _ in range(3)] for _ in range(2)],
        "leaves": [rng.randrange(p) for _ in range(8)]}


def part_poseidon() -> dict:
    from zksnap_tpu.fields.field import bn254_fr
    from zksnap_tpu.hash import default_spec, hash_fixed_batched
    from zksnap_tpu.natives.merkle import build_tree_device

    F = bn254_fr()
    inp = poseidon_inputs(POSEIDON_SEED, F.p)

    def strs(xs):
        return [str(v) for v in xs]

    hashes = {}
    for n, rows in inp["widths"].items():
        x = F.to_mont([v for r in rows for v in r]).reshape(3, int(n), 16)
        hashes[n] = strs(F.from_mont(hash_fixed_batched(x)))
    st = F.to_mont([v for r in inp["states"] for v in r]).reshape(2, 3, 16)
    perm = F.from_mont(default_spec().permute(st).reshape(6, 16))
    levels = build_tree_device(F.to_mont(inp["leaves"]))
    tree = [strs(F.from_mont(lv.reshape(-1, 16))) for lv in levels]
    return {"poseidon": {"seed": POSEIDON_SEED, "hashes": hashes,
                         "permute": [strs(perm[:3]), strs(perm[3:])],
                         "tree": tree}}


def part_four_step() -> dict:
    import jax.numpy as jnp
    import numpy as np

    from zksnap_tpu.fields.field import bn254_fr
    from zksnap_tpu.poly.ntt import four_step_input_perm, four_step_ntt

    F = bn254_fr()
    k = FOUR_STEP_K
    rng = random.Random(FOUR_STEP_SEED)
    x = np.asarray(F.to_mont([rng.randrange(F.p) for _ in range(1 << k)]))
    out = {}
    for ndev in FOUR_STEP_NDEV:
        mesh = jax.make_mesh((ndev,), ("x",), devices=jax.devices()[:ndev])
        xp = jnp.asarray(x[four_step_input_perm(k, ndev)])
        for inverse in (False, True):
            y = np.asarray(four_step_ntt(xp, k, mesh, inverse=inverse))
            out[f"{ndev}_{'inverse' if inverse else 'forward'}"] = (
                hashlib.sha256(np.ascontiguousarray(y, dtype="<u4")
                               .tobytes()).hexdigest())
    return {"four_step": {"seed": FOUR_STEP_SEED, "k": k, "sha256": out}}



def poly_extra_inputs(seed: int, p: int, k: int) -> dict:
    """From the seed: canonical values of one poly a ext_log of
    POLY_EXT, then three polys, a point for batch_eval, rlc's three
    coefficients and pow_series_traced's base; the port's tests make the
    same ones."""
    rng = random.Random(seed)
    n = 1 << k
    return {"ext": {e: [rng.randrange(p) for _ in range(n)]
                    for e in POLY_EXT},
            "polys": [[rng.randrange(p) for _ in range(n)] for _ in range(3)],
            "x": rng.randrange(p),
            "coefs": [rng.randrange(p) for _ in range(3)],
            "base": rng.randrange(p)}


def part_poly_extra() -> dict:
    import numpy as np

    from zksnap_tpu.fields.field import bn254_fr
    from zksnap_tpu.prover import poly_device as jpd

    F = bn254_fr()
    k = POLY_K
    inp = poly_extra_inputs(POLY_SEED, F.p, k)

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(
            np.asarray(a), dtype="<u4").tobytes()).hexdigest()

    out = {"seed": POLY_SEED, "k": k}
    for e, vals in inp["ext"].items():
        ext = jpd.coset_extended_evals(F.to_mont(vals), k, e)
        out[f"coset_extended_evals_{e}"] = sha(ext)
        out[f"coset_interpolate_{e}"] = sha(jpd.coset_interpolate(ext, k, e))
    polys = F.to_mont([v for r in inp["polys"] for v in r]).reshape(
        3, 1 << k, 16)
    out["batch_eval"] = [str(v) for v in jpd.batch_eval(polys, inp["x"], k)]
    out["rlc"] = sha(jpd.rlc(polys, inp["coefs"], k))
    base = F.to_mont(inp["base"])
    for n in POLY_POWS:
        out[f"pow_series_traced_{n}"] = sha(jpd.pow_series_traced(base, n))
    return {"poly_extra": out}


if __name__ == "__main__":
    main()
