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
      affine point: `msm_inputs` below makes the inputs from the seed.

Run once on the CPU:  python scripts/gen_torch_port_vectors.py
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

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

K7_SEED = 20261016
VOTER_K = 13
VOTER_SEED = 20260817
MSM_SEED, MSM_N = 25, 20


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


def vk_shape(vk) -> dict:
    return {"n_advice": vk.n_advice, "n_lookup": vk.n_lookup,
            "n_perm": vk.n_perm, "n_z": vk.n_z, "usable": vk.usable,
            "ext_log": vk.ext_log}


def main():
    from gen_protocol_vectors import build_fixed_circuit

    from zksnap_tpu.circuits.voter import VoterFlags, voter_circuit
    from zksnap_tpu.natives import generate_random_voter_circuit_inputs
    from zksnap_tpu.prover.plonk import keygen, prove, verify
    from zksnap_tpu.prover.srs import gen_srs
    from zksnap_tpu.trace import Context, check

    out = {"version": 1}

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
    out["seeded_proof_k7"] = {
        "k": 7, "srs_seed": "dev", "rng_seed": K7_SEED,
        "instances": [str(v) for v in instances],
        "vk_sha256": vk_digest(pk.vk),
        "proof_hex": proof.hex(),
    }
    out["srs_k7"] = {"k": 7, "srs_seed": "dev", "sha256": srs_sha256(7)}
    print(f"k=7 seeded proof: {len(proof)} bytes", flush=True)

    t0 = time.time()
    inp = generate_random_voter_circuit_inputs(random.Random(VOTER_SEED))
    ctx = Context(lookup_bits=VOTER_K - 1)
    pub = []
    voter_circuit(ctx, inp, pub, VoterFlags(check_plume=False))
    inst = [c.value for c in pub]
    check(ctx, inst)
    stats = ctx.stats()
    srs = gen_srs(VOTER_K)
    pk = keygen(ctx, VOTER_K, srs)
    out["voter_k13"] = {
        "k": VOTER_K, "srs_seed": "dev", "inputs_seed": VOTER_SEED,
        "lookup_bits": VOTER_K - 1, "check_plume": False,
        "stats": {k_: int(v) for k_, v in stats.items()
                  if isinstance(v, int)},
        "instances": [str(v) for v in inst],
        "vk_shape": vk_shape(pk.vk),
        "vk_sha256": vk_digest(pk.vk),
    }
    print(f"voter k=13 keygen done in {time.time() - t0:.1f}s", flush=True)

    from zksnap_tpu.curves.native import BN254_G1, AffinePoint
    from zksnap_tpu.curves.proj import bn254_proj_ops
    from zksnap_tpu.fields import ints_to_limbs
    from zksnap_tpu.msm.pippenger import bn254_msm_proj

    t0 = time.time()
    pts, ks = msm_inputs(MSM_SEED, MSM_N, BN254_G1, AffinePoint)
    ops = bn254_proj_ops()
    r = bn254_msm_proj()(ops.from_affine_host(pts), ints_to_limbs(ks))
    got = ops.to_affine_host(type(r)(r.x[None], r.y[None], r.z[None]))[0]
    want = AffinePoint.identity(BN254_G1)
    for k, p in zip(ks, pts):
        want = want + k * p
    assert got == want
    out["msm_proj"] = {"seed": MSM_SEED, "n": MSM_N,
                       "x": hex(got.x), "y": hex(got.y)}
    print(f"msm done in {time.time() - t0:.1f}s", flush=True)

    path = os.path.join("tests", "vectors", "torch_port_v1.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
