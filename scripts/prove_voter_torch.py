#!/usr/bin/env python
"""Prove and verify the voter circuit end to end on the PyTorch port, a
port of scripts/prove_voter_tpu.py.

The analogue of the reference's `cargo bench --bench voter_circuit`
(voter/benches/voter_circuit.rs: witness gen + gen_proof at K=13) plus
the self-verify of wrapper.rs:141-155.  `--plume` (on by default) turns
on the reference's live PLUME verification (voter/src/lib.rs:276-283);
`--enc` adds the Paillier encryption check that the reference keeps
commented out (voter/src/lib.rs:243-248): with `18 --no-plume --enc` it
proves the voter shape of 21 advice, 3 lookup and 26 permutation
columns over an extended domain of 2^21 rows.

It prints the JAX script's lines; each also gives the device's peak
allocation over its stage, and the prove lines the launches of kernels
K1-K6 over that proof.  `main(argv)` returns what it made (inputs,
context, instances, SRS, key, proof, each stage's record) to a caller
such as chip_smoke.py.

Usage: python scripts/prove_voter_torch.py [k] [--plume | --no-plume]
           [--enc] [--no-check] [--warm-iters N] [--device cuda|cpu]
           [--srs-cache DIR]
(`--srs-cache` is where the SRS is kept between runs, build/ by default.)
"""

import argparse
import os
import random
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VOTER_SEED = 20260817


def kernel_counters() -> dict:
    """The launch counters of kernels K1-K6, by name."""
    from zksnap_tpu_torch.curves.fused import (bucket_scan, ladder_tree,
                                               point, weighted_suffix)
    from zksnap_tpu_torch.fields.pallas_mont import mont_addsub, mont_mul

    return {"K1": mont_mul, "K2": mont_addsub, "K3": point,
            "K4": bucket_scan, "K5": weighted_suffix, "K6": ladder_tree}


class Stage:
    """One stage's seconds, the device's peak allocation over it and the
    launches of K1-K6 in it."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"
        self.records = {}

    def start(self):
        if self.cuda:
            self.torch.cuda.synchronize()
            self.torch.cuda.reset_peak_memory_stats()
        self.counts = {k: fn.launches for k, fn in kernel_counters().items()}
        self.t0 = time.time()

    def end(self, name: str) -> dict:
        peak = None
        if self.cuda:
            self.torch.cuda.synchronize()
            peak = self.torch.cuda.max_memory_allocated()
        rec = {"s": time.time() - self.t0, "peak_bytes": peak,
               "launches": {k: fn.launches - self.counts[k]
                            for k, fn in kernel_counters().items()}}
        self.records.setdefault(name, []).append(rec)
        return rec

    @staticmethod
    def peak(rec) -> str:
        p = rec["peak_bytes"]
        return "device peak " + ("n/a" if p is None else f"{p / 1e9:.2f} GB")

    @staticmethod
    def launches(rec) -> str:
        return "launches " + " ".join(f"{k} {n}"
                                      for k, n in rec["launches"].items())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("k", nargs="?", type=int, default=13)
    ap.add_argument("--plume", action="store_true", default=True,
                    help="in-circuit PLUME verification (the reference's "
                         "live heavyweight constraint) -- DEFAULT ON")
    ap.add_argument("--no-plume", dest="plume", action="store_false",
                    help="opt out of PLUME (small-k shapes)")
    ap.add_argument("--enc", action="store_true",
                    help="enable the Paillier encryption check")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the MockProver-style witness check")
    ap.add_argument("--warm-iters", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--srs-cache", default=None)
    args = ap.parse_args(argv)
    k = args.k

    import torch

    from zksnap_tpu_torch.circuits.voter import (
        VoterFlags, expected_instances, voter_circuit)
    from zksnap_tpu_torch.natives import generate_random_voter_circuit_inputs
    from zksnap_tpu_torch.prover.plonk import keygen, prove, verify
    from zksnap_tpu_torch.prover.srs import gen_srs
    from zksnap_tpu_torch.trace import Context, check

    dev = torch.device(args.device)
    print(f"device: {dev} "
          + (f"({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
             else ""), flush=True)
    st = Stage(dev)
    rng = random.Random(VOTER_SEED)

    st.start()
    inp = generate_random_voter_circuit_inputs(rng)
    # halo2-base convention: lookup_bits = k - 1 (reference uses 14 at k=15)
    ctx = Context(lookup_bits=min(14, k - 1))
    pub = []
    flags = VoterFlags(check_plume=args.plume, check_encryption=args.enc)
    voter_circuit(ctx, inp, pub, flags)
    rec = st.end("witness")
    print(f"witness gen: {rec['s']:.2f}s  {ctx.stats()}  flags={flags}",
          flush=True)
    instances = [c.value for c in pub]
    if not args.no_check:
        st.start()
        stats = check(ctx, expected_instances(inp))
        rec = st.end("check")
        print(f"mock check: {rec['s']:.2f}s  {stats}", flush=True)

    st.start()
    srs = gen_srs(k, cache_dir=args.srs_cache, device=dev)
    rec = st.end("srs")
    print(f"srs(k={k}): {rec['s']:.1f}s  {st.peak(rec)}", flush=True)

    st.start()
    pk = keygen(ctx, k, srs)
    rec = st.end("keygen")
    print(f"keygen: {rec['s']:.1f}s  "
          f"(advice={pk.vk.n_advice} lookup={pk.vk.n_lookup} "
          f"perm={pk.vk.n_perm} ext=2^{pk.vk.ext_log})  {st.peak(rec)}",
          flush=True)

    st.start()
    proof = prove(pk, instances)
    rec = st.end("prove")
    print(f"prove: {rec['s']:.1f}s ({len(proof)} proof bytes)  "
          f"{st.peak(rec)}  {st.launches(rec)}", flush=True)

    st.start()
    ok = verify(pk.vk, srs.g2, srs.tau_g2, instances, proof)
    rec = st.end("verify")
    print(f"verify: {ok} ({rec['s']:.1f}s)  {st.peak(rec)}", flush=True)
    assert ok

    # warm proofs with the kernels built and the tables cached: the
    # steady-state number
    for _ in range(args.warm_iters):
        st.start()
        prove(pk, instances)
        rec = st.end("prove_warm")
        print(f"prove (warm): {rec['s']:.1f}s  {st.peak(rec)}  "
              f"{st.launches(rec)}", flush=True)
    return {"inputs": inp, "ctx": ctx, "flags": flags,
            "instances": instances, "srs": srs, "pk": pk, "proof": proof,
            "stages": st.records}


if __name__ == "__main__":
    main()
