"""Command-line delivery surface (PyTorch port of zksnap_tpu/cli.py):

  python -m zksnap_tpu_torch.cli keygen --circuit voter --k 13 --out build/
  python -m zksnap_tpu_torch.cli prove  --circuit voter --k 13 --pk build/voter_pk.bin --out build/voter.proof
  python -m zksnap_tpu_torch.cli verify --vk build/voter_vk.bin --proof build/voter.proof --instances build/voter.proof.inst.json

The flags and files are the JAX CLI's; `--device` (default `cuda`) names
the device keygen, prove and the SRS run on (`--device cpu` runs the
plain versions of the kernels).  `verify` exits 0 on a valid proof and 1
otherwise.  Inputs are generated with the native mirror from `--seed`
(random, like the reference tests).  The JAX CLI's `bench` subcommand
runs the JAX package's benchmark; the port has none yet.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time


CIRCUITS = ("voter", "state_transition")


def build_circuit(name: str, k: int, seed: int):
    """Synthesise and check circuit `name` at size k on inputs that the
    native mirror draws from `seed`: (context, public instances).  The
    proving service builds its circuits here too."""
    from .natives import (
        generate_random_voter_circuit_inputs,
        generate_wrapper_circuit_input,
    )
    from .trace import Context, check

    rng = random.Random(seed)
    ctx = Context(lookup_bits=min(14, k - 1))
    pub = []
    if name == "voter":
        from .circuits.voter import (VoterFlags, expected_instances,
                                     voter_circuit)

        inp = generate_random_voter_circuit_inputs(rng)
        # PLUME needs the k>=21 production shape; opt out below it
        voter_circuit(ctx, inp, pub, VoterFlags(check_plume=k >= 21))
        check(ctx, expected_instances(inp))
    elif name == "state_transition":
        from .circuits.state_transition import (
            expected_instances,
            state_transition_circuit,
        )

        _, sts = generate_wrapper_circuit_input(1, rng)
        state_transition_circuit(ctx, sts[0], pub)
        check(ctx, expected_instances(sts[0]))
    else:
        raise ValueError(f"unknown circuit {name!r}")
    return ctx, [c.value for c in pub]


def cmd_keygen(args):
    from .prover import gen_srs, keygen, save_pk, save_vk

    ctx, _ = build_circuit(args.circuit, args.k, args.seed)
    srs = gen_srs(args.k, device=args.device)
    t0 = time.time()
    pk = keygen(ctx, args.k, srs)
    print(f"keygen {time.time() - t0:.3f}s", file=sys.stderr)
    save_pk(pk, f"{args.out}/{args.circuit}_pk.bin")
    save_vk(pk.vk, f"{args.out}/{args.circuit}_vk.bin")
    print(f"wrote {args.out}/{args.circuit}_{{pk,vk}}.bin")


def cmd_prove(args):
    from .prover import load_pk, proof_to_bytes, prove, rebind_witness

    ctx, instances = build_circuit(args.circuit, args.k, args.seed)
    pk = rebind_witness(load_pk(args.pk, device=args.device), ctx)
    t0 = time.time()
    proof = prove(pk, instances)
    print(f"prove {time.time() - t0:.3f}s", file=sys.stderr)
    with open(args.out, "wb") as f:
        f.write(proof_to_bytes(proof))
    with open(args.out + ".inst.json", "w") as f:
        json.dump(instances, f)
    print(f"wrote {args.out} (+ .inst.json)")


def cmd_verify(args):
    from .prover import gen_srs, load_vk, proof_from_bytes, verify

    vk = load_vk(args.vk)
    with open(args.proof, "rb") as f:
        proof = proof_from_bytes(f.read())
    with open(args.instances) as f:
        instances = json.load(f)
    srs = gen_srs(vk.k, device=args.device)
    t0 = time.time()
    ok = verify(vk, srs.g2, srs.tau_g2, instances, proof)
    print(f"verify: {ok} ({time.time() - t0:.3f}s)")
    raise SystemExit(0 if ok else 1)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="zksnap_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, fn):
        p = sub.add_parser(name)
        p.add_argument("--device", default="cuda")
        p.set_defaults(fn=fn)
        return p

    kg = add("keygen", cmd_keygen)
    kg.add_argument("--circuit", default="voter", choices=CIRCUITS)
    kg.add_argument("--k", type=int, default=13)
    kg.add_argument("--seed", type=int, default=0)
    kg.add_argument("--out", default="build")

    pv = add("prove", cmd_prove)
    pv.add_argument("--circuit", default="voter", choices=CIRCUITS)
    pv.add_argument("--k", type=int, default=13)
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--pk", required=True)
    pv.add_argument("--out", default="build/proof.bin")

    vf = add("verify", cmd_verify)
    vf.add_argument("--vk", required=True)
    vf.add_argument("--proof", required=True)
    vf.add_argument("--instances", required=True)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
