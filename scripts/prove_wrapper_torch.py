#!/usr/bin/env python
"""Wrapper (recursion) proving script on the PyTorch port, a port of
scripts/prove_wrapper_tpu.py (gen_recursion_snark parity,
wrapper.rs:869-902 + test_recursion :943-1159).

Per round: prove the voter and state-transition circuits, build the
wrapper trace (three in-circuit succinct verifications and the fold),
prove it at k_wrap, replay the round natively, carry the snark into the
next round; finally run the native decide (digest pin + two pairings).

Full width (the default): k=13 children (voter with PLUME off, state
transition), k_wrap=22, sound in-circuit MSMs, the final
`verify_wrapper_snark`.  --toy swaps in the miniature K=7 children of
tests/test_wrapper.py (`toy_voter_ctx`, `toy_state_ctx` below) and
truncated MSMs: the wrapper snarks are proved and their non-accumulator
instance rows checked against the native mirror, and the decide is
skipped (truncated MSMs are unsound by design).  The toy runs at
k_wrap=18, not the JAX script's 16: at 16 the first dummy synthesis
(10,098,951 cells, 757,742 lookups) needs 12 lookup columns, over the
logUp budget of 6, and the solve stops in both packages.  At 18 the JAX
solve from the JAX script's guess reaches (36, 3, 21, 41, 3) in five
syntheses; the toy starts there, as the full width starts at its
measured fixed point, so its solve is a one-synthesis confirm.

It prints the JAX script's lines and, for each stage, its seconds, the
host's resident set (now and peak) and the device's peak allocation.
`main(argv)` returns what it made (configuration, key, snarks, the
native mirror's instances, stage records) to a caller such as
chip_smoke.py.

Usage: python scripts/prove_wrapper_torch.py [rounds] [k_wrap] [--toy]
           [--device cuda|cpu] [--cache DIR]
(`--cache` holds the wrapper key between runs, build/ by default; an
empty DIR turns it off.)
"""

import os
import random
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def toy_voter_ctx(out_val: int):
    """out = a*b + 5, exposes [out] (tests/test_wrapper.py's child)."""
    from zksnap_tpu_torch.fields.field import bn254_fr
    from zksnap_tpu_torch.trace import Context

    p = bn254_fr().p
    ctx = Context(lookup_bits=6)
    a = ctx.load_witness(1)
    b = ctx.load_witness((out_val - 5) % p)
    c = ctx.mul(a, b)
    d = ctx.add(c, ctx.load_constant(5))
    ctx.range_check(ctx.load_witness(37), 6)
    ctx.expose_public(d)
    return ctx


def toy_state_ctx(in_val: int, out_val: int):
    """out = in*3 + delta, exposes [in, out] (tests/test_wrapper.py's)."""
    from zksnap_tpu_torch.fields.field import bn254_fr
    from zksnap_tpu_torch.trace import Context

    p = bn254_fr().p
    ctx = Context(lookup_bits=6)
    i = ctx.load_witness(in_val % p)
    delta = ctx.load_witness((out_val - 3 * in_val) % p)
    o = ctx.mul_add(i, 3, delta)
    ctx.range_check(ctx.load_witness(21), 6)
    ctx.expose_public(i)
    ctx.expose_public(o)
    return ctx


def toy_chain(rounds: int) -> list:
    """(voter out = state in, state out) per round: v -> 3v + 7."""
    outs, v = [], 11
    for _ in range(rounds):
        nxt = (v * 3 + 7) % ((1 << 61) - 1)
        outs.append((v, nxt))
        v = nxt
    return outs


def _rss_gb() -> tuple:
    """(current, peak) resident set of this process, GB."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    cur = pages * os.sysconf("SC_PAGE_SIZE") / 1e9
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    return cur, peak


class Stages:
    """Seconds, host RSS and peak device memory of each stage."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self.records = []

    def start(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        return time.time()

    def end(self, name: str, t0: float, note: str = "") -> float:
        import torch

        peak = None
        if self.cuda:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 1e9
        dt = time.time() - t0
        cur, rss_peak = _rss_gb()
        self.records.append({"stage": name, "s": dt, "rss_gb": cur,
                             "rss_peak_gb": rss_peak, "device_peak_gb": peak})
        dev = "not on a card" if peak is None else f"{peak:.2f} GB"
        print(f"stage {name}: {dt:.3f}s; host RSS {cur:.2f} GB (peak "
              f"{rss_peak:.2f}); device peak {dev}{note}", flush=True)
        return dt


def commit_path(n: int) -> str:
    """Which path a commit of n points takes (poly_device.commit_evals)."""
    from zksnap_tpu_torch.prover.poly_device import _FB_STATE

    if _FB_STATE["enabled"] and _FB_STATE["min_n"] <= n <= _FB_STATE["max_n"]:
        return "fixed-base"
    fused = os.environ.get("ZKSNAP_TPU_FUSED_REDUCE", "0") == "1"
    return ("variable-base, " + ("fused" if fused else "unfused")
            + " reduction (ZKSNAP_TPU_FUSED_REDUCE="
            + os.environ.get("ZKSNAP_TPU_FUSED_REDUCE", "unset") + ")")


def launch_counts() -> dict:
    """K1-K6's launch counters, as this process has counted them."""
    from zksnap_tpu_torch.curves.fused import (bucket_scan, ladder_tree,
                                               point, weighted_suffix)
    from zksnap_tpu_torch.fields.pallas_mont import mont_addsub, mont_mul

    return {name: fn.launches for name, fn in (
        ("K1", mont_mul), ("K2", mont_addsub), ("K3", point),
        ("K4", bucket_scan), ("K5", weighted_suffix), ("K6", ladder_tree))}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    opts = {"--device": "cuda", "--cache": os.path.join(ROOT, "build")}
    args, toy, i = [], False, 0
    while i < len(argv):
        a = argv[i]
        if a == "--toy":
            toy = True
        elif a in opts:
            opts[a] = argv[i + 1]
            i += 1
        elif a.split("=", 1)[0] in opts:
            key, val = a.split("=", 1)
            opts[key] = val
        else:
            args.append(a)
        i += 1
    rounds = int(args[0]) if args else 2
    k_wrap = int(args[1]) if len(args) > 1 else (18 if toy else 22)
    device = opts["--device"]
    cache_dir = opts["--cache"] or None

    import torch

    import zksnap_tpu_torch.circuits.wrapper as wrapper_mod
    from zksnap_tpu_torch.circuits.wrapper import (
        WrapperConfig,
        WrapperRoundInput,
        WrapperShape,
        build_wrapper,
        default_accumulator,
        gen_wrapper_pk,
        initial_snark,
        toy_linkage,
        verify_wrapper_snark,
        wrapper_native,
        zksnap_linkage,
    )
    from zksnap_tpu_torch.parallel.pipeline import Lookahead
    from zksnap_tpu_torch.prover.plonk import keygen, prove, rebind_witness
    from zksnap_tpu_torch.prover.recursion import Snark
    from zksnap_tpu_torch.prover.srs import gen_srs
    from zksnap_tpu_torch.trace import Context

    dev = torch.device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"devices: [{name}]; rounds={rounds} k_wrap={k_wrap} "
          f"toy={toy}", flush=True)
    st = Stages(device)
    rng = random.Random(20260818)

    # --- children -----------------------------------------------------------
    t0 = st.start()
    if toy:
        k_child = 7
        srs_child = gen_srs(k_child, device=device)
        outs = toy_chain(rounds)
        vpk = keygen(toy_voter_ctx(outs[0][0]), k_child, srs_child)
        spk = keygen(toy_state_ctx(*outs[0]), k_child, srs_child)

        def child_ctxs(r):
            """Host-only synthesis (runs on the Lookahead worker)."""
            vi, vo = outs[r]
            return toy_voter_ctx(vi), [vi], toy_state_ctx(vi, vo), [vi, vo]

        linkage, n_payload = toy_linkage, 1
        msm_trunc = 8
        # the k_wrap=18 fixed point (tests/vectors/torch_port_v1.json
        # `wrapper_toy`); the JAX script guesses (40, 5, 24, 47, 3)
        shape_guess = WrapperShape(n_advice=36, n_lookup=3, n_z=21,
                                   n_perm=41, ext_log=3)
    else:
        from zksnap_tpu_torch.circuits.state_transition import (
            state_transition_circuit,
        )
        from zksnap_tpu_torch.circuits.voter import VoterFlags, voter_circuit
        from zksnap_tpu_torch.natives import generate_wrapper_circuit_input

        k_child = 13
        srs_child = gen_srs(k_child, device=device)
        voter_inputs, state_inputs = generate_wrapper_circuit_input(
            rounds, rng)
        # children prove at k_child=13: PLUME (~15.5M cells) only fits
        # the k>=21 shape -- explicit opt-out (VoterFlags default is on)
        child_flags = VoterFlags(check_plume=False)

        def child_ctxs(r):
            """Host-only synthesis (runs on the Lookahead worker)."""
            vc = Context(lookup_bits=k_child - 1)
            vp = []
            voter_circuit(vc, voter_inputs[r], vp, child_flags)
            sc = Context(lookup_bits=k_child - 1)
            sp = []
            state_transition_circuit(sc, state_inputs[r], sp)
            return vc, [c.value for c in vp], sc, [c.value for c in sp]

        vctx, _, sctx, _ = child_ctxs(0)
        vpk = keygen(vctx, k_child, srs_child)
        spk = keygen(sctx, k_child, srs_child)
        del vctx, sctx
        linkage, n_payload = zksnap_linkage, 28
        msm_trunc = None
        # the JAX package's measured k=22 fixed point
        # (runs/exp_shape_solve_k22_r5.log): starting AT it makes the
        # solve a one-pass confirm
        shape_guess = WrapperShape(n_advice=30, n_lookup=3, n_z=18,
                                   n_perm=35, ext_log=3)

    def child_snarks(synth):
        vc, vi, sc, si = synth
        return (Snark(vpk.vk, vi, prove(rebind_witness(vpk, vc), vi)),
                Snark(spk.vk, si, prove(rebind_witness(spk, sc), si)))

    st.end("children", t0)
    print(f"children ready: {st.records[-1]['s']:.1f}s", flush=True)

    # --- wrapper keygen (fixed point + real commitments) ---------------------
    t0 = st.start()
    srs_wrap = gen_srs(k_wrap, device=device)
    cfg = WrapperConfig(
        k=k_wrap, lookup_bits=14, voter_vk=vpk.vk, state_vk=spk.vk,
        shape=shape_guess, default_acc=default_accumulator(srs_wrap),
        linkage=linkage, n_payload=n_payload,
        msm_unsound_truncate=msm_trunc,
        msm_window=2 if toy else 4,
    )
    st.end("wrapper srs", t0)
    print(f"commit path at n=2^{k_wrap}: {commit_path(1 << k_wrap)}",
          flush=True)

    # gen_wrapper_pk runs the shape solve and then keygen; the solve is
    # timed on its own through the module's name for it
    solve = wrapper_mod.solve_wrapper_shape
    marks = {}

    def timed_solve(*a, **kw):
        t1 = st.start()
        out = solve(*a, **kw)
        marks["solve"] = st.end("shape solve", t1,
                                f"; {len(out[1].advice)} cells")
        return out

    t0 = time.time()
    wrapper_mod.solve_wrapper_shape = timed_solve
    try:
        t_keygen = st.start()
        cfg, wpk = gen_wrapper_pk(cfg, srs_wrap, allow_unsound=toy,
                                  cache_dir=cache_dir)
    finally:
        wrapper_mod.solve_wrapper_shape = solve
    st.end("keygen", t_keygen, " (after the shape solve)"
           if "solve" in marks else " (cached key)")
    if "solve" in marks:
        st.records[-1]["s"] -= marks["solve"]
    comms = wpk.vk.commitments
    print(f"wrapper keygen: {time.time()-t0:.1f}s shape={cfg.shape}; "
          f"fixed columns "
          f"{type(wpk.fixed_coeffs).__name__}", flush=True)

    # --- the IVC loop ---------------------------------------------------------
    # round r+1's child witnesses are synthesized on a worker thread while
    # round r's proofs occupy the card
    prev = initial_snark(cfg, comms)
    snarks, natives = [], []
    for r, synth in enumerate(Lookahead(child_ctxs, rounds)):
        t0 = st.start()
        voter, state = child_snarks(synth)
        st.end(f"round {r} child proofs", t0)
        print(f"round {r}: child proofs {st.records[-1]['s']:.1f}s",
              flush=True)
        win = WrapperRoundInput(round=r, voter=voter, state=state,
                                prev=prev, self_commitments=comms)
        t0 = st.start()
        ctx = Context(lookup_bits=cfg.lookup_bits)
        cells = build_wrapper(ctx, cfg, win)
        inst = [c.value for c in cells]
        st.end(f"round {r} trace", t0)
        print(f"round {r}: wrapper trace {st.records[-1]['s']:.1f}s "
              f"({len(ctx.advice)} cells)", flush=True)
        t0 = st.start()
        pk_r = rebind_witness(wpk, ctx)
        del ctx, cells
        proof = prove(pk_r, inst)
        del pk_r
        st.end(f"round {r} proof", t0)
        print(f"round {r}: wrapper proof {st.records[-1]['s']:.1f}s "
              f"({len(proof)} bytes)", flush=True)
        t0 = st.start()
        native, _ = wrapper_native(cfg, win)
        st.end(f"round {r} native mirror", t0)
        if toy:
            # truncated MSMs: the accumulator limbs (rows 0..12) differ
            assert native[12:] == inst[12:], \
                "native mirror disagrees with trace"
        else:
            assert native == inst, "native mirror disagrees with trace"
        prev = Snark(wpk.vk, inst, proof)
        snarks.append(prev)
        natives.append(native)

    # --- decide ----------------------------------------------------------------
    decided = None
    if toy:
        print("toy mode: decide skipped (truncated MSMs are unsound by "
              "design); wrapper snarks proved + structure verified")
    else:
        t0 = st.start()
        decided = verify_wrapper_snark(cfg, comms, prev, srs_wrap)
        st.end("decide", t0)
        print(f"final decide: {decided}")
        assert decided
    print(f"kernel launches: {launch_counts()}", flush=True)
    print("DONE", flush=True)
    return {"cfg": cfg, "pk": wpk, "srs": srs_wrap, "snarks": snarks,
            "natives": natives, "stages": st.records, "decide": decided,
            "commit_path": commit_path(1 << k_wrap), "toy": toy,
            "k_wrap": k_wrap, "rounds": rounds,
            "child_vks": (vpk.vk, spk.vk)}


if __name__ == "__main__":
    main()
