"""The voter with the Paillier encryption check at k=18 on the port
(`VoterFlags(check_plume=False, check_encryption=True)`, the JAX
package's `scripts/prove_voter_tpu.py 18 --no-plume --enc`), and the
port's script for it, scripts/prove_voter_torch.py.

The synthesis (5.3 M advice cells) takes about 30 s of host time, so
it is marked slow; chip_smoke.py runs the same check, and the proof, on
the card.  The frozen JAX stats, instances and vk shape are
`voter_enc_k18` of scripts/gen_torch_port_vectors.py.
"""

import ast
import json
import os
import random

import pytest
import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frozen():
    with open(os.path.join(ROOT, "tests", "vectors",
                           "torch_port_v1.json")) as f:
        return json.load(f)["voter_enc_k18"]


def _options(script: str) -> dict:
    """{option string: its add_argument keywords as source} of a script's
    argparse parser, read from its source."""
    with open(os.path.join(ROOT, "scripts", script)) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords
                  if k.arg != "help"}
            for a in node.args:
                out[a.value] = kw
    return out


def test_prove_voter_torch_takes_the_jax_scripts_arguments():
    """Every argument of the JAX script, with its type, default and
    action, plus the port's --device (the card by default) and
    --srs-cache."""
    jax_opts = _options("prove_voter_tpu.py")
    port_opts = _options("prove_voter_torch.py")
    assert {k: v for k, v in port_opts.items() if k in jax_opts} == jax_opts
    assert set(port_opts) - set(jax_opts) == {"--device", "--srs-cache"}
    assert port_opts["--device"] == {"default": "'cuda'"}


def test_frozen_shape_is_the_logged_one():
    """The frozen JAX synthesis has the figures of the JAX package's k=18
    run (runs/voter_enc_k18_r4.log): 5,295,908 advice cells, 21 advice,
    3 lookup and 26 permutation columns, ext 2^3."""
    v = _frozen()
    assert (v["k"], v["lookup_bits"], v["check_plume"],
            v["check_encryption"]) == (18, 14, False, True)
    assert v["stats"]["advice_cells"] == 5_295_908
    assert {k: v["vk_shape"][k] for k in ("n_advice", "n_lookup", "n_perm",
                                          "ext_log")} == {
        "n_advice": 21, "n_lookup": 3, "n_perm": 26, "ext_log": 3}


@pytest.mark.slow
def test_enc_synthesis_matches_frozen_jax():
    """The port's copied host layer synthesises, checks and lays out the
    Paillier voter at k=18 with the frozen JAX stats, instances and vk
    shape."""
    from zksnap_tpu_torch.circuits.voter import VoterFlags, voter_circuit
    from zksnap_tpu_torch.natives import generate_random_voter_circuit_inputs
    from zksnap_tpu_torch.prover.keygen import (PERM_CHUNK, layout_circuit,
                                                quotient_ext_log)
    from zksnap_tpu_torch.trace import Context, check

    v = _frozen()
    inp = generate_random_voter_circuit_inputs(random.Random(v["inputs_seed"]))
    ctx = Context(lookup_bits=v["lookup_bits"])
    pub = []
    voter_circuit(ctx, inp, pub, VoterFlags(check_plume=False,
                                            check_encryption=True))
    inst = [c.value for c in pub]
    check(ctx, inst)
    assert [str(x) for x in inst] == v["instances"]
    assert {k: int(x) for k, x in ctx.stats().items()
            if isinstance(x, int)} == v["stats"]
    lay = layout_circuit(ctx, v["k"])
    n_perm = len(lay.perm_columns)
    assert {"n_advice": lay.n_advice, "n_lookup": lay.n_lookup,
            "n_perm": n_perm, "n_z": -(-n_perm // PERM_CHUNK),
            "usable": lay.usable,
            "ext_log": quotient_ext_log(lay.n_lookup)} == v["vk_shape"]
