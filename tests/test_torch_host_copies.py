"""The port's jax-free host layer is a copy of the JAX package's.

Each module of zksnap_tpu_torch whose first line reads "# Copy of
zksnap_tpu/<path>" holds the JAX module's functions and classes
unchanged (`ast.dump` equal, import lines aside); a copy marked "(its
device path the port's own)" keeps its source's host parts and writes
the device parts named below itself.  The host verifier
at the end of the port's prover/plonk.py is compared the same way, but
for its instance commitment (held to the JAX one by value in
test_torch_prover.py).  In a
fresh interpreter where `import jax` fails, the port imports (its CLI,
service, serialisers and K7/K8 module among the rest) and
synthesises and lays out the voter circuit at k=13.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "zksnap_tpu_torch")

# a copy marked "(its device path the port's own)" keeps its source's
# host parts verbatim; these definitions are the port's own (compared by
# value in test_torch_poseidon.py) and these are left out
PORT_OWN = {
    "hash/poseidon.py": {"hash_fixed_batched", "_hash_fixed_impl", "_absorb",
                         "PoseidonSpec.rc_mont", "PoseidonSpec.mds_mont",
                         "PoseidonSpec.permute"},
}
DROPPED = {"hash/poseidon.py": {"_hash_fixed_jit"}}
# the host verifier copied into the port's prover/plonk.py, with the
# helpers it shares with the prover.  `_instance_commitment` is left out:
# the port's takes its Lagrange points from `srs.lagrange_prefix` (no
# device, no 2^k SRS), and test_torch_prover.py holds it to the JAX one
VERIFIER = ("verify", "verify_succinct", "_verify_succinct",
            "_instance_commitment_cache", "_eval_instance", "_eval_points",
            "_query_plan", "_perm_chunks", "VerifyingKey")


def _copies():
    out = []
    for dirpath, _, files in os.walk(PORT):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                first = f.readline()
            if first.startswith("# Copy of zksnap_tpu/"):
                src = first.split()[3].rstrip(":")
                out.append((os.path.relpath(path, PORT),
                            src[len("zksnap_tpu/"):],
                            "(its device path the port's own)" in first))
    return sorted(out)


COPIES = _copies()


def _names(tree) -> dict:
    """Top-level definitions (and assignments) of a module by name; class
    members appear as Class.member."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.ClassDef)):
                        out[f"{node.name}.{sub.name}"] = sub
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [
                node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node
        elif isinstance(node, ast.Expr) and isinstance(
                getattr(node, "value", None), ast.Constant):
            out["__doc__"] = node
        else:
            out[ast.dump(node)] = node
    return out


def _parse(path):
    with open(path) as f:
        return ast.parse(f.read())


def _without(node: ast.ClassDef, dropped: set) -> str:
    """A class's dump with the named members left out of its body."""
    body = [s for s in node.body
            if getattr(s, "name", None) not in dropped]
    return ast.dump(ast.ClassDef(
        name=node.name, bases=node.bases, keywords=node.keywords,
        body=body, decorator_list=node.decorator_list,
        type_params=getattr(node, "type_params", [])))


def test_copies_found():
    assert len(COPIES) >= 25
    got = {c[0] for c in COPIES}
    for must in ("trace/context.py", "circuits/voter.py", "prover/keygen.py",
                 "prover/transcript.py", "prover/pairing.py",
                 "curves/native.py", "hash/grain.py", "natives/inputs.py",
                 "prover/accumulator.py", "prover/recursion.py",
                 "natives/merkle.py", "hash/__init__.py",
                 "circuits/wrapper.py", "prover/verifier_gadget.py",
                 "gadgets/ecc_msm.py", "gadgets/transcript_gadget.py",
                 "parallel/pipeline.py", "parallel/batch_witness.py",
                 *PORT_OWN):
        assert must in got, must


@pytest.mark.parametrize("copy,src,partial", COPIES,
                         ids=[c[0] for c in COPIES])
def test_copy_is_verbatim(copy, src, partial):
    assert copy == src, "a copy mirrors its source's module path"
    mine = _names(_parse(os.path.join(PORT, copy)))
    ref = _names(_parse(os.path.join(ROOT, "zksnap_tpu", src)))
    own = PORT_OWN.get(copy, set()) if partial else set()
    dropped = set(ref) - set(mine)
    extra = set(mine) - set(ref)
    assert not extra, f"{copy} defines what its source does not: {extra}"
    assert dropped == DROPPED.get(copy, set()), dropped
    assert own <= set(mine), own - set(mine)
    for name, node in mine.items():
        if "." in name or name in own:
            continue
        if name == "__all__":
            assert set(ast.literal_eval(node.value)) <= set(
                ast.literal_eval(ref[name].value))
        elif isinstance(node, ast.ClassDef):
            gone = {d.split(".", 1)[1] for d in dropped | own
                    if d.startswith(name + ".")}
            assert _without(node, gone) == _without(ref[name], gone), name
        else:
            assert ast.dump(node) == ast.dump(ref[name]), name


def test_verifier_is_verbatim():
    mine = _names(_parse(os.path.join(PORT, "prover", "plonk.py")))
    ref = _names(_parse(os.path.join(ROOT, "zksnap_tpu", "prover",
                                     "plonk.py")))
    for name in VERIFIER:
        assert ast.dump(mine[name]) == ast.dump(ref[name]), name


def test_port_never_imports_jax():
    for dirpath, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                tree = _parse(os.path.join(dirpath, name))
                for node in ast.walk(tree):
                    mods = []
                    if isinstance(node, ast.Import):
                        mods = [a.name for a in node.names]
                    elif isinstance(node, ast.ImportFrom) and node.module:
                        mods = [node.module]
                    for m in mods:
                        assert not m.startswith(("jax", "zksnap_tpu.")), (
                            name, m)


_JAX_FREE = r"""
import importlib, json, pkgutil, random, sys
sys.modules["jax"] = None
import zksnap_tpu_torch
for m in pkgutil.walk_packages(zksnap_tpu_torch.__path__, "zksnap_tpu_torch."):
    importlib.import_module(m.name)
for m in ("cli", "server", "prover.serialize", "prover.accumulator",
          "prover.recursion", "curves.pallas_point", "circuits.wrapper",
          "prover.verifier_gadget", "parallel.pipeline",
          "parallel.batch_witness", "parallel.sharded", "prover.warmup"):
    assert "zksnap_tpu_torch." + m in sys.modules, m
assert not any(k == "jax" or k.startswith(("jax.", "zksnap_tpu."))
               for k in sys.modules if sys.modules[k] is not None)
from zksnap_tpu_torch.circuits.voter import VoterFlags, voter_circuit
from zksnap_tpu_torch.natives import generate_random_voter_circuit_inputs
from zksnap_tpu_torch.prover.keygen import (PERM_CHUNK, layout_circuit,
                                            quotient_ext_log)
from zksnap_tpu_torch.trace import Context, check
v = json.load(open(sys.argv[1]))["voter_k13"]
inp = generate_random_voter_circuit_inputs(random.Random(v["inputs_seed"]))
ctx = Context(lookup_bits=v["lookup_bits"])
pub = []
voter_circuit(ctx, inp, pub, VoterFlags(check_plume=False))
inst = [c.value for c in pub]
check(ctx, inst)
lay = layout_circuit(ctx, v["k"])
n_perm = len(lay.perm_columns)
print(json.dumps({
    "instances": [str(x) for x in inst],
    "stats": {k: int(x) for k, x in ctx.stats().items() if isinstance(x, int)},
    "vk_shape": {"n_advice": lay.n_advice, "n_lookup": lay.n_lookup,
                 "n_perm": n_perm, "n_z": -(-n_perm // PERM_CHUNK),
                 "usable": lay.usable,
                 "ext_log": quotient_ext_log(lay.n_lookup)}}))
"""


def test_port_runs_without_jax():
    """Import every module of the port, then synthesise, check and lay
    out the voter circuit at k=13 (PLUME off) with jax unimportable; the
    shape and instances are the frozen JAX package's."""
    vec = os.path.join(ROOT, "tests", "vectors", "torch_port_v1.json")
    res = subprocess.run([sys.executable, "-c", _JAX_FREE, vec], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    with open(vec) as f:
        v = json.load(f)["voter_k13"]
    assert got["instances"] == v["instances"]
    assert got["stats"] == v["stats"]
    assert got["vk_shape"] == v["vk_shape"]


def test_copies_are_what_the_script_writes():
    """scripts/copy_host_layer.py regenerates every copy byte for byte."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import copy_host_layer
    finally:
        sys.path.pop(0)
    written = copy_host_layer.copies()
    assert sorted(written) == [c[0] for c in COPIES]
    for path, text in written.items():
        with open(os.path.join(PORT, path)) as f:
            assert f.read() == text, path
