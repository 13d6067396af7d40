"""Write the port's jax-free copies of the JAX package's host layer.

    python scripts/copy_host_layer.py [--check]

Every host module of zksnap_tpu imports jax on import (through the
package's compile-cache set-up or fields/field.py), and the machine that
runs the port has no jax.  So each module in HOST is copied from
zksnap_tpu/ to the same path under zksnap_tpu_torch/, verbatim, under a
first line naming its source; its relative imports then reach the port's
own fields and curves.  A module in PARTIAL is copied the same way but
for its device path: its jax import lines are replaced (or left out),
the definitions named in `own` ("f" or "Class.member") are the port's
own, kept from the file on disk in their source's places, and those in
`drop` are left out.  tests/test_torch_host_copies.py holds every copy
to its source.  With --check, nothing is written and the exit code says
whether the copies on disk are what this script writes.
"""

import ast
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = ("# Copy of zksnap_tpu/{path}{part}: jax-free; goes once zksnap_tpu"
          " imports jax lazily.\n")
OWN_PART = " (its device path the port's own)"

HOST = [
    "trace/__init__.py", "trace/context.py", "trace/checker.py",
    "gadgets/__init__.py", "gadgets/bigint.py", "gadgets/paillier_gadget.py",
    "gadgets/poseidon_gadget.py", "gadgets/merkle.py", "gadgets/imt.py",
    "gadgets/sha256.py", "gadgets/nonnative.py", "gadgets/ecc.py",
    "gadgets/plume_gadget.py",
    "circuits/__init__.py", "circuits/voter.py",
    "circuits/state_transition.py",
    "natives/__init__.py", "natives/inputs.py", "natives/paillier.py",
    "natives/plume.py", "natives/hash_to_curve.py",
    "hash/grain.py", "curves/__init__.py", "curves/native.py",
    "prover/keygen.py", "prover/transcript.py", "prover/pairing.py",
    "prover/accumulator.py", "prover/recursion.py",
    "hash/__init__.py",
    "circuits/wrapper.py", "prover/verifier_gadget.py",
    "gadgets/ecc_msm.py", "gadgets/transcript_gadget.py",
    "parallel/pipeline.py", "parallel/batch_witness.py",
]

PARTIAL = {
    "hash/poseidon.py": dict(
        own=["PoseidonSpec.rc_mont", "PoseidonSpec.mds_mont",
             "PoseidonSpec.permute", "hash_fixed_batched",
             "_hash_fixed_impl", "_absorb"],
        drop=["_hash_fixed_jit"],
        lines={"import jax": None, "import jax.numpy as jnp": None,
               "import numpy as np": "import numpy as np\nimport torch",
               "from ..fields.field import PrimeField, bn254_fr":
                   "from ..fields.common import int_to_limbs\n"
                   "from ..fields.field import PrimeField, bn254_fr"}),
    "natives/merkle.py": dict(lines={"import jax.numpy as jnp": None}),
}


def _span(nodes, i):
    """Lines (0-based, end exclusive) of nodes[i] together with the blank
    and comment lines between it and the node before it."""
    node = nodes[i]
    first = min([node.lineno] + [d.lineno for d in node.decorator_list])
    start = nodes[i - 1].end_lineno if i else first - 1
    return start, node.end_lineno


def _locate(tree, dotted: str):
    """Line span (0-based, end exclusive) of a top-level definition "f"
    or a class member "Class.f" of a parsed module."""
    body, parts = tree.body, dotted.split(".")
    for depth, part in enumerate(parts):
        named = [n for n in body
                 if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
        i = next(j for j, n in enumerate(named) if n.name == part)
        if depth < len(parts) - 1:
            body = named[i].body
            continue
        return _span(named, i)


def host_parts(src: str, own=(), drop=(), lines=None, port_src=None) -> str:
    """src with the import lines in `lines` replaced (None: left out), the
    definitions in `drop` left out and those in `own` taken from
    `port_src`, the port's file, each in its source's place."""
    src_lines = src.splitlines(keepends=True)
    edits = [(*_locate(ast.parse(src), d), []) for d in drop]
    if own:
        port_lines = port_src.splitlines(keepends=True)
        port_tree = ast.parse(port_src)
        for dotted in own:
            a, b = _locate(port_tree, dotted)
            edits.append((*_locate(ast.parse(src), dotted), port_lines[a:b]))
    out, pos = [], 0
    for start, end, text in sorted(edits):
        out += src_lines[pos:start] + text
        pos = end
    out += src_lines[pos:]
    lines = lines or {}
    text = ""
    for line in out:
        key = line.rstrip("\n")
        if key in lines:
            if lines[key] is not None:
                text += lines[key] + "\n"
        else:
            text += line
    return text


def copies() -> dict:
    """{port path: text} of every copy."""
    out = {}
    for path in HOST + list(PARTIAL):
        with open(os.path.join(ROOT, "zksnap_tpu", path)) as f:
            src = f.read()
        part = ""
        if path in PARTIAL:
            spec = PARTIAL[path]
            port_src = None
            if spec.get("own"):
                with open(os.path.join(ROOT, "zksnap_tpu_torch", path)) as f:
                    port_src = f.read()
                part = OWN_PART
            src = host_parts(src, port_src=port_src, **spec)
        out[path] = HEADER.format(path=path, part=part) + src
    return out


def main():
    check = "--check" in sys.argv[1:]
    stale = []
    for path, text in copies().items():
        dest = os.path.join(ROOT, "zksnap_tpu_torch", path)
        old = open(dest).read() if os.path.exists(dest) else None
        if old == text:
            continue
        stale.append(path)
        if not check:
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            with open(dest, "w") as f:
                f.write(text)
    for path in stale:
        print(("differs: " if check else "wrote: ") + path)
    sys.exit(1 if check and stale else 0)


if __name__ == "__main__":
    main()
