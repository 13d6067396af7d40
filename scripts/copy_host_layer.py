"""Write the port's jax-free copies of the JAX package's host layer.

    python scripts/copy_host_layer.py [--check]

Every host module of zksnap_tpu imports jax on import (through the
package's compile-cache set-up or fields/field.py), and the machine that
runs the port has no jax.  So each module in HOST is copied from
zksnap_tpu/ to the same path under zksnap_tpu_torch/, verbatim, under a
first line naming its source; its relative imports then reach the port's
own fields and curves.  A module in PARTIAL keeps its host parts only:
the named top-level definitions and class members, import lines and
imported names are left out -- the device paths, which a later port
brings over.  tests/test_torch_host_copies.py holds every copy to its
source.  With --check, nothing is written and the exit code says whether
the copies on disk are what this script writes.
"""

import ast
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = ("# Copy of zksnap_tpu/{path}{part}: jax-free; goes once zksnap_tpu"
          " imports jax lazily.\n")

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
]

PARTIAL = {
    "hash/poseidon.py": dict(
        defs=["PoseidonSpec.rc_mont", "PoseidonSpec.mds_mont",
              "PoseidonSpec.permute", "_hash_fixed_jit",
              "hash_fixed_batched", "_hash_fixed_impl", "_absorb"],
        lines=["import jax", "import jax.numpy as jnp", "import numpy as np"]),
    "natives/merkle.py": dict(defs=["build_tree_device"],
                              lines=["import jax.numpy as jnp"],
                              names=["hash_fixed_batched"]),
    "hash/__init__.py": dict(names=["hash_fixed_batched"]),
}


def _span(nodes, i):
    """Lines (0-based, end exclusive) of nodes[i] together with the blank
    and comment lines between it and the node before it."""
    node = nodes[i]
    first = min([node.lineno] + [d.lineno for d in node.decorator_list])
    start = nodes[i - 1].end_lineno if i else first - 1
    return start, node.end_lineno


def host_parts(src: str, defs=(), lines=(), names=()) -> str:
    """src without the named definitions ("f" or "Class.method"), the
    given import lines, and the given names in import lists and
    __all__."""
    tree = ast.parse(src)
    cut = set()
    for dotted in defs:
        body, parts = tree.body, dotted.split(".")
        for depth, part in enumerate(parts):
            named = [n for n in body
                     if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
            i = next(j for j, n in enumerate(named) if n.name == part)
            if depth < len(parts) - 1:
                body = named[i].body
                continue
            start, end = _span(named, i)
            cut.update(range(start, end))
    out = [line for n, line in enumerate(src.splitlines(keepends=True))
           if n not in cut and line.rstrip("\n") not in lines]
    text = "".join(out)
    for name in names:
        text = re.sub(rf"^    \"?{name}\"?,\n", "", text, flags=re.M)
        text = re.sub(rf", {name}\b", "", text)
    return text


def copies() -> dict:
    """{port path: text} of every copy."""
    out = {}
    for path in HOST + list(PARTIAL):
        with open(os.path.join(ROOT, "zksnap_tpu", path)) as f:
            src = f.read()
        part = ""
        if path in PARTIAL:
            src = host_parts(src, **PARTIAL[path])
            part = " (host parts only)"
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
