"""Proof and key serialization (PyTorch port of
zksnap_tpu/prover/serialize.py).

Proofs ARE bytes (prover/transcript.py: 32-byte LE scalars, 64-byte x||y
points, identity = zeros, no tags -- the verifying key determines the
shape), so the two proof helpers are identity functions, as in the JAX
package.

Keys are pickled checkpoints, trusted local caches like the reference's
`SerdeFormat::RawBytesUnchecked` pk files (wrapper.rs:967-989): load only
files this program wrote.  Tensors are kept as numpy arrays at rest and
`load_pk` puts them on its device.  The pickle holds the port's classes
(its `VerifyingKey`, `Layout` and `AffinePoint`), so a key file written by
the JAX package is not expected to load here, nor the other way round;
`prover/convert.py` carries a JAX key across in memory.  A key's fixed
part is either its coefficients in the at-rest int16 form, held as numpy
in the file, or a `LazyFixedCoeffs` (keys above `LAZY_FIXED_BYTES`),
whose host sources pickle as they are and which `load_pk` points at its
device (the JAX package's lazy file form, serialize.py:42-71).
"""

from __future__ import annotations

import copy
import os
import pickle

import numpy as np
import torch


def proof_to_bytes(proof: bytes) -> bytes:
    if not isinstance(proof, (bytes, bytearray)):
        raise TypeError(f"a proof is bytes, got {type(proof).__name__}")
    return bytes(proof)


def proof_from_bytes(data: bytes) -> bytes:
    return bytes(data)


def save_pk(pk, path: str, strip_witness: bool = False):
    """Checkpoint a proving key; device tensors are pulled to the host.

    strip_witness=True drops the layout's witness value buffer (keygen's
    synthesis values) from the file; the loaded pk must then be
    `rebind_witness`-ed before proving (wrapper.rs:945-947 pk reuse)."""
    from .plonk import LazyFixedCoeffs

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if isinstance(pk.fixed_coeffs, LazyFixedCoeffs):
        fixed_host = pk.fixed_coeffs  # host-backed; pickles directly
    else:
        fixed_host = {k: v.cpu().numpy()
                      for k, v in pk.fixed_coeffs.items()}
    layout = pk.layout
    if strip_witness:
        layout = copy.copy(layout)
        layout.advice_limbs = np.empty((0, 16), np.uint16)
    with open(path, "wb") as f:
        pickle.dump({"vk": pk.vk, "layout": layout, "fixed_form": "coeff",
                     "fixed": fixed_host, "srs_k": pk.srs.k}, f)


def load_pk(path: str, device="cuda"):
    """A proving key from `save_pk`, its fixed coefficients and dev SRS on
    `device` (the card unless the caller names the CPU)."""
    from .plonk import LazyFixedCoeffs, ProvingKey
    from .srs import gen_srs

    with open(path, "rb") as f:
        d = pickle.load(f)
    if d.get("fixed_form") != "coeff":
        raise ValueError("pk file predates the coefficient-form prover; "
                         "re-run keygen")
    device = torch.device(device)
    srs = gen_srs(d["srs_k"], device=device)
    if srs.g1.x.device.type != device.type:
        raise ValueError(f"the SRS for k={d['srs_k']} is held on "
                         f"{srs.g1.x.device}; load the key there")
    if isinstance(d["fixed"], LazyFixedCoeffs):
        fixed = d["fixed"]
        fixed.device = str(srs.g1.x.device)
    else:
        fixed = {k: torch.from_numpy(v).to(srs.g1.x.device)
                 for k, v in d["fixed"].items()}
    return ProvingKey(vk=d["vk"], layout=d["layout"], srs=srs,
                      fixed_coeffs=fixed)


def save_vk(vk, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(vk, f)


def load_vk(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)
