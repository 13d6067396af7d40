"""Warm-up for the proving pipeline (PyTorch port of
zksnap_tpu/prover/warmup.py).

The JAX package compiles one XLA program per shape, so its `warm_prove`
fires every program keygen and prove need, on dummy inputs, before the
first proof.  The port compiles nothing per shape: its kernels are one
library, built once per source hash (`kernels.build`), and PyTorch runs
eagerly.  What a first keygen and prove still pay for is the library's
load, the first use of each PyTorch kernel (CUDA loads modules lazily),
the device tables cached per domain (twiddles, omega powers, the mesh's
shard scales and layout permutations) and the caching allocator's first
allocation of each size.  `warm_prove` runs each device task of keygen
and prove once, on dummy inputs at the circuit's shapes and under the
mesh when one is given, so that a later keygen and prove start from
that state.

The tasks run one after another in the calling thread: with nothing to
compile, a thread pool would only interleave launches on one stream.
The dummy values are garbage on purpose; only the shapes matter.
"""

from __future__ import annotations

import contextlib
import time

import torch

from ..curves.jacobian import JacPoint
from ..fields.common import N_LIMBS
from ..fields.field import bn254_fr
from .keygen import PERM_CHUNK, layout_circuit, quotient_ext_log

FR = bn254_fr()


def warm_prove(ctx, k: int, mesh=None, mesh_axis: str = "x",
               verbose: bool = False, device="cuda"):
    """Run every device task keygen + prove will need for the circuit in
    `ctx` at domain size 2^k once on `device`.  Returns per-task seconds
    under the JAX package's task names."""
    from .. import kernels
    from ..poly.domain import domain
    from . import plonk
    from . import poly_device as pd
    from .device_rounds import _omega_pows_dev, compute_h_dev, compute_z_dev

    dev = torch.device(device)
    layout = layout_circuit(ctx, k)
    n = 1 << k
    n_perm = len(layout.perm_columns)
    n_z = -(-n_perm // PERM_CHUNK)
    e_log = quotient_ext_log(layout.n_lookup)
    E = 1 << e_log

    names = (
        [f"advice_{i}" for i in range(layout.n_advice)]
        + [f"lookup_{i}" for i in range(layout.n_lookup)]
        + [f"z_{c}" for c in range(n_z)]
        + ["m", "h", "instance"]
        + [f"q_{i}" for i in range(layout.n_advice)]
        + ["const", "table", "active"]
        + [f"sigma_{j}" for j in range(n_perm)]
    )

    vk = plonk.VerifyingKey(
        k=k, ext_log=e_log, n_advice=layout.n_advice,
        n_lookup=layout.n_lookup, lookup_bits=layout.lookup_bits,
        n_perm=n_perm, n_z=n_z, usable=layout.usable,
        deltas=layout.deltas, num_instance=len(ctx.instance),
        commitments={}, omega=0,
    )
    by_point = {}
    for nm, pt in sorted(plonk._query_plan(vk, E)):
        by_point.setdefault(pt, []).append(nm)

    def dummy():
        return torch.ones((n, N_LIMBS), dtype=torch.int32, device=dev)

    def dummy16():
        """At-rest (packed) poly stand-in: prove-time coefficients rest
        in the int16 form (poly_device.pack_poly)."""
        return pd.pack_poly(dummy())

    def scalar():
        return FR.one_t(dev)

    def run(name, fn):
        t0 = time.time()
        with (pd.prover_mesh(mesh, mesh_axis) if mesh is not None
              else contextlib.nullcontext()):
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        if verbose:
            print(f"  warm {name}: {dt:.3f}s", flush=True)
        return dt

    def w_to_mont():
        if dev.type == "cuda":
            kernels.library()  # builds the kernels if this source has none
        pd.to_device_poly([1] * n, dev)

    def w_commit():
        zeros = torch.zeros((n, N_LIMBS), dtype=torch.int32, device=dev)
        pd.commit_evals(JacPoint(zeros, zeros, zeros),
                        pd.mont_to_canonical(dummy()))

    def w_ntts():
        dom = domain(k)
        dom.twiddles(dev)
        dom.twiddles_inv(dev)
        x = dummy()
        pd.evals_to_coeffs(x, k)
        pd.coeffs_to_evals(x, k)
        pd.coeffs_to_evals(dummy16(), k)      # packed at-rest inputs
        pd.coset_evals(dummy16(), x, k)

    def w_interp():
        # per-coset chunk interpolation (plonk._quotient tail)
        u = pd.evals_to_coeffs(dummy(), k)
        v = FR.mul(u, pd.pow_series_uncached(FR.generator, n, dev))
        FR.add(FR.mul(v, scalar()[None, :]), v)

    def w_h():
        if layout.n_lookup:
            compute_h_dev(k, [dummy() for _ in range(layout.n_lookup)],
                          dummy(), dummy(), 1)

    def w_z():
        _omega_pows_dev(k, dev)
        compute_z_dev(layout, lambda j: dummy(), lambda j: dummy(), 1, 1)

    def w_quotient():
        y = scalar()
        omega_pows = pd.pow_series(domain(k).omega, n, dev)
        s, zh, zhinv, wu = plonk._coset_scalars(k, e_log, 0, layout.usable,
                                                dev)
        x_dev, l0, lu = plonk._coset_tables(k, omega_pows, s, zh, wu)
        t = torch.zeros((n, N_LIMBS), dtype=torch.int32, device=dev)
        t = plonk._gate_term(t, dummy(), dummy(), y)
        if layout.n_lookup:
            t = plonk._logup_term(t, dummy(), dummy(), dummy(),
                                  [dummy()] * layout.n_lookup, y, y)
        for sz in sorted({len(ch) for ch in plonk._perm_chunks(n_perm)}):
            t = plonk._perm_term(t, dummy(), x_dev, dummy(), [dummy()] * sz,
                                 [dummy()] * sz, [y] * sz, y, y, y)
        t = plonk._lagrange_z_term(t, dummy(), l0, y)
        t = plonk._lagrange_z_term(t, dummy(), lu, y)
        if n_z > 1:
            t = plonk._chain_term(t, dummy(), dummy(), l0, y, layout.usable)
        FR.mul(t, zhinv[None, :])

    def w_evals():
        # round 4 runs in 16-poly chunks; warm the full chunk + remainder
        total = len(names) + 1
        for sz in sorted({min(16, total), total % 16 or 16}):
            pd.eval_coeffs_list([dummy16() for _ in range(sz)], 3, k)

    def w_rlc():
        pd.rlc_list([dummy() for _ in range(E)], list(range(1, E + 1)), k)
        sizes = set()
        for pt_names in by_point.values():
            s = len(pt_names)
            sizes.add(min(16, s))
            sizes.add(s % 16 or 16)
        for sz in sorted(sizes):
            pd.rlc_list([dummy16() for _ in range(sz)],
                        list(range(1, sz + 1)), k)

    def w_open():
        pd.opening_witness_evals(dummy(), 3, 5, k)

    def w_sigma():
        next(iter(plonk._sigma_values_dev(layout, dev)))

    tasks = [
        ("to_mont", w_to_mont),
        ("commit", w_commit),
        ("ntts", w_ntts),
        ("interp", w_interp),
        ("z", w_z),
        ("h", w_h),
        ("quotient", w_quotient),
        ("evals", w_evals),
        ("rlc", w_rlc),
        ("open", w_open),
        ("sigma", w_sigma),
    ]
    return {nm: run(nm, fn) for nm, fn in tasks}
