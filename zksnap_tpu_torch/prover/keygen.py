# Copy of zksnap_tpu/prover/keygen.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""Circuit layout + proving/verifying key generation.

Reference parity: halo2_proofs `keygen_vk`/`keygen_pk` +
`BaseCircuitBuilder`'s column assignment (SURVEY.md L1/L2; used at
wrapper.rs:106-109).  Takes a synthesized trace Context and a domain size
k and produces:

  * the column layout -- advice cells packed column-major into columns of
    height `usable = n - ZK_ROWS`, with break points chosen so no 4-cell
    gate window crosses a column boundary (halo2-base "break points");
  * fixed columns: per-advice-column gate selectors q_c, one constants
    column, the lookup table column;
  * lookup-advice columns (cells range-checked get copied there) and the
    logUp multiplicity column;
  * the copy-constraint permutation sigma over all involved columns
    (copy cycles -> sigma_j(w^i) = delta^{j'} w^{i'});
  * commitments to all fixed/sigma columns (the verifying key).

Everything here is vectorized numpy + scipy connected-components
(VERDICT r4 item 1: the former python union-find over n_perm*n boxed
ints was hours of single-core work and ~50GB RSS at the wrapper's 97M
cells; this version is seconds-to-minutes and ~2GB).  The resulting
sigma is BIT-IDENTICAL to the old builder (cycle members linked in
ascending position order, constants deduped in first-occurrence order),
so the frozen protocol vectors (tests/vectors/transcript_v1.json) are
unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fields.field import bn254_fr
from ..trace.context import Context

FR = bn254_fr()
ZK_ROWS = 8
PERM_CHUNK = 2  # columns per permutation grand-product poly (degree 4 constraint)


def quotient_ext_log(n_lookup: int) -> int:
    """Extended-domain log factor for the quotient: the logUp argument of
    n_lookup columns has degree n_lookup + 2, the chained permutation
    PERM_CHUNK + 2; E = 2^ext_log must cover max_deg - 1.  Single source
    of truth for keygen, the wrapper shape solve, warmup and probes
    (6-column budget = degree 8 = E 8)."""
    assert n_lookup <= 6, "logUp constraint degree budget"
    max_deg = max(3, n_lookup + 2, PERM_CHUNK + 2)
    return max(2, (max_deg - 1).bit_length())
PERM_COLS_NAME = ("advice", "lookup", "const", "instance")


@dataclass
class Layout:
    k: int
    n: int
    usable: int
    n_advice: int
    n_lookup: int
    lookup_bits: int
    col_starts: list[int]          # flat-cell start index of each advice col
    cell_map: np.ndarray           # [n_cells, 2] int32 -> (col, row)
    # advice/lookup witness data: one (N,16) uint16 limb buffer + the
    # lookup cell-index vector; padded per-column views come from
    # `advice_col` / `lookup_col` (materializing all columns up front
    # doubled host RSS at wrapper scale)
    advice_limbs: np.ndarray       # (n_cells, 16) uint16, canonical
    lookup_idx: np.ndarray         # (n_lookups,) int64 cell indices
    q_cols: list[np.ndarray]       # per advice col: (n,) uint8 selector
    active_col: list[int]
    const_col: np.ndarray          # (n, 16) uint16 canonical limb rows
    table_col: list[int]
    instance_col: list[int]
    multiplicity: list[int]
    # permutation
    perm_columns: list[tuple[str, int]]  # ordered involved columns
    sigma: np.ndarray              # [n_perm_cols, n, 2] int32 -> (col_idx, row)
    deltas: list[int]              # coset shift per perm column

    def advice_col(self, c: int) -> np.ndarray:
        """Advice column c as a zero-padded (n, 16) uint16 limb array."""
        bounds = self.col_starts + [self.advice_limbs.shape[0]]
        s, e = bounds[c], bounds[c + 1]
        out = np.zeros((self.n, 16), dtype=np.uint16)
        out[: e - s] = self.advice_limbs[s:e]
        return out

    def lookup_col(self, c: int) -> np.ndarray:
        """Lookup-advice column c as a zero-padded (n, 16) uint16 array."""
        idx = self.lookup_idx[c * self.usable : (c + 1) * self.usable]
        out = np.zeros((self.n, 16), dtype=np.uint16)
        out[: len(idx)] = self.advice_limbs[idx]
        return out


def _lookup_values_small(advice_limbs: np.ndarray,
                         lookup_idx: np.ndarray) -> np.ndarray:
    """Lookup cell values as int64 (all are < 2^32 by construction: range
    limbs are masked to lookup_bits; the shifted-top-limb entries stay
    below 2^(2*lookup_bits))."""
    rows = advice_limbs[lookup_idx]
    return rows[:, 0].astype(np.int64) | (rows[:, 1].astype(np.int64) << 16)


def _multiplicity_counts(advice_limbs: np.ndarray, lookup_idx: np.ndarray,
                         n_lookup: int, n: int) -> list[int]:
    """logUp multiplicity column: bincount of every lookup column entry,
    counting the zero padding rows of each column (old-builder parity).
    Out-of-table values (possible only under dummy keygen synthesis,
    where the multiplicity is witness garbage anyway) are clipped to 0."""
    if not n_lookup:
        return [0] * n
    vals = _lookup_values_small(advice_limbs, lookup_idx)
    vals = np.where(vals < n, vals, 0)
    mult = np.bincount(vals, minlength=n)
    mult[0] += n_lookup * n - len(lookup_idx)  # padding zeros
    return mult.tolist()


def _advice_col_starts(n_cells: int, gates: np.ndarray, usable: int) -> list[int]:
    """Break advice cells into columns at gate-aligned boundaries."""
    col_starts = [0]
    while col_starts[-1] + usable < n_cells:
        tentative = col_starts[-1] + usable
        # find gates straddling [tentative-3, tentative): move cut to gate start
        lo = np.searchsorted(gates, tentative - 3)
        cut = tentative
        for g in gates[lo : lo + 4]:
            if g < tentative < g + 4:
                cut = int(g)
                break
        col_starts.append(cut)
    return col_starts


def _link_cycles(positions_a: list[np.ndarray], positions_b: list[np.ndarray],
                 n_perm: int, n: int) -> np.ndarray:
    """Copy-constraint equivalence classes -> sigma permutation.

    positions_a[i] <-> positions_b[i] are equal-cell edges in flat
    position ids (perm_col * n + row).  Classes come from scipy
    connected-components over the compacted edge graph; each class is
    linked into a cycle in ascending position order (exactly the cycle
    order the former python union-find builder produced, which the
    frozen protocol vectors pin)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    ei = np.concatenate(positions_a) if positions_a else np.empty(0, np.int64)
    ej = np.concatenate(positions_b) if positions_b else np.empty(0, np.int64)

    sigma = np.empty((n_perm, n, 2), dtype=np.int32)
    sigma[:, :, 0] = np.arange(n_perm, dtype=np.int32)[:, None]
    sigma[:, :, 1] = np.arange(n, dtype=np.int32)[None, :]
    if not len(ei):
        return sigma

    nodes = np.unique(np.concatenate([ei, ej]))
    a = np.searchsorted(nodes, ei)
    b = np.searchsorted(nodes, ej)
    g = coo_matrix((np.ones(len(a), np.int8), (a, b)),
                   shape=(len(nodes), len(nodes)))
    _, labels = connected_components(g, directed=False)

    order = np.argsort(labels, kind="stable")  # ascending node id per class
    sorted_labels = labels[order]
    starts = np.flatnonzero(
        np.r_[True, sorted_labels[1:] != sorted_labels[:-1]])
    ends = np.r_[starts[1:], len(order)]
    nxt = np.arange(1, len(order) + 1)
    nxt[ends - 1] = starts                     # wrap each cycle
    u = nodes[order]
    v = nodes[order[nxt]]
    sigma[u // n, u % n, 0] = v // n
    sigma[u // n, u % n, 1] = v % n
    return sigma


def layout_circuit(ctx: Context, k: int) -> Layout:
    n = 1 << k
    usable = n - ZK_ROWS
    adv = ctx.advice.limbs()                   # (N,16) uint16 view
    n_cells = adv.shape[0]
    gates = np.sort(ctx.gate_offsets.array())

    # --- break advice cells into columns at gate-aligned boundaries --------
    col_starts = _advice_col_starts(n_cells, gates, usable)
    n_advice = len(col_starts)

    cell_map = np.empty((n_cells, 2), dtype=np.int32)
    q_cols = []
    bounds = col_starts + [n_cells]
    for c in range(n_advice):
        s, e = bounds[c], bounds[c + 1]
        cell_map[s:e, 0] = c
        cell_map[s:e, 1] = np.arange(e - s, dtype=np.int32)
        q = np.zeros(n, dtype=np.uint8)
        gsel = gates[(gates >= s) & (gates < e)]
        assert not len(gsel) or gsel[-1] + 4 <= e, "gate crosses column boundary"
        q[gsel - s] = 1
        q_cols.append(q)

    # --- constants column (first-occurrence dedup order, old-builder parity)
    const_idx = ctx.const_idx.array()
    cval_rows = ctx.const_vals.limbs()
    if len(const_idx):
        uniq, first, inv = np.unique(cval_rows, axis=0, return_index=True,
                                     return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(len(order), dtype=np.int64)
        rank[order] = np.arange(len(order))
        const_row_of = rank[inv.ravel()]       # constants-entry -> const row
        uniq_ordered = uniq[order]
    else:
        uniq_ordered = np.empty((0, 16), np.uint16)
        const_row_of = np.empty(0, np.int64)
    n_const = uniq_ordered.shape[0]
    assert n_const <= usable, "too many constants for one column"
    # make sure 0 is in the column (padding) for lookup-col padding copies
    if not (uniq_ordered == 0).all(axis=1).any() and n_const < usable:
        uniq_ordered = np.vstack([uniq_ordered,
                                  np.zeros((1, 16), np.uint16)])
        n_const += 1
    const_col = np.zeros((n, 16), dtype=np.uint16)
    const_col[:n_const] = uniq_ordered

    # --- lookup advice columns + table + multiplicities --------------------
    lookup_bits = ctx.lookup_bits
    assert lookup_bits < k, "lookup table must fit in the domain"
    lookup_idx = ctx.lookups.array().copy()
    n_lk = len(lookup_idx)
    n_lookup = max(1, -(-n_lk // usable)) if n_lk else 0
    table_col = list(range(1 << lookup_bits)) + [0] * (n - (1 << lookup_bits))
    multiplicity = _multiplicity_counts(adv, lookup_idx, n_lookup, n)

    # --- instance column ----------------------------------------------------
    instance_col = [c.value for c in ctx.instance] + [0] * (n - len(ctx.instance))
    assert len(ctx.instance) <= usable

    # --- permutation active-rows selector (rows < usable) -------------------
    active_col = [1] * usable + [0] * (n - usable)

    # --- permutation cycles -------------------------------------------------
    # involved columns in order: advice..., lookup..., const, instance
    perm_columns = (
        [("advice", c) for c in range(n_advice)]
        + [("lookup", c) for c in range(n_lookup)]
        + [("const", 0), ("instance", 0)]
    )
    n_perm = len(perm_columns)
    adv_pos = (cell_map[:, 0].astype(np.int64) * n
               + cell_map[:, 1].astype(np.int64))
    const_base = (n_advice + n_lookup) * n
    inst_base = (n_advice + n_lookup + 1) * n

    copies = ctx.copies.pairs()
    ea, eb = [], []
    if len(copies):
        ea.append(adv_pos[copies[:, 0]])
        eb.append(adv_pos[copies[:, 1]])
    if len(const_idx):
        ea.append(adv_pos[const_idx])
        eb.append(const_base + const_row_of)
    if n_lk:
        t = np.arange(n_lk, dtype=np.int64)
        ea.append((n_advice + t // usable) * n + t % usable)
        eb.append(adv_pos[lookup_idx])
    if ctx.instance:
        iidx = np.asarray([c.idx for c in ctx.instance], dtype=np.int64)
        ea.append(inst_base + np.arange(len(iidx), dtype=np.int64))
        eb.append(adv_pos[iidx])
    sigma = _link_cycles(ea, eb, n_perm, n)

    # coset shifts delta^j (delta = odd-order generator component)
    delta = pow(FR.generator, 1 << FR.two_adicity, FR.p)
    deltas = [pow(delta, j, FR.p) for j in range(n_perm)]

    return Layout(
        k=k, n=n, usable=usable, n_advice=n_advice, n_lookup=n_lookup,
        lookup_bits=lookup_bits, col_starts=col_starts, cell_map=cell_map,
        advice_limbs=adv, lookup_idx=lookup_idx,
        q_cols=q_cols, active_col=active_col,
        const_col=const_col, table_col=table_col,
        instance_col=instance_col, multiplicity=multiplicity,
        perm_columns=perm_columns, sigma=sigma, deltas=deltas,
    )
