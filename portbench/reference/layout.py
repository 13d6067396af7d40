"""The fixed columns and the copy permutation of a synthesized circuit,
worked out again from the circuit's raw record (frozen copy of the
arithmetic of zksnap_tpu_torch/prover/keygen.py `layout_circuit`).

The record is what synthesis hands to keygen, as plain arrays: the
number of advice cells, the rows where the basic gate
q * (a + a[1] * a[2] - a[3]) is on, the equality pairs, the
constant-constrained cells with their values, the range-checked cells and
the public cells.  Advice cells fill columns of `usable = n - 8` rows,
cut where no 4-row gate crosses a cut; the permutation links each class
of equal cells into one cycle in ascending position order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import fr

ZK_ROWS = 8
PERM_CHUNK = 2


@dataclass
class Record:
    n_cells: int
    gates: np.ndarray        # (g,) int64 gate start cells
    copies: np.ndarray       # (c, 2) int64 equal cell pairs
    const_idx: np.ndarray    # (m,) int64 constant-constrained cells
    const_vals: np.ndarray   # (m, 16) uint16 their values
    lookups: np.ndarray      # (l,) int64 range-checked cells
    instance_idx: np.ndarray  # (i,) int64 public cells, in order
    lookup_bits: int


@dataclass
class Fixed:
    k: int
    n: int
    usable: int
    n_advice: int
    n_lookup: int
    lookup_bits: int
    q_rows: list             # per advice column: rows with the gate on
    const_col: np.ndarray    # (n, 16) uint16
    sigma: np.ndarray        # (n_perm, n, 2) int32: (column, row)
    deltas: list

    @property
    def n_perm(self) -> int:
        return self.sigma.shape[0]

    @property
    def ext_log(self) -> int:
        """Extension of the quotient's domain: the logUp term has degree
        n_lookup + 2, a permutation chunk PERM_CHUNK + 2."""
        max_deg = max(3, self.n_lookup + 2, PERM_CHUNK + 2)
        return max(2, (max_deg - 1).bit_length())


def _col_starts(n_cells: int, gates: np.ndarray, usable: int) -> list[int]:
    starts = [0]
    while starts[-1] + usable < n_cells:
        tentative = starts[-1] + usable
        lo = np.searchsorted(gates, tentative - 3)
        cut = tentative
        for g in gates[lo : lo + 4]:
            if g < tentative < g + 4:
                cut = int(g)
                break
        starts.append(cut)
    return starts


def _cycles(ea: list, eb: list, n_perm: int, n: int) -> np.ndarray:
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    sigma = np.empty((n_perm, n, 2), dtype=np.int32)
    sigma[:, :, 0] = np.arange(n_perm, dtype=np.int32)[:, None]
    sigma[:, :, 1] = np.arange(n, dtype=np.int32)[None, :]
    if not ea:
        return sigma
    ei, ej = np.concatenate(ea), np.concatenate(eb)
    # the positions on some edge, ascending, and each one's rank among them
    touched = np.zeros(n_perm * n, dtype=bool)
    touched[ei] = True
    touched[ej] = True
    nodes = np.flatnonzero(touched)
    rank = np.empty(n_perm * n, dtype=np.int64)
    rank[nodes] = np.arange(len(nodes))
    a, b = rank[ei], rank[ej]
    g = coo_matrix((np.ones(len(a), np.int8), (a, b)),
                   shape=(len(nodes), len(nodes)))
    _, labels = connected_components(g, directed=False)
    # each class a cycle through its positions in ascending order
    order = np.argsort(labels, kind="stable")
    sl = labels[order]
    starts = np.flatnonzero(np.r_[True, sl[1:] != sl[:-1]])
    ends = np.r_[starts[1:], len(order)]
    nxt = np.arange(1, len(order) + 1)
    nxt[ends - 1] = starts
    u, v = nodes[order], nodes[order[nxt]]
    sigma[u // n, u % n, 0] = v // n
    sigma[u // n, u % n, 1] = v % n
    return sigma


def fixed_columns(rec: Record, k: int) -> Fixed:
    n = 1 << k
    usable = n - ZK_ROWS
    gates = np.sort(np.asarray(rec.gates, dtype=np.int64))
    starts = _col_starts(rec.n_cells, gates, usable)
    n_advice = len(starts)
    bounds = starts + [rec.n_cells]
    col_of = np.zeros(rec.n_cells, dtype=np.int64)
    row_of = np.zeros(rec.n_cells, dtype=np.int64)
    q_rows = []
    for c in range(n_advice):
        s, e = bounds[c], bounds[c + 1]
        col_of[s:e] = c
        row_of[s:e] = np.arange(e - s)
        gsel = gates[(gates >= s) & (gates < e)]
        if len(gsel) and gsel[-1] + 4 > e:
            raise ValueError("a gate crosses a column boundary")
        q_rows.append(gsel - s)

    # constants: distinct values in order of first occurrence, and 0
    cidx = np.asarray(rec.const_idx, dtype=np.int64)
    if len(cidx):
        rows = np.ascontiguousarray(rec.const_vals, dtype=np.uint16)
        _, first, inv = np.unique(rows.view(np.dtype((np.void, 32))).ravel(),
                                  return_index=True, return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(len(order), dtype=np.int64)
        rank[order] = np.arange(len(order))
        const_row = rank[inv.ravel()]
        vals = rows[first[order]]
    else:
        vals = np.empty((0, 16), np.uint16)
        const_row = np.empty(0, np.int64)
    if len(vals) > usable:
        raise ValueError("too many constants for one column")
    if not (vals == 0).all(axis=1).any() and len(vals) < usable:
        vals = np.vstack([vals, np.zeros((1, 16), np.uint16)])
    const_col = np.zeros((n, 16), dtype=np.uint16)
    const_col[: len(vals)] = vals

    if rec.lookup_bits >= k:
        raise ValueError("the lookup table does not fit the domain")
    lk = np.asarray(rec.lookups, dtype=np.int64)
    n_lookup = max(1, -(-len(lk) // usable)) if len(lk) else 0

    # permutation columns: advice..., lookup..., const, instance
    n_perm = n_advice + n_lookup + 2
    pos = col_of * n + row_of
    const_base = (n_advice + n_lookup) * n
    inst_base = (n_advice + n_lookup + 1) * n
    ea, eb = [], []
    cp = np.asarray(rec.copies, dtype=np.int64).reshape(-1, 2)
    if len(cp):
        ea.append(pos[cp[:, 0]])
        eb.append(pos[cp[:, 1]])
    if len(cidx):
        ea.append(pos[cidx])
        eb.append(const_base + const_row)
    if len(lk):
        t = np.arange(len(lk), dtype=np.int64)
        ea.append((n_advice + t // usable) * n + t % usable)
        eb.append(pos[lk])
    inst = np.asarray(rec.instance_idx, dtype=np.int64)
    if len(inst):
        ea.append(inst_base + np.arange(len(inst), dtype=np.int64))
        eb.append(pos[inst])
    sigma = _cycles(ea, eb, n_perm, n)

    delta = pow(fr.GENERATOR, 1 << fr.TWO_ADICITY, fr.P)
    return Fixed(k=k, n=n, usable=usable, n_advice=n_advice,
                 n_lookup=n_lookup, lookup_bits=rec.lookup_bits,
                 q_rows=q_rows, const_col=const_col, sigma=sigma,
                 deltas=[pow(delta, j, fr.P) for j in range(n_perm)])
