# Copy of zksnap_tpu/trace/context.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""Circuit-builder runtime: the halo2-base equivalent for this framework.

Reference parity (SURVEY.md L2): halo2-base's `BaseCircuitBuilder` /
`Context` / flex-gate / `RangeChip` (voter/src/lib.rs:3-19 imports).  The
reference records circuit cells into a single "vertical" advice column per
thread with the basic gate

    q[i] * (a[i] + a[i+1] * a[i+2] - a[i+3]) == 0

plus copy (permutation) constraints, constants, a range-lookup table and
instance cells.

Storage is struct-of-arrays (VERDICT r4 item 1): advice values live in a
growable `(N, 16)` uint16 limb buffer (the 16x16-bit little-endian limb
layout the device polys use), and gate offsets / copies / constants /
lookups are growable numpy index arrays.  `Cell` handles are transient
NamedTuples carrying the exact python-int witness value for host
arithmetic; they are never stored, so synthesis memory is ~32 bytes/cell
instead of the ~500 bytes/cell of the former boxed-`Cell` + python-int
design (97M wrapper cells: ~3GB instead of ~50-100GB).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..fields.field import PrimeField, bn254_fr


class Cell(NamedTuple):
    """Handle to one advice cell (index into the flat advice vector).

    Transient: Contexts do not retain Cells; the value is the exact
    witness value as a python int for host-side arithmetic."""

    idx: int
    value: int


class LookupTable:
    def __init__(self, bits: int):
        self.bits = bits  # table contains [0, 2^bits)


def u16_rows_to_ints(arr: np.ndarray) -> list[int]:
    """(m, 16) uint16 little-endian limb rows -> list of python ints."""
    arr = np.ascontiguousarray(arr, dtype="<u2")
    b = arr.tobytes()
    return [int.from_bytes(b[i * 32 : (i + 1) * 32], "little")
            for i in range(arr.shape[0])]


class _LimbStore:
    """Growable (N, 16) uint16 limb array with python-int append/get.

    Values must be in [0, 2^256).  Appends buffer python ints and flush
    in blocks via one `to_bytes` blit per value; `limbs()` returns a
    zero-copy view of the flushed buffer."""

    __slots__ = ("_buf", "_nf", "_pending")
    FLUSH = 1 << 14

    def __init__(self):
        self._buf = np.empty((1 << 12, 16), dtype=np.uint16)
        self._nf = 0          # rows flushed into _buf
        self._pending: list[int] = []

    def __len__(self) -> int:
        return self._nf + len(self._pending)

    def append(self, v: int) -> int:
        """Append; returns the new cell's index."""
        idx = self._nf + len(self._pending)
        self._pending.append(v)
        if len(self._pending) >= self.FLUSH:
            self._flush()
        return idx

    def _flush(self):
        m = len(self._pending)
        if not m:
            return
        need = self._nf + m
        if need > self._buf.shape[0]:
            cap = max(need, int(self._buf.shape[0] * 1.5))
            grown = np.empty((cap, 16), dtype=np.uint16)
            grown[: self._nf] = self._buf[: self._nf]
            self._buf = grown
        blob = b"".join(x.to_bytes(32, "little") for x in self._pending)
        self._buf[self._nf : need] = np.frombuffer(
            blob, dtype="<u2").reshape(m, 16)
        self._nf = need
        self._pending.clear()

    def limbs(self) -> np.ndarray:
        """(N, 16) uint16 view of all values (flushes pending first)."""
        self._flush()
        return self._buf[: self._nf]

    def __array__(self, dtype=None, copy=None):
        a = self.limbs()
        return a.astype(dtype) if dtype is not None else a

    def __getitem__(self, i: int) -> int:
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        if i < self._nf:
            return int.from_bytes(self._buf[i].tobytes(), "little")
        return self._pending[i - self._nf]

    def __setitem__(self, i: int, v: int):
        """Overwrite a cell value (negative-path tests tamper witnesses)."""
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        if i < self._nf:
            self._buf[i] = np.frombuffer(v.to_bytes(32, "little"), "<u2")
        else:
            self._pending[i - self._nf] = v


class _IdxStore:
    """Growable int64 index vector (gate offsets, lookups, flat copies)."""

    __slots__ = ("_buf", "_nf", "_pending")
    FLUSH = 1 << 14

    def __init__(self):
        self._buf = np.empty(1 << 12, dtype=np.int64)
        self._nf = 0
        self._pending: list[int] = []

    def __len__(self) -> int:
        return self._nf + len(self._pending)

    def append(self, v: int):
        self._pending.append(v)
        if len(self._pending) >= self.FLUSH:
            self._flush()

    def _flush(self):
        m = len(self._pending)
        if not m:
            return
        need = self._nf + m
        if need > self._buf.shape[0]:
            cap = max(need, int(self._buf.shape[0] * 1.5))
            grown = np.empty(cap, dtype=np.int64)
            grown[: self._nf] = self._buf[: self._nf]
            self._buf = grown
        self._buf[self._nf : need] = self._pending
        self._nf = need
        self._pending.clear()

    def array(self) -> np.ndarray:
        self._flush()
        return self._buf[: self._nf]

    def __array__(self, dtype=None, copy=None):
        a = self.array()
        return a.astype(dtype) if dtype is not None else a

    def __getitem__(self, i: int) -> int:
        return int(self.array()[i])

    def __iter__(self):
        return iter(self.array())


class _PairStore(_IdxStore):
    """(M, 2) int64 pairs (copy constraints), stored flat."""

    def append2(self, i: int, j: int):
        self._pending.append(i)
        self._pending.append(j)
        if len(self._pending) >= self.FLUSH:
            self._flush()

    def __len__(self) -> int:
        return (self._nf + len(self._pending)) // 2

    def pairs(self) -> np.ndarray:
        self._flush()
        return self._buf[: self._nf].reshape(-1, 2)

    def __array__(self, dtype=None, copy=None):
        a = self.pairs()
        return a.astype(dtype) if dtype is not None else a

    def __iter__(self):
        return iter(self.pairs())


class Context:
    """One proving thread's trace (flat advice vector + gate selectors)."""

    def __init__(self, F: PrimeField | None = None, lookup_bits: int = 14,
                 assert_witness: bool = True):
        """assert_witness=False records constraints WITHOUT asserting the
        witness satisfies them -- used for dummy-snark keygen synthesis
        (the reference's CsProxy, wrapper.rs:187-234), where only the
        circuit SHAPE matters and the witness is protocol-shaped garbage."""
        self.F = F or bn254_fr()
        self.p = self.F.p
        self.assert_witness = assert_witness
        self.advice = _LimbStore()           # cell values (limb rows)
        self.gate_offsets = _IdxStore()      # rows where the basic gate is on
        self.copies = _PairStore()           # equality constraints
        self.const_idx = _IdxStore()         # constant-constrained cell idxs
        self.const_vals = _LimbStore()       # parallel constant values
        self.lookups = _IdxStore()           # cell idxs range-checked
        self.lookup_bits = lookup_bits
        self.instance: list[Cell] = []       # public input cells

    # -- raw cell ops -------------------------------------------------------

    def _push(self, v: int) -> Cell:
        v %= self.p
        return Cell(self.advice.append(v), v)

    def load_witness(self, v: int) -> Cell:
        return self._push(v)

    def load_constant(self, v: int) -> Cell:
        c = self._push(v)
        self.const_idx.append(c.idx)
        self.const_vals.append(c.value)
        return c

    def load_zero(self) -> Cell:
        return self.load_constant(0)

    def constrain_equal(self, a: Cell, b: Cell):
        assert not self.assert_witness or a.value == b.value, (
            f"constrain_equal witness mismatch: {a.value} != {b.value}")
        self.copies.append2(a.idx, b.idx)

    def expose_public(self, cell: Cell):
        self.instance.append(cell)

    # -- the vertical basic gate -------------------------------------------
    # rows: | x | y | z | out |  with  x + y*z == out

    def _gate(self, x: Cell | int, y: Cell | int, z: Cell | int,
              out_val: int) -> Cell:
        """Append a 4-cell gate window; ints are constants (auto-loaded as
        copies of existing cells when Cell, constant-constrained otherwise)."""
        self.gate_offsets.append(len(self.advice))
        for operand in (x, y, z):
            if type(operand) is Cell:
                c = self._push(operand.value)
                self.copies.append2(operand.idx, c.idx)
            else:
                c = self._push(operand)
                self.const_idx.append(c.idx)
                self.const_vals.append(c.value)
        return self._push(out_val)

    # -- arithmetic instructions (halo2-base GateInstructions parity) ------

    def add(self, a: Cell, b: Cell) -> Cell:
        return self._gate(a, b, 1, a.value + b.value)

    def sub(self, a: Cell, b: Cell) -> Cell:
        # out + b*1 == a  =>  out = a - b ; out sits in the x slot
        self.gate_offsets.append(len(self.advice))
        out = self._push(a.value - b.value)
        bb = self._push(b.value)
        self.copies.append2(b.idx, bb.idx)
        one = self._push(1)
        self.const_idx.append(one.idx)
        self.const_vals.append(1)
        aa = self._push(a.value)
        self.copies.append2(a.idx, aa.idx)
        return out

    def mul(self, a: Cell, b: Cell) -> Cell:
        return self._gate(0, a, b, a.value * b.value)

    def mul_add(self, a: Cell, b: Cell | int, c: Cell) -> Cell:
        """c + a*b"""
        bval = b.value if type(b) is Cell else b
        return self._gate(c, a, b, c.value + a.value * bval)

    def neg(self, a: Cell) -> Cell:
        return self.sub(self.load_constant(0), a)

    def scalar_mul(self, a: Cell, k: int) -> Cell:
        return self._gate(0, a, k, a.value * k)

    def add_const(self, a: Cell, k: int) -> Cell:
        return self._gate(a, k, 1, a.value + k)

    def select(self, a: Cell, b: Cell, sel: Cell) -> Cell:
        """sel ? a : b  (sel must be a bit): out = b + sel*(a-b)."""
        diff = self.sub(a, b)
        return self.mul_add(diff, sel, b)

    def assert_bit(self, a: Cell):
        """a*(a-1) == 0 : row |0|a|a-1|0| ... expressed as a*a = a."""
        sq = self.mul(a, a)
        self.constrain_equal(sq, a)

    def is_zero(self, a: Cell) -> Cell:
        """Returns 1 if a == 0 else 0, with witness inverse trick."""
        inv = pow(a.value, -1, self.p) if a.value != 0 else 0
        inv_c = self.load_witness(inv)
        prod = self.mul(a, inv_c)           # a * a^-1
        out_val = 1 if a.value == 0 else 0
        out = self.load_witness(out_val)
        # out == 1 - a*inv
        one_minus = self.sub(self.load_constant(1), prod)
        self.constrain_equal(out, one_minus)
        # a * out == 0
        z = self.mul(a, out)
        zero = self.load_constant(0)
        self.constrain_equal(z, zero)
        return out

    def is_equal(self, a: Cell, b: Cell) -> Cell:
        return self.is_zero(self.sub(a, b))

    def inner_product(self, xs: list[Cell], ys: list[Cell | int]) -> Cell:
        acc = self.load_constant(0)
        for x, y in zip(xs, ys):
            acc = self.mul_add(x, y, acc)
        return acc

    def sum(self, xs: list[Cell]) -> Cell:
        acc = self.load_constant(0)
        for x in xs:
            acc = self.add(acc, x)
        return acc

    # -- range chip (halo2-base RangeChip parity) ---------------------------

    def range_check(self, a: Cell, bits: int):
        """Constrain 0 <= a < 2^bits via lookup_bits-wide limb decomposition."""
        assert not self.assert_witness or a.value < (1 << bits), \
            "range_check witness too large"
        lb = self.lookup_bits
        n_limbs = -(-bits // lb)
        rem = bits - (n_limbs - 1) * lb  # width of the top limb
        limbs = [(a.value >> (lb * i)) & ((1 << lb) - 1) for i in range(n_limbs)]
        limb_cells = [self.load_witness(v) for v in limbs]
        # recomposition constraint
        acc = self.load_constant(0)
        for i, lc in enumerate(limb_cells):
            acc = self.mul_add(lc, 1 << (lb * i), acc)
        self.constrain_equal(acc, a)
        # lookups
        for i, lc in enumerate(limb_cells):
            if i < n_limbs - 1 or rem == lb:
                self.lookups.append(lc.idx)
            else:
                # top limb: lookup both limb and limb << (lb - rem)
                self.lookups.append(lc.idx)
                shifted = self.scalar_mul(lc, 1 << (lb - rem))
                self.lookups.append(shifted.idx)

    def check_less_than_safe(self, a: Cell, bound: int):
        """a < bound for a bound < 2^lookup_bits*k: range check a and bound-1-a
        via the standard trick a + (2^bits - bound) < 2^bits."""
        bits = (bound - 1).bit_length() if bound > 1 else 1
        bits = -(-bits // self.lookup_bits) * self.lookup_bits
        shift = (1 << bits) - bound
        shifted = self.add_const(a, shift)
        self.range_check(shifted, bits)
        self.range_check(a, bits)

    def num_to_bits(self, a: Cell, bits: int) -> list[Cell]:
        out = []
        for i in range(bits):
            bit_val = (a.value >> i) & 1
            b = self.load_witness(bit_val)
            self.assert_bit(b)
            out.append(b)
        acc = self.load_constant(0)
        for i, b in enumerate(out):
            acc = self.mul_add(b, 1 << i, acc)
        self.constrain_equal(acc, a)
        return out

    # -- export -------------------------------------------------------------

    def stats(self) -> dict:
        return {
            "advice_cells": len(self.advice),
            "gates": len(self.gate_offsets),
            "copies": len(self.copies),
            "constants": len(self.const_idx),
            "lookups": len(self.lookups),
            "instances": len(self.instance),
        }

    def export(self):
        """-> dict of numpy arrays for the checker/prover."""
        return {
            "advice": self.advice.limbs(),           # (N,16) uint16 limbs
            "gate_offsets": self.gate_offsets.array(),
            "copies": self.copies.pairs(),
            "const_idx": self.const_idx.array(),
            "const_vals": self.const_vals.limbs(),
            "lookups": self.lookups.array(),
            "lookup_bits": self.lookup_bits,
            "instance": [(c.idx, c.value) for c in self.instance],
        }
