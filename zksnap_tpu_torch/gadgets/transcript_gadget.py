# Copy of zksnap_tpu/gadgets/transcript_gadget.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""In-circuit Poseidon Fiat-Shamir transcript + proof-stream witnessing.

The recursion circuit's half of snark-verifier's `PoseidonTranscript<
Halo2Loader, _>` (wrapper.rs:59,302-359): replays the EXACT absorption
schedule of the native transcript (prover/transcript.py) over circuit
cells, so squeezed challenge cells carry the same values the native
verifier derived -- and the constraints force any accepted witness to
agree with Fiat-Shamir.

Two pieces:
  * TranscriptGadget -- duplex sponge over cells (mirrors
    hash/poseidon.py `PoseidonNative` update/squeeze, incl. buffering
    and the pad-with-1 rule);
  * ProofReader -- walks a proof byte stream, witnessing scalars as Fr
    cells and points as non-native BN254-G1 points (gadgets/ecc.py
    NNPoint over the Fq NonNativeChip), absorbing each element exactly
    as the native reader does: scalars as one element, points as their
    LimbsEncoding<3,88> limbs (which ARE the NNElement limb cells, so
    absorption needs no reduction gadget).
"""

from __future__ import annotations

from ..curves.native import BN254_G1
from ..hash.poseidon import CAP_TAG
from ..trace.context import Cell, Context
from .ecc import EccGadget, NNPoint
from .nonnative import NonNativeChip
from .poseidon_gadget import PoseidonGadget


class TranscriptGadget:
    """Duplex sponge over circuit cells (PoseidonNative parity)."""

    def __init__(self, ctx: Context, pg: PoseidonGadget | None = None):
        self.ctx = ctx
        self.pg = pg or PoseidonGadget(ctx)
        t = self.pg.spec.t
        self.state = [ctx.load_constant(CAP_TAG % ctx.p)] + [
            ctx.load_constant(0) for _ in range(t - 1)
        ]
        self.absorbing: list[Cell] = []

    def update(self, cells: list[Cell]):
        buf = self.absorbing + list(cells)
        self.absorbing = []
        rate = self.pg.spec.rate
        while len(buf) >= rate:
            chunk, buf = buf[:rate], buf[rate:]
            self._absorb_chunk(chunk)
        self.absorbing = buf

    def _absorb_chunk(self, chunk: list[Cell]):
        ctx = self.ctx
        state = list(self.state)
        for i, v in enumerate(chunk):
            state[i + 1] = ctx.add(state[i + 1], v)
        self.state = self.pg.permute(state)

    def squeeze(self) -> Cell:
        last = self.absorbing + [self.ctx.load_constant(1)]
        self.absorbing = []
        rate = self.pg.spec.rate
        while len(last) > rate:
            chunk, last = last[:rate], last[rate:]
            self._absorb_chunk(chunk)
        self._absorb_chunk(last)
        return self.state[1]


class ProofReader:
    """Witness a proof byte stream into the circuit, absorbing as it goes.

    `fq` must be a NonNativeChip over the BN254 BASE field (coordinates);
    scalars are native Fr cells.  Soundness: every witnessed point is
    constrained on-curve-or-identity, identity iff (x, y) == (0, 0);
    every witnessed scalar/coordinate is range-derived canonical by the
    NonNativeChip / trusted (< r) as parsed from the honest stream --
    scalar canonicity needs no constraint because the cell IS the Fr
    value (native field).
    """

    def __init__(self, ctx: Context, tg: TranscriptGadget,
                 fq: NonNativeChip, ecc: EccGadget, proof: bytes):
        assert fq.m == BN254_G1.p
        self.ctx = ctx
        self.tg = tg
        self.fq = fq
        self.ecc = ecc
        self.data = proof
        self.pos = 0

    def _take(self, n: int) -> bytes:
        assert self.pos + n <= len(self.data), "proof stream truncated"
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def done(self) -> bool:
        return self.pos == len(self.data)

    # -- elements -------------------------------------------------------------

    def absorb_scalar_cell(self, c: Cell):
        """Bind an already-assigned cell (instances, recomputed values)."""
        self.tg.update([c])

    def absorb_point(self, p: NNPoint):
        """Bind an already-assigned point (accumulator fold replays)."""
        self.tg.update(list(p.x.limbs) + list(p.y.limbs))

    def read_scalar(self) -> Cell:
        v = int.from_bytes(self._take(32), "little")
        c = self.ctx.load_witness(v)
        self.tg.update([c])
        return c

    def read_point(self) -> NNPoint:
        ctx, fq = self.ctx, self.fq
        x = int.from_bytes(self._take(32), "little")
        y = int.from_bytes(self._take(32), "little")
        nx = fq.assign(x % fq.m)
        ny = fq.assign(y % fq.m)
        # identity iff x == y == 0 (wire convention, transcript.py)
        is_inf = ctx.mul(fq.is_zero(nx), fq.is_zero(ny))
        p = NNPoint(nx, ny, is_inf)
        self.ecc.assert_on_curve(p)  # passes vacuously for the identity
        self.tg.update(list(nx.limbs) + list(ny.limbs))
        return p

    def challenge(self) -> Cell:
        return self.tg.squeeze()
