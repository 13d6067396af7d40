# Copy of zksnap_tpu/gadgets/sha256.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""In-circuit SHA-256 (bit-level).

Reference parity: halo2-ecc's secp256k1 `Sha256Chip` used by plume-halo2
for the Fiat-Shamir challenge and hash-to-curve expansion
(voter/src/lib.rs:166, :276-283 via `verify_plume`).

Words are lists of 32 bit-cells (LSB first).  Bitwise ops are arithmetic
gates (xor: a+b-2ab; ch: g + e*(f-g); maj: ab + c*(a+b-2ab)); rotations
are free reindexing; modular adds witness the carry bits.  A
spread/lookup-table variant is the planned fast path; this one is simple
and checker-verified.  Message length must be static at synthesis time.
"""

from __future__ import annotations

from ..trace.context import Cell, Context

H_INIT = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
          0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

Word = list  # 32 bit-cells, LSB first


class Sha256Gadget:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self._zero = ctx.load_constant(0)
        self._one = ctx.load_constant(1)

    # -- word helpers --------------------------------------------------------

    def const_word(self, v: int) -> Word:
        return [self._one if (v >> i) & 1 else self._zero for i in range(32)]

    def word_value(self, w: Word) -> int:
        return sum(c.value << i for i, c in enumerate(w))

    def _xor_bit(self, a: Cell, b: Cell) -> Cell:
        ctx = self.ctx
        t = ctx.mul(a, b)
        s = ctx.add(a, b)
        return ctx.mul_add(t, ctx.p - 2, s)

    def xor(self, a: Word, b: Word) -> Word:
        return [self._xor_bit(x, y) for x, y in zip(a, b)]

    def rotr(self, a: Word, r: int) -> Word:
        # value bits LSB-first: rotr(v, r) bit i = bit (i + r) % 32 of v
        return [a[(i + r) % 32] for i in range(32)]

    def shr(self, a: Word, r: int) -> Word:
        return [a[i + r] if i + r < 32 else self._zero for i in range(32)]

    def _ch(self, e: Word, f: Word, g: Word) -> Word:
        # per bit: g + e*(f-g)
        ctx = self.ctx
        out = []
        for eb, fb, gb in zip(e, f, g):
            d = ctx.sub(fb, gb)
            out.append(ctx.mul_add(eb, d, gb))
        return out

    def _maj(self, a: Word, b: Word, c: Word) -> Word:
        ctx = self.ctx
        out = []
        for ab, bb, cb in zip(a, b, c):
            t = ctx.mul(ab, bb)
            s = ctx.add(ab, bb)
            s2 = ctx.mul_add(t, ctx.p - 2, s)  # a+b-2ab
            u = ctx.mul(cb, s2)
            out.append(ctx.add(t, u))
        return out

    def _add_words(self, words: list[Word]) -> Word:
        """Sum mod 2^32: recompose, add, decompose to 32+carry bits."""
        ctx = self.ctx
        total = 0
        acc = ctx.load_constant(0)
        for w in words:
            val = self.word_value(w)
            total += val
            # recompose word into a field cell
            cell = ctx.load_constant(0)
            for i, b in enumerate(w):
                cell = ctx.mul_add(b, 1 << i, cell)
            acc = ctx.add(acc, cell)
        n_extra = max(1, (len(words) - 1).bit_length())
        out_bits = []
        rem = total
        recomposed = ctx.load_constant(0)
        for i in range(32 + n_extra):
            bv = (total >> i) & 1
            b = ctx.load_witness(bv)
            ctx.assert_bit(b)
            recomposed = ctx.mul_add(b, 1 << i, recomposed)
            if i < 32:
                out_bits.append(b)
        ctx.constrain_equal(recomposed, acc)
        return out_bits

    # -- compression ---------------------------------------------------------

    def _compress(self, state: list[Word], block: list[Word]) -> list[Word]:
        ctx = self.ctx
        w = list(block)  # 16 words
        for t in range(16, 64):
            s0 = self.xor(self.xor(self.rotr(w[t - 15], 7),
                                   self.rotr(w[t - 15], 18)),
                          self.shr(w[t - 15], 3))
            s1 = self.xor(self.xor(self.rotr(w[t - 2], 17),
                                   self.rotr(w[t - 2], 19)),
                          self.shr(w[t - 2], 10))
            w.append(self._add_words([w[t - 16], s0, w[t - 7], s1]))

        a, b, c, d, e, f, g, h = state
        for t in range(64):
            S1 = self.xor(self.xor(self.rotr(e, 6), self.rotr(e, 11)),
                          self.rotr(e, 25))
            ch = self._ch(e, f, g)
            temp1 = self._add_words([h, S1, ch, self.const_word(K[t]), w[t]])
            S0 = self.xor(self.xor(self.rotr(a, 2), self.rotr(a, 13)),
                          self.rotr(a, 22))
            maj = self._maj(a, b, c)
            temp2 = self._add_words([S0, maj])
            h = g
            g = f
            f = e
            e = self._add_words([d, temp1])
            d = c
            c = b
            b = a
            a = self._add_words([temp1, temp2])

        return [self._add_words([x, y])
                for x, y in zip([a, b, c, d, e, f, g, h], state)]

    # -- public API ----------------------------------------------------------

    def hash_bits(self, msg_bits: list[Cell]) -> list[Cell]:
        """msg_bits: the message as bit-cells, MSB-first within each byte,
        bytes in order (i.e., the SHA-256 bit string).  Length static.
        Returns 256 digest bits (MSB-first bit string)."""
        L = len(msg_bits)
        # padding: 1, zeros, 64-bit length
        padded = list(msg_bits)
        padded.append(self._one)
        while (len(padded) + 64) % 512 != 0:
            padded.append(self._zero)
        for i in range(63, -1, -1):
            padded.append(self._one if (L >> i) & 1 else self._zero)
        assert len(padded) % 512 == 0

        state = [self.const_word(v) for v in H_INIT]
        for blk in range(len(padded) // 512):
            bits = padded[blk * 512 : (blk + 1) * 512]
            words = []
            for wi in range(16):
                wb = bits[wi * 32 : (wi + 1) * 32]  # MSB-first
                words.append(list(reversed(wb)))    # -> LSB-first
            state = self._compress(state, words)

        out = []
        for wd in state:
            out.extend(reversed(wd))  # back to MSB-first bit string
        return out

    def bytes_to_bits(self, byte_cells: list[Cell]) -> list[Cell]:
        """Decompose byte cells (values 0..255) into MSB-first bits."""
        ctx = self.ctx
        bits = []
        for bc in byte_cells:
            bb = ctx.num_to_bits(bc, 8)  # LSB-first
            bits.extend(reversed(bb))
        return bits

    def bits_to_bytes(self, bits: list[Cell]) -> list[Cell]:
        ctx = self.ctx
        out = []
        for i in range(0, len(bits), 8):
            acc = ctx.load_constant(0)
            for j, b in enumerate(bits[i : i + 8]):  # MSB-first
                acc = ctx.mul_add(b, 1 << (7 - j), acc)
            out.append(acc)
        return out
