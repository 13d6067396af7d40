# Copy of zksnap_tpu/gadgets/plume_gadget.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""In-circuit PLUME V1 nullifier verification.

Reference parity: plume-halo2 `verify_plume` / `PlumeInput`
(voter/src/lib.rs:33,276-283): recompute the Fiat-Shamir challenge

    c' = SHA256(g || pk || H || N || g^s * pk^-c || H^s * N^-c)

over SEC1-compressed points, with H = hash_to_curve(message || compress(pk))
(RFC 9380 secp256k1_XMD:SHA-256_SSWU_RO_, same suite as the native mirror
in natives/hash_to_curve.py), and constrain c' == c.

Built from: EccGadget (complete secp256k1 ops over NonNativeChip),
Sha256Gadget, and an in-circuit SSWU + 3-isogeny map with witnessed
square roots / non-residue certificates.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.native import SECP256K1, secp_generator
from ..natives import hash_to_curve as h2c
from ..trace.context import Cell, Context
from .bigint import AssignedBigUint, BigUintChip
from .ecc import EccGadget, NNPoint
from .nonnative import NNElement, NonNativeChip
from .sha256 import Sha256Gadget

P = SECP256K1.p
N_ORD = SECP256K1.n
DST = b"QUUX-V01-CS02-with-secp256k1_XMD:SHA-256_SSWU_RO_"
NON_RESIDUE = 3  # 3 is a quadratic non-residue mod the secp256k1 prime


@dataclass
class PlumeChips:
    ctx: Context
    big: BigUintChip
    fp: NonNativeChip   # mod p (base field)
    fq: NonNativeChip   # mod n (scalar field)
    ecc: EccGadget
    sha: Sha256Gadget


def make_plume_chips(ctx: Context) -> PlumeChips:
    big = BigUintChip(ctx)
    fp = NonNativeChip(ctx, big, P)
    fq = NonNativeChip(ctx, big, N_ORD)
    ecc = EccGadget(ctx, fp, 0, 7)
    sha = Sha256Gadget(ctx)
    return PlumeChips(ctx, big, fp, fq, ecc, sha)


# ---------------------------------------------------------------------------
# byte plumbing
# ---------------------------------------------------------------------------

def nn_to_be_bytes(chips: PlumeChips, a: NNElement) -> list[Cell]:
    """Canonical NN element (3x88 limbs) -> 32 big-endian byte cells."""
    ctx = chips.ctx
    le_bytes: list[Cell] = []
    for li, limb in enumerate(a.limbs):
        width = 11 if li < 2 else 10  # 88+88+80 bits
        vals = [(limb.value >> (8 * i)) & 0xFF for i in range(width)]
        cells = [ctx.load_witness(v) for v in vals]
        acc = ctx.load_constant(0)
        for i, c in enumerate(cells):
            ctx.range_check(c, 8)
            acc = ctx.mul_add(c, 1 << (8 * i), acc)
        ctx.constrain_equal(acc, limb)
        le_bytes.extend(cells)
    return list(reversed(le_bytes))  # 32 bytes BE


def compress_point_bytes(chips: PlumeChips, pt: NNPoint) -> list[Cell]:
    """SEC1 compression: [2 + (y mod 2)] || x_be (33 byte cells).
    Requires a finite point (PLUME never compresses the identity)."""
    ctx = chips.ctx
    y0 = pt.y.limbs[0]
    b_val = y0.value & 1
    h_val = y0.value >> 1
    b = ctx.load_witness(b_val)
    ctx.assert_bit(b)
    h = ctx.load_witness(h_val)
    ctx.range_check(h, 87)
    ctx.constrain_equal(ctx.mul_add(h, 2, b), y0)
    tag = ctx.add_const(b, 2)  # 2 if even else 3
    return [tag] + nn_to_be_bytes(chips, pt.x)


def bytes_to_nn_mod(chips: PlumeChips, byte_cells: list[Cell],
                    chip: NonNativeChip) -> NNElement:
    """OS2IP(bytes, big-endian) mod m, witnessed: value = q*m + r."""
    ctx, big = chips.ctx, chips.big
    value = 0
    for c in byte_cells:
        value = (value << 8) + c.value
    q_val, r_val = divmod(value, chip.m)
    nbits = len(byte_cells) * 8
    q = big.assign(q_val, max(nbits - chip.m_bits + 2, 1))
    r = chip.assign(r_val)
    # build the byte value as a limb vector (LE 88-bit limbs from BE bytes)
    le = list(reversed(byte_cells))
    limbs = []
    for start in range(0, len(le), 11):
        chunk = le[start : start + 11]
        acc = ctx.load_constant(0)
        for i, c in enumerate(chunk):
            acc = ctx.mul_add(c, 1 << (8 * i), acc)
        limbs.append(acc)
    val_big = AssignedBigUint(limbs)
    rhs = big.add(big.mul(q, chip.m_const), r.big)
    big.assert_equal(val_big, rhs)
    return r


def scalar_bits(chips: PlumeChips, s: NNElement, nbits: int = 256) -> list[Cell]:
    """Decompose a canonical Fq element into MSB-first bits."""
    ctx = chips.ctx
    bits_lsb: list[Cell] = []
    for li, limb in enumerate(s.limbs):
        width = min(88, nbits - 88 * li)
        bits_lsb.extend(ctx.num_to_bits(limb, 88)[:width] if width == 88
                        else ctx.num_to_bits(limb, width))
    return list(reversed(bits_lsb[:nbits]))


# ---------------------------------------------------------------------------
# in-circuit hash_to_curve (SSWU + 3-isogeny)
# ---------------------------------------------------------------------------

def _sswu_point(chips: PlumeChips, u: NNElement) -> NNPoint:
    """Simplified SWU onto the isogenous curve E' with witnessed sqrt."""
    ctx, fp = chips.ctx, chips.fp
    A = fp.assign_constant(h2c.ISO_A)
    B = fp.assign_constant(h2c.ISO_B)
    Zc = fp.assign_constant(h2c.Z)

    u2 = fp.square(u)
    zu2 = fp.mul(Zc, u2)
    tv1 = fp.add(fp.square(zu2), zu2)  # Z^2 u^4 + Z u^2
    # x1 = (-B/A) * (1 + 1/tv1)   (tv1 == 0 is the exceptional case; the
    # witness grinds it away with probability 1 - 2/p, and the guarded
    # division keeps the constraint satisfiable only on the honest branch)
    tv1_zero = fp.is_zero(tv1)
    one = fp.assign_constant(1)
    tv1_safe = fp.select(one, tv1, tv1_zero)
    inv_tv1 = fp.div(one, tv1_safe)
    neg_b_over_a = fp.assign_constant((-h2c.ISO_B) * pow(h2c.ISO_A, -1, P) % P)
    x1_main = fp.mul(neg_b_over_a, fp.add(one, inv_tv1))
    x1_exc = fp.assign_constant(
        h2c.ISO_B * pow(h2c.Z * h2c.ISO_A % P, -1, P) % P)
    x1 = fp.select(x1_exc, x1_main, tv1_zero)
    gx1 = fp.add(fp.add(fp.mul(fp.square(x1), x1), fp.mul(A, x1)), B)

    # square/non-square branch with certificates
    gx1_val = gx1.value
    is_sq = pow(gx1_val, (P - 1) // 2, P) in (0, 1)
    s_flag = ctx.load_witness(1 if is_sq else 0)
    ctx.assert_bit(s_flag)
    if is_sq:
        y1_val = pow(gx1_val, (P + 1) // 4, P)
        cert_val = pow(gx1_val * NON_RESIDUE % P, (P + 1) // 4, P)  # dummy
    else:
        y1_val = 0
        cert_val = pow(gx1_val * NON_RESIDUE % P, (P + 1) // 4, P)
        assert cert_val * cert_val % P == gx1_val * NON_RESIDUE % P

    x2 = fp.mul(zu2, x1)
    gx2 = fp.add(fp.add(fp.mul(fp.square(x2), x2), fp.mul(A, x2)), B)
    if is_sq:
        y_val = y1_val
        x_sel, gx_sel = x1, gx1
    else:
        y_val = pow(gx2.value, (P + 1) // 4, P)
        assert y_val * y_val % P == gx2.value
        x_sel, gx_sel = x2, gx2

    x = fp.select(x1, x2, s_flag)
    gx = fp.select(gx1, gx2, s_flag)
    y = fp.assign(y_val)
    fp.assert_equal(fp.square(y), gx)
    # non-square certificate when s_flag == 0: cert^2 == gx1 * NON_RESIDUE
    cert = fp.assign(cert_val)
    cert_sq = fp.square(cert)
    gx1_nr = fp.mul_const(gx1, NON_RESIDUE)
    eq = fp.is_equal(cert_sq, gx1_nr)
    # require: s_flag OR eq
    ok = ctx.add(s_flag, eq)
    ctx.constrain_equal(ctx.is_zero(ok), ctx.load_constant(0))

    # sgn0 matching: parity(y) == parity(u), via conditional negation
    u_par = _parity(chips, u)
    y_par = _parity(chips, y)
    same = ctx.is_equal(u_par, y_par)
    y_fixed = fp.select(y, fp.neg(y), same)
    return NNPoint(x, y_fixed, ctx.load_constant(0))


def _parity(chips: PlumeChips, a: NNElement) -> Cell:
    ctx = chips.ctx
    l0 = a.limbs[0]
    b = ctx.load_witness(l0.value & 1)
    ctx.assert_bit(b)
    h = ctx.load_witness(l0.value >> 1)
    ctx.range_check(h, 87)
    ctx.constrain_equal(ctx.mul_add(h, 2, b), l0)
    return b


def _iso_map(chips: PlumeChips, pt: NNPoint) -> NNPoint:
    fp = chips.fp
    x, y = pt.x, pt.y
    x2 = fp.square(x)
    x3 = fp.mul(x2, x)

    def poly(coeffs):
        acc = fp.assign_constant(coeffs[0])
        terms = [x, x2, x3]
        for c, t in zip(coeffs[1:], terms):
            acc = fp.add(acc, fp.mul(fp.assign_constant(c), t))
        return acc

    x_num = poly(h2c.K1)
    x_den = poly(h2c.K2 + [1])
    y_num = poly(h2c.K3)
    y_den = poly(h2c.K4 + [1])
    xo = fp.div(x_num, x_den)
    yo = fp.mul(y, fp.div(y_num, y_den))
    return NNPoint(xo, yo, pt.is_inf)


def hash_to_curve_gadget(chips: PlumeChips, msg_bytes: list[Cell]) -> NNPoint:
    """RFC 9380 RO suite in-circuit; msg_bytes are byte cells."""
    ctx, sha = chips.ctx, chips.sha
    dst_prime = DST + bytes([len(DST)])
    len_in_bytes = 96

    def const_bytes(bs: bytes) -> list[Cell]:
        return [ctx.load_constant(b) for b in bs]

    z_pad = const_bytes(bytes(64))
    lib = const_bytes(len_in_bytes.to_bytes(2, "big") + b"\x00")
    dst_cells = const_bytes(dst_prime)
    msg_prime = z_pad + msg_bytes + lib + dst_cells
    b0 = _sha_bytes(chips, msg_prime)
    b1 = _sha_bytes(chips, b0 + const_bytes(b"\x01") + dst_cells)
    prev = b1
    bs = [b1]
    for i in (2, 3):
        xored = [_xor_byte(chips, a, b) for a, b in zip(b0, prev)]
        prev = _sha_bytes(chips, xored + const_bytes(bytes([i])) + dst_cells)
        bs.append(prev)
    uniform = bs[0] + bs[1] + bs[2]
    u0 = bytes_to_nn_mod(chips, uniform[:48], chips.fp)
    u1 = bytes_to_nn_mod(chips, uniform[48:96], chips.fp)
    q0 = _iso_map(chips, _sswu_point(chips, u0))
    q1 = _iso_map(chips, _sswu_point(chips, u1))
    return chips.ecc.add(q0, q1)


def _sha_bytes(chips: PlumeChips, byte_cells: list[Cell]) -> list[Cell]:
    bits = chips.sha.bytes_to_bits(byte_cells)
    return chips.sha.bits_to_bytes(chips.sha.hash_bits(bits))


def _xor_byte(chips: PlumeChips, a: Cell, b: Cell) -> Cell:
    ctx = chips.ctx
    ab = ctx.num_to_bits(a, 8)
    bb = ctx.num_to_bits(b, 8)
    acc = ctx.load_constant(0)
    for i, (x, y) in enumerate(zip(ab, bb)):
        t = ctx.mul(x, y)
        s = ctx.add(x, y)
        xor = ctx.mul_add(t, ctx.p - 2, s)
        acc = ctx.mul_add(xor, 1 << i, acc)
    return acc


# ---------------------------------------------------------------------------
# verify_plume
# ---------------------------------------------------------------------------

@dataclass
class PlumeInput:
    nullifier: NNPoint
    s: NNElement       # mod n
    c: NNElement       # mod n
    pk: NNPoint
    message: list[Cell]  # byte cells


def verify_plume(chips: PlumeChips, inp: PlumeInput):
    """Constrain: c == SHA256(g, pk, H(m||pk), N, g^s pk^-c, H^s N^-c)."""
    ctx, ecc, fq = chips.ctx, chips.ecc, chips.fq
    g = secp_generator()
    g_pt = ecc.constant_point(g.x, g.y)

    compressed_pk = compress_point_bytes(chips, inp.pk)
    H = hash_to_curve_gadget(chips, inp.message + compressed_pk)

    s_bits = scalar_bits(chips, inp.s)
    c_bits = scalar_bits(chips, inp.c)

    # g^s * pk^-c and H^s * N^-c via Shamir double-mul
    gs_pkc = ecc.shamir_mul(g_pt, s_bits, ecc.neg(inp.pk), c_bits)
    hs_nc = ecc.shamir_mul(H, s_bits, ecc.neg(inp.nullifier), c_bits)

    payload = (compress_point_bytes(chips, g_pt)
               + compressed_pk
               + compress_point_bytes(chips, H)
               + compress_point_bytes(chips, inp.nullifier)
               + compress_point_bytes(chips, gs_pkc)
               + compress_point_bytes(chips, hs_nc))
    digest = _sha_bytes(chips, payload)
    c_prime = bytes_to_nn_mod(chips, digest, fq)
    fq.assert_equal(c_prime, inp.c)
