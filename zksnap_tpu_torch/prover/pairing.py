# Copy of zksnap_tpu/prover/pairing.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""Host-side BN254 (alt_bn128) optimal-ate pairing.

The verifier-side pairing check of the KZG/PLONK pipeline (reference:
halo2_proofs `verify_proof` + `AccumulatorStrategy::finalize`,
wrapper.rs:141-155, and the final `PlonkVerifier` decide at
wrapper.rs:1140-1158).  Pure python ints -- this runs once per proof, on
the host; all bulk proving math stays on device.

Tower: Fq2 = Fq[u]/(u^2+1); Fq12 = Fq2[w]/(w^6 - xi), xi = 9 + u.
G2 lives on the D-twist y^2 = x^3 + 3/xi; untwist is (x, y) -> (w^2 x, w^3 y).
Miller loop over 6t+2 (t = 4965661367192848881) with the two Frobenius
correction steps; final exponentiation by (p^12 - 1)/r directly (simple and
obviously correct; a cyclotomic fast path can come later).
"""

from __future__ import annotations

from dataclasses import dataclass

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
T_PARAM = 4965661367192848881
ATE_LOOP = 6 * T_PARAM + 2


# -- Fq2 --------------------------------------------------------------------

class Fq2:
    __slots__ = ("a", "b")  # a + b*u

    def __init__(self, a, b):
        self.a = a % Q
        self.b = b % Q

    def __add__(s, o):
        return Fq2(s.a + o.a, s.b + o.b)

    def __sub__(s, o):
        return Fq2(s.a - o.a, s.b - o.b)

    def __mul__(s, o):
        if isinstance(o, int):
            return Fq2(s.a * o, s.b * o)
        # (a+bu)(c+du) = ac - bd + (ad + bc) u
        ac, bd = s.a * o.a, s.b * o.b
        return Fq2(ac - bd, (s.a + s.b) * (o.a + o.b) - ac - bd)

    __rmul__ = __mul__

    def __neg__(s):
        return Fq2(-s.a, -s.b)

    def conj(s):
        return Fq2(s.a, -s.b)

    def inv(s):
        d = pow(s.a * s.a + s.b * s.b, -1, Q)
        return Fq2(s.a * d, -s.b * d)

    def __eq__(s, o):
        return s.a == o.a and s.b == o.b

    def is_zero(s):
        return s.a == 0 and s.b == 0

    def pow(s, e):
        r = FQ2_ONE
        base = s
        while e:
            if e & 1:
                r = r * base
            base = base * base
            e >>= 1
        return r

    def __repr__(s):
        return f"Fq2({s.a},{s.b})"


FQ2_ZERO = Fq2(0, 0)
FQ2_ONE = Fq2(1, 0)
XI = Fq2(9, 1)


# -- Fq12 = Fq2[w]/(w^6 - xi) ----------------------------------------------

class Fq12:
    __slots__ = ("c",)  # list of 6 Fq2 coefficients

    def __init__(self, c):
        self.c = c

    @staticmethod
    def one():
        return Fq12([FQ2_ONE] + [FQ2_ZERO] * 5)

    @staticmethod
    def zero():
        return Fq12([FQ2_ZERO] * 6)

    @staticmethod
    def from_fq2(x: Fq2, power: int = 0):
        c = [FQ2_ZERO] * 6
        c[power] = x
        return Fq12(c)

    @staticmethod
    def from_int(x: int):
        return Fq12.from_fq2(Fq2(x, 0))

    def __add__(s, o):
        return Fq12([x + y for x, y in zip(s.c, o.c)])

    def __sub__(s, o):
        return Fq12([x - y for x, y in zip(s.c, o.c)])

    def __neg__(s):
        return Fq12([-x for x in s.c])

    def __mul__(s, o):
        if isinstance(o, (int,)):
            return Fq12([x * o for x in s.c])
        out = [FQ2_ZERO] * 11
        for i, x in enumerate(s.c):
            if x.is_zero():
                continue
            for j, y in enumerate(o.c):
                if y.is_zero():
                    continue
                out[i + j] = out[i + j] + x * y
        # reduce w^6 = xi
        for k in range(10, 5, -1):
            if not out[k].is_zero():
                out[k - 6] = out[k - 6] + out[k] * XI
        return Fq12(out[:6])

    __rmul__ = __mul__

    def square(s):
        return s * s

    def inv(s):
        """Tower inversion: view c as a + b*w with a, b in Fq6 = Fq2[v]/(v^3-xi)
        (w^2 = v): (a+bw)^-1 = (a - bw) / (a^2 - b^2 v)."""
        a = (s.c[0], s.c[2], s.c[4])
        b = (s.c[1], s.c[3], s.c[5])
        d = _fq6_sub(_fq6_sq(a), _fq6_mul_v(_fq6_sq(b)))
        di = _fq6_inv(d)
        ra = _fq6_mul(a, di)
        rb = _fq6_mul((-b[0], -b[1], -b[2]), di)
        return Fq12([ra[0], rb[0], ra[1], rb[1], ra[2], rb[2]])

    def pow(s, e):
        r = Fq12.one()
        base = s
        while e:
            if e & 1:
                r = r * base
            base = base.square()
            e >>= 1
        return r

    def __eq__(s, o):
        return all(x == y for x, y in zip(s.c, o.c))

    def is_zero(s):
        return all(x.is_zero() for x in s.c)

    def frobenius(s):
        """x -> x^q: conj coefficients, scale by gamma^i, gamma=xi^((q-1)/6)."""
        out = []
        for i, x in enumerate(s.c):
            out.append(x.conj() * _FROB_GAMMA[i])
        return Fq12(out)


_FROB_GAMMA = [XI.pow(((Q - 1) // 6) * i) for i in range(6)]


# -- Fq6 = Fq2[v]/(v^3 - xi) helpers (coefficient triples) -------------------

def _fq6_mul(x, y):
    a0, a1, a2 = x
    b0, b1, b2 = y
    t0 = a0 * b0
    t1 = a0 * b1 + a1 * b0
    t2 = a0 * b2 + a1 * b1 + a2 * b0
    t3 = a1 * b2 + a2 * b1
    t4 = a2 * b2
    return (t0 + t3 * XI, t1 + t4 * XI, t2)


def _fq6_sq(x):
    return _fq6_mul(x, x)


def _fq6_sub(x, y):
    return (x[0] - y[0], x[1] - y[1], x[2] - y[2])


def _fq6_mul_v(x):
    """multiply by v: (c0, c1, c2) -> (xi*c2, c0, c1)."""
    return (x[2] * XI, x[0], x[1])


def _fq6_inv(x):
    c0, c1, c2 = x
    t0 = c0 * c0 - XI * (c1 * c2)
    t1 = XI * (c2 * c2) - c0 * c1
    t2 = c1 * c1 - c0 * c2
    d = c0 * t0 + XI * (c1 * t2) + XI * (c2 * t1)
    di = d.inv()
    return (t0 * di, t1 * di, t2 * di)


# -- curve points over Fq12 (generic affine) --------------------------------

@dataclass
class PtF12:
    x: Fq12
    y: Fq12
    inf: bool = False


def _pt_add(p1: PtF12, p2: PtF12) -> PtF12:
    if p1.inf:
        return p2
    if p2.inf:
        return p1
    if p1.x == p2.x:
        if p1.y == p2.y:
            lam = (p1.x.square() * 3) * (p1.y * 2).inv()
        else:
            return PtF12(Fq12.zero(), Fq12.zero(), True)
    else:
        lam = (p2.y - p1.y) * (p2.x - p1.x).inv()
    x3 = lam.square() - p1.x - p2.x
    y3 = lam * (p1.x - x3) - p1.y
    return PtF12(x3, y3)


def _line(p1: PtF12, p2: PtF12, t: PtF12) -> Fq12:
    """Value of the line through p1,p2 (or tangent) at point t."""
    if p1.x == p2.x and p1.y == p2.y:
        m = (p1.x.square() * 3) * (p1.y * 2).inv()
        return m * (t.x - p1.x) - (t.y - p1.y)
    if p1.x == p2.x:
        return t.x - p1.x  # vertical
    m = (p2.y - p1.y) * (p2.x - p1.x).inv()
    return m * (t.x - p1.x) - (t.y - p1.y)


# -- G2 (on the twist, Fq2 coordinates) -------------------------------------

G2_GEN = (
    Fq2(
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    Fq2(
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

TWIST_B = Fq2(3, 0) * XI.inv()


def g2_is_on_curve(pt) -> bool:
    x, y = pt
    return y * y == x * x * x + TWIST_B


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            lam = (x1 * x1 * 3) * (y1 * 2).inv()
        else:
            return None
    else:
        lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def g2_mul(pt, k: int):
    out = None
    add = pt
    k %= R
    while k:
        if k & 1:
            out = g2_add(out, add)
        add = g2_add(add, add)
        k >>= 1
    return out


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1])


# -- untwist + pairing ------------------------------------------------------

def untwist(pt) -> PtF12:
    """(x, y) on twist -> (w^2 x, w^3 y) on E(Fq12)."""
    if pt is None:
        return PtF12(Fq12.zero(), Fq12.zero(), True)
    x, y = pt
    return PtF12(Fq12.from_fq2(x, 2), Fq12.from_fq2(y, 3))


def embed_g1(p) -> PtF12:
    """AffinePoint on BN254 G1 -> E(Fq12)."""
    if p.is_identity():
        return PtF12(Fq12.zero(), Fq12.zero(), True)
    return PtF12(Fq12.from_int(p.x), Fq12.from_int(p.y))


def _frob_pt(p: PtF12) -> PtF12:
    if p.inf:
        return p
    return PtF12(p.x.frobenius(), p.y.frobenius())


def miller_loop(q_twist, p_g1) -> Fq12:
    """f_{6t+2,Q}(P) with BN frobenius corrections (no final exp)."""
    if q_twist is None or p_g1.is_identity():
        return Fq12.one()
    Qp = untwist(q_twist)
    P = embed_g1(p_g1)
    Rpt = Qp
    f = Fq12.one()
    for bit in bin(ATE_LOOP)[3:]:
        f = f.square() * _line(Rpt, Rpt, P)
        Rpt = _pt_add(Rpt, Rpt)
        if bit == "1":
            f = f * _line(Rpt, Qp, P)
            Rpt = _pt_add(Rpt, Qp)
    q1 = _frob_pt(Qp)
    q2 = _frob_pt(q1)
    nq2 = PtF12(q2.x, -q2.y, q2.inf)
    f = f * _line(Rpt, q1, P)
    Rpt = _pt_add(Rpt, q1)
    f = f * _line(Rpt, nq2, P)
    return f


_FINAL_EXP = (Q**12 - 1) // R


def pairing(q_twist, p_g1) -> Fq12:
    return miller_loop(q_twist, p_g1).pow(_FINAL_EXP)


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 for [(g1_point, g2_twist_point), ...]."""
    acc = Fq12.one()
    for p, q in pairs:
        acc = acc * miller_loop(q, p)
    return acc.pow(_FINAL_EXP) == Fq12.one()
