// The Jacobian group-law formula bodies for a = 0 short-Weierstrass
// curves, out of line: the Jacobian branches of K4, K5 and K6 (b3 = 0).
//
// One-to-one translations of zksnap_tpu/curves/fused.py `_dbl_body` and
// `_add_body` (dbl-2009-l and add-2007-bl / madd-2007-bl with branchless
// completeness selects, identity z = 0).  Every field value stays
// canonical; the TPU kernels' lazy [0, 2p) form is left for later.  The
// RCB projective formulas (Algorithms 7-9), the prover's, and the same
// Jacobian formulas for the point kernel's Jacobian kinds (K3's add,
// madd and dbl, which K7 and K8 launch too) are inlined from
// point_inline.cuh.
#pragma once

#include "field.cuh"

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ Pt pt_select(bool c, const Pt& a, const Pt& b) {
  return Pt{fe_select(c, a.x, b.x), fe_select(c, a.y, b.y),
            fe_select(c, a.z, b.z)};
}

// dbl-2009-l (a = 0); the identity (z = 0) doubles to z = 0.
static __device__ __noinline__ Pt jdbl(const Pt& p, const Modulus& M) {
  Fe A = fe_sqr(p.x, M);
  Fe B = fe_sqr(p.y, M);
  Fe C = fe_sqr(B, M);
  Fe t = fe_sqr(fe_add(p.x, B, M), M);
  Fe D = fe_dbl(fe_sub(fe_sub(t, A, M), C, M), M);
  Fe E = fe_add(fe_dbl(A, M), A, M);
  Fe FF = fe_sqr(E, M);
  Fe X3 = fe_sub(FF, fe_dbl(D, M), M);
  Fe Y3 = fe_sub(fe_mul(E, fe_sub(D, X3, M), M),
                 fe_dbl(fe_dbl(fe_dbl(C, M), M), M), M);
  Fe Z3 = fe_dbl(fe_mul(p.y, p.z, M), M);
  return Pt{X3, Y3, Z3};
}

// add-2007-bl (MIXED = false) / madd-2007-bl (MIXED = true, q.z in {0, 1})
// with the doubling fallback and identity selects of fused._add_body.
template <bool MIXED>
__device__ __noinline__ Pt jadd(const Pt& p, const Pt& q, const Modulus& M) {
  Fe z1z1 = fe_sqr(p.z, M);
  Fe z2z2, u1, u2, s1, s2;
  if (MIXED) {
    u1 = p.x;
    s1 = p.y;
    u2 = fe_mul(q.x, z1z1, M);
    s2 = fe_mul(fe_mul(q.y, p.z, M), z1z1, M);
  } else {
    z2z2 = fe_sqr(q.z, M);
    u1 = fe_mul(p.x, z2z2, M);
    u2 = fe_mul(q.x, z1z1, M);
    s1 = fe_mul(fe_mul(p.y, q.z, M), z2z2, M);
    s2 = fe_mul(fe_mul(q.y, p.z, M), z1z1, M);
  }
  Fe h = fe_sub(u2, u1, M);
  Fe r = fe_sub(s2, s1, M);
  Fe i = fe_sqr(fe_dbl(h, M), M);
  Fe j = fe_mul(h, i, M);
  Fe r2 = fe_dbl(r, M);
  Fe v = fe_mul(u1, i, M);
  Fe x3 = fe_sub(fe_sub(fe_sqr(r2, M), j, M), fe_dbl(v, M), M);
  Fe y3 = fe_sub(fe_mul(r2, fe_sub(v, x3, M), M),
                 fe_dbl(fe_mul(s1, j, M), M), M);
  Fe z3;
  if (MIXED) {
    z3 = fe_mul(fe_dbl(p.z, M), h, M);
  } else {
    z3 = fe_mul(
        fe_sub(fe_sub(fe_sqr(fe_add(p.z, q.z, M), M), z1z1, M), z2z2, M), h,
        M);
  }
  Pt d = jdbl(p, M);
  bool h_zero = fe_is_zero(h);
  bool r_zero = fe_is_zero(r);
  bool p_inf = fe_is_zero(p.z);
  bool q_inf = fe_is_zero(q.z);
  bool use_dbl = h_zero && r_zero && !p_inf && !q_inf;
  bool to_inf = h_zero && !r_zero && !p_inf && !q_inf;
  Pt s{x3, y3, z3};
  s = pt_select(use_dbl, d, s);
  if (to_inf) s.z = fe_zero();
  s = pt_select(p_inf, q, s);
  s = pt_select(q_inf, p, s);
  return s;
}

// Point kinds, numbered as the Python wrapper (curves/fused.py) names them.
enum PointKind { K_ADD = 0, K_MADD = 1, K_DBL = 2, K_PADD = 3, K_PMADD = 4,
                 K_PDBL = 5 };
