// Group-law formula bodies for a = 0 short-Weierstrass curves, shared by
// the point kernel (point.cu) and the bucket scan (bucket_scan.cu).
//
// One-to-one translations of zksnap_tpu/curves/fused.py: `_dbl_body_proj`,
// `_add_body_proj` (RCB 2015 Algorithms 7-9, complete projective, identity
// (0:1:0)) and `_dbl_body`, `_add_body` (Jacobian dbl-2009-l and
// add-2007-bl / madd-2007-bl with branchless completeness selects, identity
// z = 0).  Every field value stays canonical; the TPU kernels' lazy [0, 2p)
// form is left for later.
#pragma once

#include "field.cuh"

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ Pt pt_select(bool c, const Pt& a, const Pt& b) {
  return Pt{fe_select(c, a.x, b.x), fe_select(c, a.y, b.y),
            fe_select(c, a.z, b.z)};
}

// RCB 2015 Algorithm 9: complete projective doubling.
static __device__ __noinline__ Pt pdbl(const Pt& p, int b3, const Modulus& M) {
  Fe t0 = fe_sqr(p.y, M);
  Fe z3 = fe_dbl(fe_dbl(fe_dbl(t0, M), M), M);
  Fe t1 = fe_mul(p.y, p.z, M);
  Fe t2 = fe_small_mul(fe_sqr(p.z, M), b3, M);
  Fe x3 = fe_mul(t2, z3, M);
  Fe y3 = fe_add(t0, t2, M);
  z3 = fe_mul(t1, z3, M);
  t1 = fe_dbl(t2, M);
  t2 = fe_add(t1, t2, M);
  t0 = fe_sub(t0, t2, M);
  y3 = fe_add(x3, fe_mul(t0, y3, M), M);
  x3 = fe_dbl(fe_mul(t0, fe_mul(p.x, p.y, M), M), M);
  return Pt{x3, y3, z3};
}

// RCB 2015 Algorithm 7 (MIXED = false) / Algorithm 8 (MIXED = true, q
// affine; q.z == 0 encodes the identity and passes p through).
template <bool MIXED>
__device__ __noinline__ Pt padd(const Pt& p, const Pt& q, int b3,
                                const Modulus& M) {
  Fe t0 = fe_mul(p.x, q.x, M);
  Fe t1 = fe_mul(p.y, q.y, M);
  Fe t3, t4, y3, t2m;
  if (MIXED) {
    t3 = fe_mul(fe_add(q.x, q.y, M), fe_add(p.x, p.y, M), M);
    t3 = fe_sub(t3, fe_add(t0, t1, M), M);
    t4 = fe_add(fe_mul(q.y, p.z, M), p.y, M);
    y3 = fe_add(fe_mul(q.x, p.z, M), p.x, M);
    t2m = fe_small_mul(p.z, b3, M);
  } else {
    Fe t2 = fe_mul(p.z, q.z, M);
    t3 = fe_mul(fe_add(p.x, p.y, M), fe_add(q.x, q.y, M), M);
    t3 = fe_sub(t3, fe_add(t0, t1, M), M);
    t4 = fe_mul(fe_add(p.y, p.z, M), fe_add(q.y, q.z, M), M);
    t4 = fe_sub(t4, fe_add(t1, t2, M), M);
    y3 = fe_mul(fe_add(p.x, p.z, M), fe_add(q.x, q.z, M), M);
    y3 = fe_sub(y3, fe_add(t0, t2, M), M);
    t2m = fe_small_mul(t2, b3, M);
  }
  Fe t0_3 = fe_add(fe_dbl(t0, M), t0, M);
  Fe z3 = fe_add(t1, t2m, M);
  t1 = fe_sub(t1, t2m, M);
  y3 = fe_small_mul(y3, b3, M);
  Fe x3 = fe_sub(fe_mul(t3, t1, M), fe_mul(t4, y3, M), M);
  y3 = fe_add(fe_mul(t1, z3, M), fe_mul(y3, t0_3, M), M);
  z3 = fe_add(fe_mul(z3, t4, M), fe_mul(t0_3, t3, M), M);
  Pt r{x3, y3, z3};
  if (MIXED) r = pt_select(fe_is_zero(q.z), p, r);
  return r;
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
