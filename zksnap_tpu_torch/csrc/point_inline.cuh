// Inlined group-law formulas for the kernels whose work is a chain of
// group operations or a batch of them: RCB 2015 (Algorithms 7, 8, 9) for
// the point kernel's projective kinds (K3, point.cu), the bucket scan
// (K4, bucket_scan.cu), the weighted suffix (K5) and the ladder and tree
// (K6, reduce.cu), and the Jacobian dbl-2009-l and add-2007-bl /
// madd-2007-bl for the point kernel's Jacobian kinds (K3's add, madd and
// dbl, which K8's and K7's entry points launch too).
//
// field.cuh's fe_mul is an out-of-line call, which keeps point.cuh's
// Jacobian formulas (the Jacobian branches of K4, K5 and K6) short to
// build; in a chain it costs a stack frame (each product's operands and a
// copy of the Modulus go through local memory) and serialises the
// products.  Here every product
// is inlined (field_inline.cuh, which K1 uses too), the Modulus is read
// from the kernel's parameter bank, and the independent products of a
// formula stage run through fe_mul_n, which issues the products' CIOS
// rounds side by side so that their instructions interleave.  A stage's
// products may also be shared by a group of T adjacent threads that hold
// the same point (fe_mul_group): each computes every T-th product and
// shuffles pass the results round, so that a dependent chain waits on
// about N / T products a stage, not N, and a kernel gets T times the
// warps.  The Jacobian formulas (below) take their products one at a
// time instead.  The formulas compute the same field operations on the
// same values as the plain versions (curves/fused.py); every value stays
// canonical, so the results are bit-exact against them.
#pragma once

#include "point.cuh"
#include "field_inline.cuh"

// r[j] = a[j] * b[j] * 2^-256 mod p for j < N, shared by a group of T
// adjacent threads (T divides 32, and the block's threads are whole
// groups): thread s of the group computes products s, s + T, ..., side by
// side, and every thread gets all N results by shuffles.  Every thread of
// the warp must reach it.  T = 1 is fe_mul_n.
template <int N, int T>
__device__ __forceinline__ void fe_mul_group(Fe (&r)[N], const Fe (&a)[N],
                                             const Fe (&b)[N],
                                             const Modulus& M) {
  if constexpr (T == 1) {
    fe_mul_n<N>(r, a, b, M);
  } else {
    constexpr int K = (N + T - 1) / T;
    const int s = threadIdx.x % T;
    Fe x[K], y[K], m[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[k] = a[k * T];
      y[k] = b[k * T];
#pragma unroll
      for (int t = 1; t < T; ++t)
        if (k * T + t < N) {
          x[k] = fe_select(s == t, a[k * T + t], x[k]);
          y[k] = fe_select(s == t, b[k * T + t], y[k]);
        }
    }
    fe_mul_n<K>(m, x, y, M);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (k * T + t < N)
#pragma unroll
          for (int w = 0; w < 8; ++w)
            r[k * T + t].w[w] = __shfl_sync(0xffffffffu, m[k].w[w], t, T);
  }
}

// The second half of RCB Algorithms 7 and 8, from t0 = X1 X2, t1 = Y1 Y2,
// t3, t4, y3 and t2m = 3b Z1 Z2 (Algorithm 7) or 3b Z1 (Algorithm 8).
template <int T>
__device__ __forceinline__ Pt rcb_tail(const Fe& t0, Fe t1, const Fe& t3,
                                       const Fe& t4, Fe y3, const Fe& t2m,
                                       int b3, const Modulus& M) {
  Fe t0_3 = fe_add(fe_dbl(t0, M), t0, M);
  Fe z3 = fe_add(t1, t2m, M);
  t1 = fe_sub(t1, t2m, M);
  y3 = fe_small_mul(y3, b3, M);
  Fe m[6];
  fe_mul_group<6, T>(m, {t3, t4, t1, y3, z3, t0_3},
                     {t1, y3, z3, t0_3, t4, t3}, M);
  return Pt{fe_sub(m[0], m[1], M), fe_add(m[2], m[3], M),
            fe_add(m[4], m[5], M)};
}

// RCB 2015 Algorithm 8: p + q for an affine q (q.z == 0 encodes the
// identity and passes p through).
template <int T = 1>
__device__ __forceinline__ Pt padd_mixed_inl(const Pt& p, const Pt& q,
                                             int b3, const Modulus& M) {
  Fe m[5];
  fe_mul_group<5, T>(m, {p.x, p.y, fe_add(q.x, q.y, M), q.y, q.x},
                     {q.x, q.y, fe_add(p.x, p.y, M), p.z, p.z}, M);
  Fe t3 = fe_sub(m[2], fe_add(m[0], m[1], M), M);
  Pt r = rcb_tail<T>(m[0], m[1], t3, fe_add(m[3], p.y, M),
                     fe_add(m[4], p.x, M), fe_small_mul(p.z, b3, M), b3, M);
  return pt_select(fe_is_zero(q.z), p, r);
}

// RCB 2015 Algorithm 7: complete p + q.
template <int T = 1>
__device__ __forceinline__ Pt padd_inl(const Pt& p, const Pt& q, int b3,
                                       const Modulus& M) {
  Fe m[6];
  fe_mul_group<6, T>(m, {p.x, p.y, p.z, fe_add(p.x, p.y, M),
                         fe_add(p.y, p.z, M), fe_add(p.x, p.z, M)},
                     {q.x, q.y, q.z, fe_add(q.x, q.y, M),
                      fe_add(q.y, q.z, M), fe_add(q.x, q.z, M)}, M);
  Fe t3 = fe_sub(m[3], fe_add(m[0], m[1], M), M);
  Fe t4 = fe_sub(m[4], fe_add(m[1], m[2], M), M);
  Fe y3 = fe_sub(m[5], fe_add(m[0], m[2], M), M);
  return rcb_tail<T>(m[0], m[1], t3, t4, y3, fe_small_mul(m[2], b3, M), b3,
                     M);
}

// RCB 2015 Algorithm 9: complete doubling, in two stages of four
// products: {Y^2, Y Z, Z^2, X Y}, then with t2 = 3b Z^2,
// {t2 * 8 Y^2, Y Z * 8 Y^2, (Y^2 - 3 t2)(Y^2 + t2), (Y^2 - 3 t2) X Y}.
template <int T = 1>
__device__ __forceinline__ Pt pdbl_inl(const Pt& p, int b3,
                                       const Modulus& M) {
  Fe m[4];
  fe_mul_group<4, T>(m, {p.y, p.y, p.z, p.x}, {p.y, p.z, p.z, p.y}, M);
  const Fe t2 = fe_small_mul(m[2], b3, M);
  const Fe z3 = fe_dbl(fe_dbl(fe_dbl(m[0], M), M), M);
  const Fe y3 = fe_add(m[0], t2, M);
  const Fe t0 = fe_sub(m[0], fe_add(fe_dbl(t2, M), t2, M), M);
  Fe n[4];
  fe_mul_group<4, T>(n, {t2, m[1], t0, t0}, {z3, z3, y3, m[3]}, M);
  return Pt{fe_dbl(n[3], M), fe_add(n[0], n[2], M), n[1]};
}

// The Jacobian formulas of the point kernel's Jacobian kinds (K3's add,
// madd and dbl, which K7's and K8's entry points launch too): one thread
// a point, one product at a time, each product a fully unrolled CIOS
// (fe_mul_n<1>).  On the H100 the RCB kinds' ways to more parallelism, a
// stage's products side by side and a point shared by two or four
// threads, lost here: the Jacobian formulas keep more values live (the
// add has five dependent stages), so each cost registers and warps, and
// with every product's code written out the add (23 products with its
// fallback) outgrew the SM's instruction cache.  The dbl's seven products
// are written out in a straight line (jdbl_inl); the add runs as a
// program whose one copy of the product's code serves its 16 products
// (jadd_prog).
__device__ __forceinline__ Fe jac_mul1(const Fe& a, const Fe& b,
                                       const Modulus& M) {
  Fe x[1] = {a}, y[1] = {b}, r[1];
  fe_mul_n<1>(r, x, y, M);
  return r[0];
}

// The rows of one point in device memory.
struct PtRows {
  const int32_t* x;
  const int32_t* y;
  const int32_t* z;
};

// A row read again at the end of a formula, for a lane that needs its
// input once more: a volatile load, so that the compiler does not keep
// the first read in registers across the formula instead.
__device__ __forceinline__ Fe fe_reload(const int32_t* row) {
  Fe r;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int x, y, z, w;
    asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(x), "=r"(y), "=r"(z), "=r"(w)
                 : "l"(row + 4 * q));
    r.w[2 * q] = (uint32_t)x | ((uint32_t)y << 16);
    r.w[2 * q + 1] = (uint32_t)z | ((uint32_t)w << 16);
  }
  return r;
}

__device__ __forceinline__ Pt pt_reload(const PtRows& r) {
  return Pt{fe_reload(r.x), fe_reload(r.y), fe_reload(r.z)};
}

// dbl-2009-l (a = 0) with point.cuh's jdbl's field operations:
// A = X^2, B = Y^2, Y Z; C = B^2, (X + B)^2, E^2 (E = 3A); E (D - X3).
// The identity (Z = 0) doubles to Z = 0.
__device__ __forceinline__ Pt jdbl_inl(const Pt& p, const Modulus& M) {
  const Fe a = jac_mul1(p.x, p.x, M);
  const Fe b = jac_mul1(p.y, p.y, M);
  const Fe yz = jac_mul1(p.y, p.z, M);
  const Fe xb = fe_add(p.x, b, M);
  const Fe e = fe_add(fe_dbl(a, M), a, M);
  const Fe c = jac_mul1(b, b, M);
  const Fe t = jac_mul1(xb, xb, M);
  const Fe ff = jac_mul1(e, e, M);
  const Fe d = fe_dbl(fe_sub(fe_sub(t, a, M), c, M), M);
  const Fe x3 = fe_sub(ff, fe_dbl(d, M), M);
  const Fe ed = jac_mul1(e, fe_sub(d, x3, M), M);
  return Pt{x3, fe_sub(ed, fe_dbl(fe_dbl(fe_dbl(c, M), M), M), M),
            fe_dbl(yz, M)};
}

// add-2007-bl (MIXED = false) / madd-2007-bl (MIXED = true, q.z in
// {0, 1}) with the doubling fallback and the identity selects of
// point.cuh's jadd (fused._add_body): the same field operations, as a
// program over eight slot registers: a rolled loop, one product a trip
// through one copy of the product's code, its operands and its result
// chosen by the trip (a switch that every thread of a warp takes alike),
// the adds between products after the product of their trip.  add, steps
// 0-8, from s0..s5 =
// X1, Y1, Z1, X2, Y2, Z2 and s6 = Z1 + Z2: Y1 Z2 (s1), Y2 Z1 (s4), Z1^2
// (s7), Z2^2 (s5), (Z1 + Z2)^2 (s6, then zf = s6 - Z1^2 - Z2^2), U1 (s0),
// U2 (s3), S1 (s1), S2 (s4; H = U2 - U1 to s3, R = S2 - S1, 2H to s2, 2R
// to s4).  madd, steps 16-19, from s0 = U1 = X1, s1 = S1 = Y1, s2 = Z1,
// s3 = X2, s4 = Y2, s6 = zf = 2 Z1: Z1^2 (s7), Y2 Z1 (s4), U2 (s3), S2
// (s4; as step 8).  Both then steps 9-15: I = (2H)^2 (s2), (2R)^2 (s5),
// Z3 = zf H (s6), J = H I (s3), V = U1 I (s0; X3 to s5, V - X3 to s0),
// 2R (V - X3) (s4), S1 J (s1; Y3 to s4).
//
// P and Q are read from their rows, and read again only by the lanes
// that need them at the end: for the doubling fallback (P == Q, neither
// the identity) and for the identity selects.  The fallback's seven
// products run only in the blocks that hold a lane with P == Q, and in
// all of that block's warps: a block vote (__syncthreads_or), not a warp
// vote, so that a block's warps stay on the same code.  On the H100, with
// P == Q on 2 % of the lanes, warps that parted ways at a warp vote ran
// the add 1.13 ms at n = 2^20 against 0.91 with the block vote, which
// every thread of the block reaches (a thread past the end included).
template <bool MIXED>
__device__ __forceinline__ Pt jadd_prog(const PtRows& pr, const PtRows& qr,
                                        const Modulus& M) {
  Fe s0 = fe_load(pr.x), s1 = fe_load(pr.y), s2 = fe_load(pr.z);
  Fe s3 = fe_load(qr.x), s4 = fe_load(qr.y), s5, s6, s7;
  const bool p_inf = fe_is_zero(s2);
  bool q_inf;
  if constexpr (MIXED) {
    q_inf = fe_is_zero(fe_load(qr.z));
    s6 = fe_dbl(s2, M);
  } else {
    s5 = fe_load(qr.z);
    q_inf = fe_is_zero(s5);
    s6 = fe_add(s2, s5, M);
  }
  bool h_zero = false, r_zero = false;
  constexpr int steps = MIXED ? 11 : 16;
#pragma unroll 1
  for (int i = 0; i < steps; ++i) {
    const int step = MIXED ? (i < 4 ? 16 + i : i + 5) : i;
    Fe a, b;
    switch (step) {
      case 0: a = s1; b = s5; break;
      case 1: a = s4; b = s2; break;
      case 2: a = s2; b = s2; break;
      case 3: a = s5; b = s5; break;
      case 4: a = s6; b = s6; break;
      case 5: a = s0; b = s5; break;
      case 6: a = s3; b = s7; break;
      case 7: a = s1; b = s5; break;
      case 8: a = s4; b = s7; break;
      case 9: a = s2; b = s2; break;
      case 10: a = s4; b = s4; break;
      case 11: a = s6; b = s3; break;
      case 12: a = s3; b = s2; break;
      case 13: a = s0; b = s2; break;
      case 14: a = s4; b = s0; break;
      case 15: a = s1; b = s3; break;
      case 16: a = s2; b = s2; break;
      case 17: a = s4; b = s2; break;
      case 18: a = s3; b = s7; break;
      default: a = s4; b = s7; break;
    }
    const Fe m = jac_mul1(a, b, M);
    switch (step) {
      case 0: s1 = m; break;
      case 1: s4 = m; break;
      case 2: s7 = m; break;
      case 3: s5 = m; break;
      case 4: s6 = fe_sub(fe_sub(m, s7, M), s5, M); break;
      case 5: s0 = m; break;
      case 6: s3 = m; break;
      case 7: s1 = m; break;
      case 9: s2 = m; break;
      case 10: s5 = m; break;
      case 11: s6 = m; break;
      case 12: s3 = m; break;
      case 13:
        s5 = fe_sub(fe_sub(s5, s3, M), fe_dbl(m, M), M);
        s0 = fe_sub(m, s5, M);
        break;
      case 14: s4 = m; break;
      case 15: s4 = fe_sub(s4, fe_dbl(m, M), M); break;
      case 16: s7 = m; break;
      case 17: s4 = m; break;
      case 18: s3 = m; break;
      default:  // steps 8 and 19: S2, then H, R, 2H, 2R
        s3 = fe_sub(s3, s0, M);
        s4 = fe_sub(m, s1, M);
        h_zero = fe_is_zero(s3);
        r_zero = fe_is_zero(s4);
        s2 = fe_dbl(s3, M);
        s4 = fe_dbl(s4, M);
        break;
    }
  }
  Pt s{s5, s4, s6};
  const bool use_dbl = h_zero && r_zero && !p_inf && !q_inf;
  const bool to_inf = h_zero && !r_zero && !p_inf && !q_inf;
  if (__syncthreads_or(use_dbl)) {
    // the lanes without P == Q double their sum instead of reading P
    const Pt p = use_dbl ? pt_reload(pr) : s;
    s = pt_select(use_dbl, jdbl_inl(p, M), s);
  }
  if (to_inf) s.z = fe_zero();
  if (q_inf) {
    s = pt_reload(pr);
  } else if (p_inf) {
    s = pt_reload(qr);
  }
  return s;
}

// The rows of point i from a thread of a group of T that holds it: thread
// s stores the 16-byte chunks s, s + T, ... of x, y and z (T = 1: all).
template <int T>
__device__ __forceinline__ void pt_store_share(int32_t* x, int32_t* y,
                                               int32_t* z, long long i,
                                               const Pt& p) {
  const int s = threadIdx.x % T;
  int4* dst[3] = {reinterpret_cast<int4*>(x + i * 16),
                  reinterpret_cast<int4*>(y + i * 16),
                  reinterpret_cast<int4*>(z + i * 16)};
  const Fe f[3] = {p.x, p.y, p.z};
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if ((4 * c + q) % T == s)
        dst[c][q] = make_int4((int)(f[c].w[2 * q] & 0xFFFFu),
                              (int)(f[c].w[2 * q] >> 16),
                              (int)(f[c].w[2 * q + 1] & 0xFFFFu),
                              (int)(f[c].w[2 * q + 1] >> 16));
}
