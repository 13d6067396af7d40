// Inlined field products and RCB additions for the kernels whose loop
// body is one group operation: the bucket scan (K4, bucket_scan.cu) and
// the weighted suffix (K5, reduce.cu).
//
// field.cuh's fe_mul and point.cuh's padd are out-of-line calls, which
// keeps K1-K3 and K6-K8 short to build; in a loop they cost a stack
// frame (each product's operands and a copy of the Modulus go through
// local memory) and serialise the products.  Here every product is
// inlined, the Modulus is read from the kernel's parameter bank, and the
// independent products of a formula stage run through fe_mul_n, which
// issues the N products' CIOS rounds side by side so that their
// instructions interleave.  The formulas are point.cuh's RCB 2015
// Algorithms 7 and 8 with the same field operations on the same values,
// so the results are bit-exact against point.cuh and the plain versions.
// Every value stays canonical, as in point.cuh.
//
// The 32-bit word product: each row of a CIOS round is written with
// 64-bit values, each word's a[j] * b + t[j] an IMAD.WIDE and the
// carries 64-bit adds.  Read from the SASS of K4's step, PTX carry
// chains (mad.lo.cc / madc.hi.cc) issue more instructions on the IMAD
// pipe and need more registers than ptxas has (they spill).
#pragma once

#include "point.cuh"

// t[0..9] += a * b for an 8-word a and one word b.
__device__ __forceinline__ void mac8(uint32_t (&t)[10],
                                     const uint32_t (&a)[8], uint32_t b) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // below 2^64: (2^32 - 1)^2 + 2 (2^32 - 1)
    c = ((uint64_t)a[j] * b + t[j]) + (c >> 32);
    t[j] = (uint32_t)c;
  }
  c = (uint64_t)t[8] + (c >> 32);
  t[8] = (uint32_t)c;
  t[9] += (uint32_t)(c >> 32);
}

// t = (t + m p) / 2^32 for m = t[0] n0 mod 2^32 (t[0] + m p[0] is 0 mod
// 2^32): the reduction row of a CIOS round, its shift folded in.
__device__ __forceinline__ void redc8(uint32_t (&t)[10], const Modulus& M) {
  const uint32_t m = t[0] * M.n0;
  uint64_t c = (uint64_t)m * M.p[0] + t[0];  // its low word is 0
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    c = ((uint64_t)m * M.p[j] + t[j]) + (c >> 32);
    t[j - 1] = (uint32_t)c;
  }
  c = (uint64_t)t[8] + (c >> 32);
  t[7] = (uint32_t)c;
  t[8] = t[9] + (uint32_t)(c >> 32);
  t[9] = 0;
}

// r[n] = a[n] * b[n] * 2^-256 mod p for n < N: field.cuh's CIOS, the same
// canonical results.  A round adds a[n] * (a word of b[n]) and reduces,
// the N products side by side so that their chains interleave; t stays
// below 2p + 2^33 p within a round and below 2p after it, and one
// conditional subtract makes it canonical.  The eight rounds are a rolled
// loop that takes b's words from the bottom of a copy it shifts down a
// word a round, so that the step of K4 or K5 stays short enough for the
// SM's instruction caches: with the rounds unrolled, the longer step ran
// slower on the H100.
template <int N>
__device__ __forceinline__ void fe_mul_n(Fe (&r)[N], const Fe (&a)[N],
                                         const Fe (&b)[N], const Modulus& M) {
  uint32_t t[N][10];
  Fe bw[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    bw[n] = b[n];
#pragma unroll
    for (int j = 0; j < 10; ++j) t[n][j] = 0;
  }
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int n = 0; n < N; ++n) mac8(t[n], a[n].w, bw[n].w[0]);
#pragma unroll
    for (int n = 0; n < N; ++n) redc8(t[n], M);
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int j = 0; j < 7; ++j) bw[n].w[j] = bw[n].w[j + 1];
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[n].w[j] = t[n][j];
    fe_cond_sub(r[n], t[n][8], M);
  }
}

// The second half of RCB Algorithms 7 and 8, from t0 = X1 X2, t1 = Y1 Y2,
// t3, t4, y3 and t2m = 3b Z1 Z2 (Algorithm 7) or 3b Z1 (Algorithm 8).
__device__ __forceinline__ Pt rcb_tail(const Fe& t0, Fe t1, const Fe& t3,
                                       const Fe& t4, Fe y3, const Fe& t2m,
                                       int b3, const Modulus& M) {
  Fe t0_3 = fe_add(fe_dbl(t0, M), t0, M);
  Fe z3 = fe_add(t1, t2m, M);
  t1 = fe_sub(t1, t2m, M);
  y3 = fe_small_mul(y3, b3, M);
  Fe m[6];
  fe_mul_n<6>(m, {t3, t4, t1, y3, z3, t0_3}, {t1, y3, z3, t0_3, t4, t3}, M);
  return Pt{fe_sub(m[0], m[1], M), fe_add(m[2], m[3], M),
            fe_add(m[4], m[5], M)};
}

// RCB 2015 Algorithm 8: p + q for an affine q (q.z == 0 encodes the
// identity and passes p through), point.cuh's padd<true> inlined.
__device__ __forceinline__ Pt padd_mixed_inl(const Pt& p, const Pt& q,
                                             int b3, const Modulus& M) {
  Fe m[5];
  fe_mul_n<5>(m, {p.x, p.y, fe_add(q.x, q.y, M), q.y, q.x},
              {q.x, q.y, fe_add(p.x, p.y, M), p.z, p.z}, M);
  Fe t3 = fe_sub(m[2], fe_add(m[0], m[1], M), M);
  Pt r = rcb_tail(m[0], m[1], t3, fe_add(m[3], p.y, M), fe_add(m[4], p.x, M),
                  fe_small_mul(p.z, b3, M), b3, M);
  return pt_select(fe_is_zero(q.z), p, r);
}

// RCB 2015 Algorithm 7: complete p + q, point.cuh's padd<false> inlined.
__device__ __forceinline__ Pt padd_inl(const Pt& p, const Pt& q, int b3,
                                       const Modulus& M) {
  Fe m[6];
  fe_mul_n<6>(m, {p.x, p.y, p.z, fe_add(p.x, p.y, M), fe_add(p.y, p.z, M),
                  fe_add(p.x, p.z, M)},
              {q.x, q.y, q.z, fe_add(q.x, q.y, M), fe_add(q.y, q.z, M),
               fe_add(q.x, q.z, M)}, M);
  Fe t3 = fe_sub(m[3], fe_add(m[0], m[1], M), M);
  Fe t4 = fe_sub(m[4], fe_add(m[1], m[2], M), M);
  Fe y3 = fe_sub(m[5], fe_add(m[0], m[2], M), M);
  return rcb_tail(m[0], m[1], t3, t4, y3, fe_small_mul(m[2], b3, M), b3, M);
}
