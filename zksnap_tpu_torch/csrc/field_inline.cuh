// Inlined Montgomery products: field.cuh's CIOS, written so that a kernel
// inlines it and runs several independent products side by side.  Used
// by the field kernel K1 (mont.cu) and, through point_inline.cuh, by the
// point formulas of K3-K6.  The Modulus a kernel passes by value is read
// from its parameter bank; nothing goes through local memory.
//
// The 32-bit word product: each row of a CIOS round is written with
// 64-bit values, each word's a[j] * b + t[j] an IMAD.WIDE and the
// carries 64-bit adds.  Read from the SASS of K4's step, PTX carry
// chains (mad.lo.cc / madc.hi.cc) issue more instructions on the IMAD
// pipe and need more registers than ptxas has (they spill).
#pragma once

#include "field.cuh"

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

// One CIOS round of N products side by side: t[n] += a[n] * (the bottom
// word of bw[n]) and reduce, then bw[n]'s words shift down a word.
template <int N>
__device__ __forceinline__ void cios_round(uint32_t (&t)[N][10],
                                           const Fe (&a)[N], Fe (&bw)[N],
                                           const Modulus& M) {
#pragma unroll
  for (int n = 0; n < N; ++n) mac8(t[n], a[n].w, bw[n].w[0]);
#pragma unroll
  for (int n = 0; n < N; ++n) redc8(t[n], M);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int j = 0; j < 7; ++j) bw[n].w[j] = bw[n].w[j + 1];
}

// Products of at most CIOS_UNROLL_MAX side by side unroll their rounds.
constexpr int CIOS_UNROLL_MAX = 3;

// r[n] = a[n] * b[n] * 2^-256 mod p for n < N: field.cuh's CIOS, the same
// canonical results.  A round adds a[n] * (a word of b[n]) and reduces,
// the N products side by side so that their chains interleave; t stays
// below 2p + 2^33 p within a round and below 2p after it, and one
// conditional subtract makes it canonical.  With five or six products (a
// step of K4 or K5) the eight rounds are a rolled loop that takes b's
// words from the bottom of a copy it shifts down a word a round, so that
// the step stays short enough for the SM's instruction caches: with the
// rounds unrolled, the longer step ran slower on the H100.  With one to
// three (K1's product, a thread's share of a stage in K3's and K6's
// thread groups) they unroll, and b's words need no shifting: on
// the H100 K6 then took 2.04 against 2.79 us a doubling and K3's pmadd
// lost its spill.
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
  if constexpr (N <= CIOS_UNROLL_MAX) {
#pragma unroll
    for (int i = 0; i < 8; ++i) cios_round<N>(t, a, bw, M);
  } else {
#pragma unroll 1
    for (int i = 0; i < 8; ++i) cios_round<N>(t, a, bw, M);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[n].w[j] = t[n][j];
    fe_cond_sub(r[n], t[n][8], M);
  }
}
