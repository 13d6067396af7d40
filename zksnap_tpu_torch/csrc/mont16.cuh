// The TPU kernels' own Montgomery product over sixteen 16-bit limbs, for the
// experiment kernels K9 (csrc/exp_mul_variants.cu) and K10
// (csrc/exp_mul_mxu.cu).
//
// Unlike field.cuh (8x32-bit CIOS, the port's production product), this
// computes the JAX experiments' function over 16-bit limbs: a 16x16
// schoolbook product, the word-by-word REDC with the 16-bit n0, one carry
// pass, one conditional subtract (`mul_b`; its uint32 transcription is the
// plain version, experiments/common.py).
//
// Domain: operands of 16-bit limbs (each below 2^16, any value below
// 2^256, inside [0, p) or not).  There no uint32 column of the
// transcription wraps (each stays below 2^24), so it computes in exact
// integers: U = (a b + m p) / 2^256, m = -(a b) p^-1 mod 2^256, step i's
// 16-bit digit of m being the running integer's i-th digit times n0; and
// it returns U - p where U >= p, else U, mod 2^256.  Any exact order of
// the same products gives the same U and the same bits.  This one maps
// them onto the card:
//  - each column sums its whole 16x16-bit products in 64 bits, one
//    IMAD.WIDE.U32 with accumulate a product, and carries once; the
//    transcription adds each product's low and high halves to two uint32
//    columns, five instructions a product;
//  - REDC step i follows schoolbook row i (row r adds to columns r..r+15,
//    so column i is final after row i): the live columns are a window of
//    16 registers with static indices that slides one column a step, in
//    an unrolled loop or a rolled one.
//
// Operands are limb-major: element e's limb i is at [i * n + e], one uint32
// a limb, as the TPU kernels' [16, n] tiles hold them.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// p as 16 limbs of 16 bits, and n0 = -p^-1 mod 2^16 (PrimeField.n0).
struct Mod16 {
  uint32_t p[16];
  uint32_t n0;
};

static inline Mod16 mod16_from_words(const uint32_t* w17) {
  Mod16 M;
  for (int i = 0; i < 16; ++i) M.p[i] = w17[i];
  M.n0 = w17[16];
  return M;
}

constexpr uint32_t kMask16 = 0xFFFFu;

__device__ __forceinline__ uint64_t wide(uint32_t x, uint32_t y) {
  return (uint64_t)x * y;
}

// Row i of the schoolbook (ai times b) and REDC step i on the window
// w[k] = column i + k; the window then slides: w[k] <- column i + 1 + k.
// Every column stays below 2^38.
__device__ __forceinline__ void mont16_step(uint32_t ai, const uint32_t* b,
                                            const Mod16& M, uint64_t* w) {
  uint64_t t0 = w[0] + wide(ai, b[0]);
  uint32_t m = ((uint32_t)t0 * M.n0) & kMask16;
  t0 += wide(m, M.p[0]);  // now 0 mod 2^16
  w[0] = w[1] + wide(ai, b[1]) + wide(m, M.p[1]) + (t0 >> 16);
#pragma unroll
  for (int j = 2; j < 16; ++j)
    w[j - 1] = w[j] + wide(ai, b[j]) + wide(m, M.p[j]);
  w[15] = 0;
}

// out <- out - p where (carry != 0 || out >= p), limbwise mod 2^16: the
// scripts' cond_sub (out >= p exactly when out - p borrows nothing).
__device__ __forceinline__ void cond_sub16(uint32_t* out, uint32_t carry,
                                           const Mod16& M) {
  uint32_t d[16], borrow = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint32_t t = out[i] - M.p[i] - borrow;
    d[i] = t & kMask16;
    borrow = t >> 31;
  }
  const bool ge = carry != 0 || borrow == 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = ge ? d[i] : out[i];
}

// out <- columns 16..31 (w[0..15]) carried into 16-bit limbs, the
// conditional subtract on top
__device__ __forceinline__ void mont16_finish(const uint64_t* w,
                                              const Mod16& M, uint32_t* out) {
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    uint64_t v = w[k] + carry;
    out[k] = (uint32_t)v & kMask16;
    carry = (uint32_t)(v >> 16);
  }
  cond_sub16(out, carry, M);
}

// out <- a * b * 2^-256 mod p (one conditional subtract): mul_b, unrolled.
__device__ __forceinline__ void mont16_mul(const uint32_t* a,
                                           const uint32_t* b, const Mod16& M,
                                           uint32_t* out) {
  uint64_t w[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) mont16_step(a[i], b, M, w);
  mont16_finish(w, M, out);
}

// The same with its 16 steps a rolled loop: a's limb i is read at run time
// from a[i * lda] (shared memory), b's and p's at static indices.
__device__ __forceinline__ void mont16_mul_rolled(const uint32_t* a, int lda,
                                                  const uint32_t* b,
                                                  const Mod16& M,
                                                  uint32_t* out) {
  uint64_t w[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = 0;
#pragma unroll 1
  for (int i = 0; i < 16; ++i) mont16_step(a[i * lda], b, M, w);
  mont16_finish(w, M, out);
}
