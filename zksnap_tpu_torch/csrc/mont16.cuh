// The TPU kernels' own Montgomery product over sixteen 16-bit limbs, for the
// experiment kernels K9 (csrc/exp_mul_variants.cu) and K10
// (csrc/exp_mul_mxu.cu).
//
// Unlike field.cuh (8x32-bit CIOS, the port's production product), this is
// a transcription of the JAX experiments' arithmetic, step for step in
// uint32: 16x16 schoolbook columns (each 32-bit limb product split into its
// low and high 16 bits), word-by-word REDC with the 16-bit n0, one carry
// pass, one conditional subtract.  Every step wraps mod 2^32 as the TPU's
// uint32 lanes do, so a kernel built from these pieces returns the JAX
// kernels' bits on every input, inside [0, p) or not.
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

// cols[0..32] <- the schoolbook columns of a * b (conv_schoolbook / the
// first loop of mul_b): every column below 2^21.
template <bool ROLLED>
__device__ __forceinline__ void schoolbook16(const uint32_t* a,
                                             const uint32_t* b,
                                             uint32_t* cols) {
#pragma unroll
  for (int k = 0; k < 33; ++k) cols[k] = 0;
  auto row = [&](int i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint32_t prod = a[i] * b[j];
      cols[i + j] += prod & kMask16;
      cols[i + j + 1] += prod >> 16;
    }
  };
  if constexpr (ROLLED) {
#pragma unroll 1
    for (int i = 0; i < 16; ++i) row(i);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) row(i);
  }
}

// out <- out - p where (carry != 0 || out >= p): cond_sub of the scripts.
__device__ __forceinline__ void cond_sub16(uint32_t* out, uint32_t carry,
                                           const Mod16& M) {
  bool ge_flag = carry > 0;
  bool eq = true, gt = false;
#pragma unroll
  for (int i = 15; i >= 0; --i) {
    gt = gt || (eq && out[i] > M.p[i]);
    eq = eq && out[i] == M.p[i];
  }
  bool ge = ge_flag || gt || eq;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint32_t t = out[i] - M.p[i] - borrow;
    uint32_t nb = (t >> 31) & 1u;
    out[i] = ge ? ((t + (nb << 16)) & kMask16) : out[i];
    borrow = nb;
  }
}

// A column's carry: `c >> 16` as the scripts' uint32 lanes shift, or with
// SIGNED as int32, floor(c / 2^16) for a column that is negative in the
// integers (Karatsuba's), where the uint32 shift adds 2^16.
template <bool SIGNED>
__device__ __forceinline__ uint32_t carry16(uint32_t c) {
  return SIGNED ? (uint32_t)((int32_t)c >> 16) : c >> 16;
}

// out[0..15] <- the word REDC of the columns (word_redc / the second half
// of mul_b); cols is consumed.  The scripts' `kar` variant carries its
// signed columns unsigned and is sometimes wrong; SIGNED carries them right.
template <bool ROLLED, bool SIGNED = false>
__device__ __forceinline__ void word_redc16(uint32_t* cols, const Mod16& M,
                                            uint32_t* out) {
  auto step = [&](int i) {
    uint32_t m = (cols[i] * M.n0) & kMask16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint32_t prod = m * M.p[j];
      cols[i + j] += prod & kMask16;
      cols[i + j + 1] += prod >> 16;
    }
    cols[i + 1] += carry16<SIGNED>(cols[i]);
  };
  if constexpr (ROLLED) {
#pragma unroll 1
    for (int i = 0; i < 16; ++i) step(i);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) step(i);
  }
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint32_t tot = cols[16 + i] + carry;
    out[i] = tot & kMask16;
    carry = carry16<SIGNED>(tot);
  }
  cond_sub16(out, carry + cols[32], M);  // (T + m p) / 2^256 >= 0
}

// out <- a * b * 2^-256 mod p (one conditional subtract): mul_b.
template <bool ROLLED>
__device__ __forceinline__ void mont16_mul(const uint32_t* a,
                                           const uint32_t* b, const Mod16& M,
                                           uint32_t* out) {
  uint32_t cols[33];
  schoolbook16<ROLLED>(a, b, cols);
  word_redc16<ROLLED>(cols, M, out);
}
