// 256-bit Montgomery field arithmetic shared by the port's Hopper kernels.
//
// Storage contract (the port's at-rest layout): one field element is a row
// of 16 int32 values, each a 16-bit little-endian limb, in Montgomery form
// with R = 2^256.  A kernel packs the 16 limbs pairwise into eight 32-bit
// words in registers and unpacks them on store.  R is 2^256 for any limb
// width, so 8x32-bit CIOS reduction returns exactly the value the 16x16-bit
// REDC of the JAX package returns; only the Montgomery constant changes:
// n0 here is -p^-1 mod 2^32, not the 16-bit constant of PrimeField.n0.
//
// Every operation returns a canonical value in [0, p), and handles moduli
// up to 2^256 (secp256k1's p needs the carry past 2^256).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct Modulus {
  uint32_t p[8];    // modulus, little-endian 32-bit words
  uint32_t one[8];  // R mod p (Montgomery one)
  uint32_t n0;      // -p^-1 mod 2^32
};

struct Fe {
  uint32_t w[8];
};

static inline Modulus modulus_from_words(const uint32_t* m17) {
  Modulus M;
  for (int i = 0; i < 8; ++i) {
    M.p[i] = m17[i];
    M.one[i] = m17[8 + i];
  }
  M.n0 = m17[16];
  return M;
}

__device__ __forceinline__ Fe fe_load(const int32_t* row) {
  const int4* v = reinterpret_cast<const int4*>(row);
  Fe r;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int4 t = v[q];
    r.w[2 * q] = (uint32_t)t.x | ((uint32_t)t.y << 16);
    r.w[2 * q + 1] = (uint32_t)t.z | ((uint32_t)t.w << 16);
  }
  return r;
}

__device__ __forceinline__ void fe_store(int32_t* row, const Fe& a) {
  int4* v = reinterpret_cast<int4*>(row);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = make_int4((int)(a.w[2 * q] & 0xFFFFu), (int)(a.w[2 * q] >> 16),
                     (int)(a.w[2 * q + 1] & 0xFFFFu),
                     (int)(a.w[2 * q + 1] >> 16));
  }
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = 0;
  return r;
}

__device__ __forceinline__ Fe fe_one(const Modulus& M) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = M.one[i];
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.w[i];
  return acc == 0;
}

__device__ __forceinline__ Fe fe_select(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = c ? a.w[i] : b.w[i];
  return r;
}

// a <- a - p where (extra != 0 || a >= p); extra is the carry past 2^256.
__device__ __forceinline__ void fe_cond_sub(Fe& a, uint32_t extra,
                                            const Modulus& M) {
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)a.w[i] - M.p[i] - borrow;
    d.w[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 32) & 1u;
  }
  bool take = (extra != 0) || (borrow == 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) a.w[i] = take ? d.w[i] : a.w[i];
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b,
                                     const Modulus& M) {
  Fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_cond_sub(r, (uint32_t)c, M);
  return r;
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b,
                                     const Modulus& M) {
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)a.w[i] - b.w[i] - borrow;
    d.w[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 32) & 1u;
  }
  // a < b: add p back (mod 2^256)
  Fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)d.w[i] + (borrow ? M.p[i] : 0u);
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return r;
}

__device__ __forceinline__ Fe fe_dbl(const Fe& a, const Modulus& M) {
  return fe_add(a, a, M);
}

// Montgomery product a*b*2^-256 mod p, CIOS over eight 32-bit words with
// 64-bit accumulators.  Inputs below 2^256 and b < p give a result below
// 2p (plus the carry word for p near 2^256); one conditional subtract
// makes it canonical.  Not inlined: the point formulas call it 11-21
// times, and one out-of-line copy keeps their build short.
static __device__ __noinline__ Fe fe_mul(const Fe& a, const Fe& b, const Modulus& M) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)a.w[j] * b.w[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * M.n0;
    c = ((uint64_t)m * M.p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += (uint64_t)m * M.p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = t[j];
  fe_cond_sub(r, t[8], M);
  return r;
}

__device__ __forceinline__ Fe fe_sqr(const Fe& a, const Modulus& M) {
  return fe_mul(a, a, M);
}

// a * c for a small host constant c >= 1 (the curve's 3b): the same
// double-and-add chain of field adds as the JAX kernels' _small_mul.
__device__ __forceinline__ Fe fe_small_mul(const Fe& a, int c,
                                           const Modulus& M) {
  Fe acc = fe_zero();
  Fe run = a;
  bool have = false;
  unsigned bits = (unsigned)c;
  while (bits) {
    if (bits & 1u) {
      acc = have ? fe_add(acc, run, M) : run;
      have = true;
    }
    bits >>= 1;
    if (bits) run = fe_dbl(run, M);
  }
  return acc;
}

#define ZK_CHECK_RETURN() return (int)cudaGetLastError()
