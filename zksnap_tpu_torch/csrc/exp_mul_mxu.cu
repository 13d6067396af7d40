// Kernel K10: Montgomery multiply with a Karatsuba product and a REDC on the
// tensor cores, an experiment.
//
// Replaces scripts/exp_mul_mxu.py: `make_kernel` (the pallas_call at :329),
// modulus BN254 Fr, operands limb-major [16, n] uint32, in six variants:
//   base       16x16 schoolbook columns + word REDC (mont16.cuh);
//   kar        two-level Karatsuba columns + word REDC;
//   mxu        schoolbook columns + the REDC as two products by fixed
//              Toeplitz matrices: m = NMAT[32, 47] . digits of T (mod
//              2^256 after a carry pass), then m * p = PMAT[64, 32] . m;
//   kar+mxu    Karatsuba columns + the tensor-core REDC;
//   convonly   timing ablation: cols[i] ^ cols[i + 16] of the schoolbook;
//   mxunocarry timing ablation: both products with no carry pass,
//              mp[i] ^ mp[i + 32].
// Each variant returns the bits of the JAX kernel's variant, except where
// that is wrong.  Karatsuba's columns are signed (a negative one is held
// mod 2^32).  The JAX kar carries them in its word REDC with a uint32
// shift, which adds 2^16 below a negative column, and is wrong on a few
// inputs in a thousand; here they carry as int32.  The JAX kar+mxu splits
// them into 8-bit digits as if they were nonnegative and below 2^23, and is
// wrong on every input; here they are carried into nonnegative 16-bit
// columns first.  So the four product variants all return the Montgomery
// product.
//
// Tensor cores: the TPU ran both products in bf16 with an f32 accumulator,
// exact for these sizes.  Here they are `mma.sync` m16n8k32 with u8 digits
// and an s32 accumulator, exact (digits <= 255, sums < 2^22), at Hopper's
// int8 rate, twice bf16's.  NMAT's 47 digit rows are padded to K = 64.
// One thread an element computes its columns and digits on the CUDA cores;
// a warp's 32 elements are the products' N = 32 columns (four n tiles of
// 8), and the digits cross from one thread an element to the B-fragment
// layout, and the products back, through the warp's own shared memory.
//
// Bounds on the H100: base and kar are integer-ALU bound like K9's variant
// B (kar trades 256 products for 160 and more adds); the mxu variants move
// the REDC's 256 products to the tensor cores, whose work is small, and
// are then bound by the digit splits, the two carry passes and the shared
// memory round trips.  wgmma, TMA and any tuning are later work.

#include "mont16.cuh"

enum Variant { BASE = 0, KAR = 1, MXU = 2, KAR_MXU = 3, CONVONLY = 4,
               MXUNOCARRY = 5 };

// ------------------------------------------------------------ Karatsuba
// conv_mul_n, conv_mid and conv_karatsuba of the script, in uint32 with its
// wraparound: a column that is negative in the integers is held mod 2^32.

template <int N>
__device__ __forceinline__ void conv_mul_n(const uint32_t* a, const uint32_t* b,
                                           uint32_t* cols) {
#pragma unroll
  for (int k = 0; k < 2 * N + 1; ++k) cols[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint32_t prod = a[i] * b[j];
      cols[i + j] += prod & kMask16;
      cols[i + j + 1] += prod >> 16;
    }
}

// product of 17-bit limbs: (x + c 2^16)(y + d 2^16) with the cross terms
// as masked adds
template <int N>
__device__ __forceinline__ void conv_mid(const uint32_t* sa, const uint32_t* sb,
                                         uint32_t* cols) {
#pragma unroll
  for (int k = 0; k < 2 * N + 1; ++k) cols[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint32_t xa = sa[i] & kMask16, ca = sa[i] >> 16;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint32_t xb = sb[j] & kMask16, cb = sb[j] >> 16;
      uint32_t prod = xa * xb;
      uint32_t cross = (cb > 0 ? xa : 0u) + (ca > 0 ? xb : 0u);
      cols[i + j] += prod & kMask16;
      cols[i + j + 1] = cols[i + j + 1] + (prod >> 16) + (cross & kMask16);
      cols[i + j + 2] = cols[i + j + 2] + (cross >> 16) + ca * cb;
    }
  }
}

template <int N, int D>
__device__ __forceinline__ void conv_kar(const uint32_t* a, const uint32_t* b,
                                         uint32_t* out) {
  if constexpr (D == 0 || N <= 4) {
    conv_mul_n<N>(a, b, out);
  } else {
    constexpr int H = N / 2;
    uint32_t sa[H], sb[H], z0[2 * H + 1], z1[2 * H + 1], z2[2 * H + 1];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      sa[i] = a[i] + a[H + i];
      sb[i] = b[i] + b[H + i];
    }
    conv_kar<H, D - 1>(a, b, z0);
    conv_kar<H, D - 1>(a + H, b + H, z2);
    conv_mid<H>(sa, sb, z1);
#pragma unroll
    for (int k = 0; k < 2 * N + 1; ++k) out[k] = 0;
#pragma unroll
    for (int i = 0; i < 2 * H + 1; ++i) out[i] += z0[i];
#pragma unroll
    for (int i = 0; i < 2 * H + 1; ++i) out[i + 2 * H] += z2[i];
    // the script's +3<<24 then -3<<24 around this add cancel mod 2^32
#pragma unroll
    for (int i = 0; i < 2 * H + 1; ++i) out[i + H] += z1[i] - z0[i] - z2[i];
  }
}

// Karatsuba's columns as signed integers, carried into nonnegative 16-bit
// columns (T = a * b < 2^512 keeps the top one nonnegative).
__device__ __forceinline__ void carry_signed(uint32_t* cols) {
  int32_t c = 0;
#pragma unroll
  for (int k = 0; k < 33; ++k) {
    int32_t v = (int32_t)cols[k] + c;
    cols[k] = (uint32_t)v & kMask16;
    c = v >> 16;  // arithmetic: floor division by 2^16
  }
}

// ------------------------------------------------------------ tensor cores

constexpr int kWarps = 4;
constexpr int kDigitStride = 80;  // bytes a column of the u8 right sides
constexpr int kWideStride = 65;   // words a column of the s32 products

// d += A . B, m16n8k32, u8 x u8 -> s32 (layouts as in csrc/exp_rates.cu)
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment r of the 16-row tile mt, k step ks, of a row-major u8 matrix
// with `ld` bytes a row
__device__ __forceinline__ uint32_t a_frag(const uint8_t* m, int ld, int mt,
                                           int ks, int r, int g, int t) {
  int row = mt * 16 + g + 8 * (r & 1);
  int col = ks * 32 + 4 * t + 16 * (r >> 1);
  return *reinterpret_cast<const uint32_t*>(m + row * ld + col);
}

// wide[element][row] <- (M . digits)[row][element] for the warp's 32
// elements: M is MT 16-row tiles by KS 32-deep steps, digits[element][k]
template <int MT, int KS>
__device__ __forceinline__ void warp_product(const uint8_t* m, int ld,
                                             const uint8_t* digits,
                                             int32_t* wide, int g, int t) {
  uint32_t a[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[mt][ks][r] = a_frag(m, ld, mt, ks, r, g, t);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const uint8_t* col = digits + (nt * 8 + g) * kDigitStride + 4 * t;
    uint32_t b[KS][2];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      b[ks][0] = *reinterpret_cast<const uint32_t*>(col + ks * 32);
      b[ks][1] = *reinterpret_cast<const uint32_t*>(col + ks * 32 + 16);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      int d[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) mma_u8(d, a[mt][ks], b[ks][0], b[ks][1]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int row = mt * 16 + g + 8 * (r >> 1);
        int elem = nt * 8 + 2 * t + (r & 1);
        wide[elem * kWideStride + row] = d[r];
      }
    }
  }
}

// The REDC of mxu_redc on the tensor cores; with NOCARRY the ablation
// `mxunocarry` (no carry passes, out[i] = mp[i] ^ mp[i + 32]).  Every lane
// of the warp must call it.  cols: 16-bit-position columns, nonnegative,
// below 2^23.
template <bool NOCARRY>
__device__ __forceinline__ void mxu_redc(const uint32_t* cols, const Mod16& M,
                                         const uint8_t* nmat,
                                         const uint8_t* pmat, uint8_t* digits,
                                         int32_t* wide, int lane,
                                         uint32_t* out) {
  const int g = lane / 4, t = lane % 4;
  uint8_t* mine = digits + lane * kDigitStride;
  int32_t* wmine = wide + lane * kWideStride;
  // T's components (k, d), 2k + d < 32: bits 8d.. of column k (d < 2) or
  // its bits 16.. (d = 2); 47 of them, padded to 64
  {
    int r = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        if (2 * k + d < 32)
          mine[r++] = (uint8_t)(d < 2 ? (cols[k] >> (8 * d)) & 0xFFu
                                      : cols[k] >> 16);
#pragma unroll
    for (; r < 64; ++r) mine[r] = 0;
  }
  __syncwarp();
  warp_product<2, 2>(nmat, 64, digits, wide, g, t);  // m columns [32]
  __syncwarp();
  // m as 32 digits mod 2^256 (NOCARRY: each column's low byte)
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    uint32_t v = (uint32_t)wmine[j] + carry;
    mine[j] = (uint8_t)(v & 0xFFu);
    if constexpr (!NOCARRY) carry = v >> 8;
  }
  __syncwarp();
  warp_product<4, 1>(pmat, 32, digits, wide, g, t);  // m * p [64]
  __syncwarp();
  if constexpr (NOCARRY) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      out[i] = (uint32_t)wmine[i] ^ (uint32_t)wmine[i + 32];
    return;
  }
  // T's digit j: bits 8d.. of column k = j / 2, plus the bits 16.. of
  // column k - 1 at even j
  auto tdig = [&](int j) {
    int k = j >> 1, d = j & 1;
    uint32_t v = (cols[k] >> (8 * d)) & 0xFFu;
    if (d == 0 && k >= 1) v += cols[k - 1] >> 16;
    return v;
  };
  carry = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) carry = ((uint32_t)wmine[j] + tdig(j) + carry) >> 8;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    int j = 32 + 2 * i;
    uint32_t lo = (uint32_t)wmine[j] + tdig(j) + carry;
    uint32_t hi = (uint32_t)wmine[j + 1] + tdig(j + 1) + (lo >> 8);
    out[i] = (lo & 0xFFu) | ((hi & 0xFFu) << 8);
    carry = hi >> 8;
  }
  cond_sub16(out, carry, M);
}

template <int V>
__global__ void __launch_bounds__(kWarps * 32)
mxu_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, long long n, Mod16 M,
               const uint8_t* __restrict__ nmat,
               const uint8_t* __restrict__ pmat) {
  constexpr bool TC = V == MXU || V == KAR_MXU || V == MXUNOCARRY;
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = e < n;
  if constexpr (!TC) {
    if (!valid) return;
  }
  // a warp with a ragged edge still runs the mma whole: its idle lanes
  // carry zeros
  uint32_t x[16], y[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    x[i] = valid ? a[i * n + e] : 0u;
    y[i] = valid ? b[i * n + e] : 0u;
  }
  uint32_t cols[33], r[16];
  if constexpr (V == KAR || V == KAR_MXU)
    conv_kar<16, 2>(x, y, cols);
  else
    schoolbook16<false>(x, y, cols);
  if constexpr (V == BASE) {
    word_redc16<false>(cols, M, r);
  } else if constexpr (V == KAR) {
    word_redc16<false, true>(cols, M, r);  // signed columns, signed carries
  } else if constexpr (V == CONVONLY) {
#pragma unroll
    for (int i = 0; i < 16; ++i) r[i] = cols[i] ^ cols[i + 16];
  } else {
    __shared__ __align__(16) uint8_t digits_all[kWarps][32 * kDigitStride];
    __shared__ int32_t wide_all[kWarps][32 * kWideStride];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if constexpr (V == KAR_MXU) carry_signed(cols);
    mxu_redc<V == MXUNOCARRY>(cols, M, nmat, pmat, digits_all[warp],
                              wide_all[warp], lane, r);
  }
  if (valid) {
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i * n + e] = r[i];
  }
}

template <int V>
static void launch(unsigned blocks, cudaStream_t s, const uint32_t* a,
                   const uint32_t* b, uint32_t* out, long long n,
                   const Mod16& M, const uint8_t* nmat, const uint8_t* pmat) {
  mxu_mul_kernel<V><<<blocks, kWarps * 32, 0, s>>>(a, b, out, n, M, nmat, pmat);
}

// nmat: u8 [32, 64] (NMAT padded to K = 64); pmat: u8 [64, 32]
extern "C" int zk_exp_mxu_mul(int variant, const void* a, const void* b,
                              void* out, long long n, const void* mod,
                              const void* nmat, const void* pmat,
                              void* stream) {
  if (n <= 0) return 0;
  Mod16 M = mod16_from_words(static_cast<const uint32_t*>(mod));
  unsigned blocks = (unsigned)((n + kWarps * 32 - 1) / (kWarps * 32));
  auto* pa = static_cast<const uint32_t*>(a);
  auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<uint32_t*>(out);
  auto* nm = static_cast<const uint8_t*>(nmat);
  auto* pm = static_cast<const uint8_t*>(pmat);
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case BASE: launch<BASE>(blocks, s, pa, pb, po, n, M, nm, pm); break;
    case KAR: launch<KAR>(blocks, s, pa, pb, po, n, M, nm, pm); break;
    case MXU: launch<MXU>(blocks, s, pa, pb, po, n, M, nm, pm); break;
    case KAR_MXU: launch<KAR_MXU>(blocks, s, pa, pb, po, n, M, nm, pm); break;
    case CONVONLY: launch<CONVONLY>(blocks, s, pa, pb, po, n, M, nm, pm); break;
    case MXUNOCARRY:
      launch<MXUNOCARRY>(blocks, s, pa, pb, po, n, M, nm, pm);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
