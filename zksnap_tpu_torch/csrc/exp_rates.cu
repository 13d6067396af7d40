// Kernel K11: raw op-rate probes of an experiment.
//
// Replaces scripts/exp_vpu_rates.py: `make_chain` (the pallas_call at :75;
// dependent chains of one operation on [16, W] uint32 tiles) and
// `make_dot` (the pallas_calls at :102 and :126; 64 dependent [64,32] x
// [32,W] products on the matrix unit).
//
// op_chain_kernel<KIND>: one thread a lane, the chain in registers, one
// load of a and b and one store.  Each step is inline PTX under
// `asm volatile`, so the front end cannot fold a loop of `a += b` into
// `a + chain * b`.  ptxas still may, and does: it fuses two `add.u32`
// steps into one IADD3, and folds `u32mask`'s step, the identity once
// x < 2^16, to its first of kChainUnroll.  So the chain runs as a rolled
// loop of exactly kChainUnroll steps (and a rolled remainder loop of one),
// and chip_smoke.py reads that loop's body from `cuobjdump -sass` to bound
// a step by what it really issues, pipe by pipe.  Bound by that issue rate;
// the chain's latency is hidden by the other warps.
//
// dot_chain_kernel<KIND>: one warp owns eight columns of W for all n_mm
// steps, since each product feeds the next.  The [64, 32] left side stays
// in registers as mma A fragments (four 16-row tiles); a step is four
// `mma.sync` m16n8k32 (s8 x s8 -> s32) for i8dot, or eight m16n8k16
// (bf16 x bf16 -> f32) for bf16dot; rows 0..31 of the product go back
// through 256 or 512 bytes of shared memory into the B-fragment layout as
// the next step's right side, converted as the TPU kernel converts them
// (int8 wraps; bf16 is y * 1e-3 rounded to nearest even).  A chain of
// dependent mma latencies: far below the tensor cores' rate, which wgmma
// would need; that and any tuning are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum ChainKind { U32MUL = 0, U16MUL = 1, U32ADD = 2, U32MASK = 3, F32FMA = 4 };

// steps a trip of the chain's main loop (exp_vpu_rates.CHAIN_UNROLL)
constexpr int kChainUnroll = 16;

template <int KIND>
__device__ __forceinline__ void chain_step(uint32_t& x, uint32_t y) {
  if constexpr (KIND == U32MUL) {
    asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x) : "r"(y), "r"(1u));
  } else if constexpr (KIND == U16MUL) {
    asm volatile("mul.lo.u32 %0, %0, %1;\n\tand.b32 %0, %0, 65535;"
                 : "+r"(x) : "r"(y));
  } else if constexpr (KIND == U32ADD) {
    asm volatile("add.u32 %0, %0, %1;" : "+r"(x) : "r"(y));
  } else if constexpr (KIND == U32MASK) {
    asm volatile(
        "{\n\t.reg .u32 t;\n\tshr.u32 t, %0, 16;\n\tand.b32 %0, %0, 65535;"
        "\n\tor.b32 %0, %0, t;\n\t}"
        : "+r"(x));
  }
}

__device__ __forceinline__ void fma_step(float& x, float y) {
  asm volatile("fma.rn.f32 %0, %0, %1, 0f3F800000;" : "+f"(x) : "f"(y));
}

template <int KIND>
__global__ void __launch_bounds__(256)
op_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out, long long n, int chain) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x = a[i], y = b[i];
  if constexpr (KIND == F32FMA) {
    // x.astype(int32).astype(float32), then x * y + 1 in one rounding, then
    // the truncating cast, which saturates (+-inf) and maps NaN to 0
    float fx = __int2float_rn((int)x), fy = __int2float_rn((int)y);
    int s = 0;
#pragma unroll 1
    for (; s + kChainUnroll <= chain; s += kChainUnroll) {
#pragma unroll
      for (int u = 0; u < kChainUnroll; ++u) fma_step(fx, fy);
    }
#pragma unroll 1
    for (; s < chain; ++s) fma_step(fx, fy);
    out[i] = (uint32_t)__float2int_rz(fx);
  } else {
    if constexpr (KIND == U16MUL) {
      x &= 0xFFFFu;
      y &= 0xFFFFu;
    }
    int s = 0;
#pragma unroll 1
    for (; s + kChainUnroll <= chain; s += kChainUnroll) {
#pragma unroll
      for (int u = 0; u < kChainUnroll; ++u) chain_step<KIND>(x, y);
    }
#pragma unroll 1
    for (; s < chain; ++s) chain_step<KIND>(x, y);
    out[i] = x;
  }
}

extern "C" int zk_exp_chain(int kind, const void* a, const void* b, void* out,
                            long long n, int chain, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  auto* pa = static_cast<const uint32_t*>(a);
  auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<uint32_t*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case U32MUL:
      op_chain_kernel<U32MUL><<<blocks, threads, 0, s>>>(pa, pb, po, n, chain);
      break;
    case U16MUL:
      op_chain_kernel<U16MUL><<<blocks, threads, 0, s>>>(pa, pb, po, n, chain);
      break;
    case U32ADD:
      op_chain_kernel<U32ADD><<<blocks, threads, 0, s>>>(pa, pb, po, n, chain);
      break;
    case U32MASK:
      op_chain_kernel<U32MASK><<<blocks, threads, 0, s>>>(pa, pb, po, n, chain);
      break;
    case F32FMA:
      op_chain_kernel<F32FMA><<<blocks, threads, 0, s>>>(pa, pb, po, n, chain);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- dots
//
// Fragment layouts (PTX ISA, mma.m16n8k32 .s8 and mma.m16n8k16 .bf16), with
// g = lane / 4 and t = lane % 4:
//   A (16 x K, row-major): register r holds row g + 8 * (r & 1), columns
//     4t..4t+3 (+16 for r >= 2) for s8; 2t, 2t+1 (+8 for r >= 2) for bf16;
//   B (K x 8): register r holds column g, rows 4t..4t+3 (+16 for r = 1)
//     for s8; rows 2t, 2t+1 (+8 for r = 1) for bf16;
//   C (16 x 8): c0, c1 at row g, columns 2t, 2t+1; c2, c3 at row g + 8.
// Shared memory keeps a warp's right side as xs[column][k] (32 k a column),
// so a B register is one aligned 32-bit load.

enum DotKind { I8DOT = 0, BF16DOT = 1 };

constexpr int kDotWarps = 4;  // warps a block; each owns 8 columns

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0), "r"(0), "r"(0), "r"(0));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// i8dot: acc[64, W] (int32) = sum of n_mm products y = L x, x <- int8(y[:32])
__global__ void __launch_bounds__(kDotWarps * 32)
dot_chain_i8_kernel(const int8_t* __restrict__ lhs,
                    const int8_t* __restrict__ x0, int32_t* __restrict__ acc,
                    int W, int n_mm) {
  __shared__ __align__(16) int8_t xs_all[kDotWarps][8 * 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int col0 = (blockIdx.x * kDotWarps + warp) * 8;
  if (col0 >= W) return;  // whole warps only: W is a multiple of 8
  int8_t* xs = xs_all[warp];

  uint32_t a[4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int row = mt * 16 + g + 8 * (r & 1);
      int col = 4 * t + 16 * (r >> 1);
      a[mt][r] = *reinterpret_cast<const uint32_t*>(lhs + row * 32 + col);
    }
  {  // x0 rows k = lane, eight columns each
    const int8_t* src = x0 + (long long)lane * W + col0;
#pragma unroll
    for (int c = 0; c < 8; ++c) xs[c * 32 + lane] = src[c];
  }
  __syncwarp();
  int sum[4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) sum[mt][r] = 0;

  for (int s = 0; s < n_mm; ++s) {
    uint32_t b0 = *reinterpret_cast<const uint32_t*>(xs + g * 32 + 4 * t);
    uint32_t b1 = *reinterpret_cast<const uint32_t*>(xs + g * 32 + 16 + 4 * t);
    __syncwarp();
    int y[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      mma_s8(y[mt], a[mt], b0, b1);
#pragma unroll
      for (int r = 0; r < 4; ++r) sum[mt][r] += y[mt][r];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int row = mt * 16 + g + 8 * (r >> 1);
        int col = 2 * t + (r & 1);
        xs[col * 32 + row] = (int8_t)y[mt][r];
      }
    __syncwarp();
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int row = mt * 16 + g + 8 * (r >> 1);
      int col = col0 + 2 * t + (r & 1);
      acc[(long long)row * W + col] = sum[mt][r];
    }
}

// bf16dot: acc[64, W] (f32) = sum of n_mm products y = bf16(L) x (f32
// accumulate), x <- bf16(y[:32] * 1e-3)
__global__ void __launch_bounds__(kDotWarps * 32)
dot_chain_bf16_kernel(const float* __restrict__ lhs,
                      const uint16_t* __restrict__ x0,
                      float* __restrict__ acc, int W, int n_mm) {
  __shared__ __align__(16) uint16_t xs_all[kDotWarps][8 * 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int col0 = (blockIdx.x * kDotWarps + warp) * 8;
  if (col0 >= W) return;
  uint16_t* xs = xs_all[warp];

  uint32_t a[4][2][4];  // [m tile][k step][register]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int row = mt * 16 + g + 8 * (r & 1);
        int col = ks * 16 + 2 * t + 8 * (r >> 1);
        a[mt][ks][r] = pack_bf16(lhs[row * 32 + col], lhs[row * 32 + col + 1]);
      }
  {
    const uint16_t* src = x0 + (long long)lane * W + col0;
#pragma unroll
    for (int c = 0; c < 8; ++c) xs[c * 32 + lane] = src[c];
  }
  __syncwarp();
  float sum[4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) sum[mt][r] = 0.f;

  for (int s = 0; s < n_mm; ++s) {
    uint32_t b[2][2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      b[ks][0] = *reinterpret_cast<const uint32_t*>(xs + g * 32 + ks * 16 + 2 * t);
      b[ks][1] =
          *reinterpret_cast<const uint32_t*>(xs + g * 32 + ks * 16 + 8 + 2 * t);
    }
    __syncwarp();
    float y[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) y[mt][r] = 0.f;
      mma_bf16(y[mt], a[mt][0], b[0][0], b[0][1]);
      mma_bf16(y[mt], a[mt][1], b[1][0], b[1][1]);
#pragma unroll
      for (int r = 0; r < 4; ++r) sum[mt][r] = __fadd_rn(sum[mt][r], y[mt][r]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int row = mt * 16 + g + 8 * (r >> 1);
        int col = 2 * t + (r & 1);
        __nv_bfloat16 v = __float2bfloat16_rn(__fmul_rn(y[mt][r], 1e-3f));
        xs[col * 32 + row] = *reinterpret_cast<uint16_t*>(&v);
      }
    __syncwarp();
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int row = mt * 16 + g + 8 * (r >> 1);
      int col = col0 + 2 * t + (r & 1);
      acc[(long long)row * W + col] = sum[mt][r];
    }
}

extern "C" int zk_exp_dot(int kind, const void* lhs, const void* x0, void* acc,
                          int W, int n_mm, void* stream) {
  if (W <= 0) return 0;
  if (W % 8) return (int)cudaErrorInvalidValue;
  const int warps = W / 8;
  unsigned blocks = (unsigned)((warps + kDotWarps - 1) / kDotWarps);
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == I8DOT)
    dot_chain_i8_kernel<<<blocks, kDotWarps * 32, 0, s>>>(
        static_cast<const int8_t*>(lhs), static_cast<const int8_t*>(x0),
        static_cast<int32_t*>(acc), W, n_mm);
  else if (kind == BF16DOT)
    dot_chain_bf16_kernel<<<blocks, kDotWarps * 32, 0, s>>>(
        static_cast<const float*>(lhs), static_cast<const uint16_t*>(x0),
        static_cast<float*>(acc), W, n_mm);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
