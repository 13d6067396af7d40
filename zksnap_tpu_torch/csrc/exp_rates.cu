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
// dot_chain_kernel<KIND>: the chain turned round, y^T = x^T . L^T, so
// that the chained operand is the product's A side and never leaves
// registers.  A block is one warpgroup and owns 64 columns of W for all
// n_mm steps, the columns as the product's M rows (warp w rows 16w..16w+15,
// as in the A and D fragments); L^T [32, 64] is the constant B side.  Each
// step issues two products of its A: y's outputs 0..31 fresh into
// registers, which become the next step's A fragments in registers,
// converted as the TPU kernel converts them (int8 wraps: the low byte of
// each s32, packed by PRMT; bf16 is y * 1e-3 rounded to nearest even,
// packed by cvt.rn.bf16x2.f32); and all 64 outputs added to the sum,
// which stays in the tensor cores' accumulator for the whole chain (half
// again the products, no adds).  The chain waits for the first product
// alone.  For bf16 (two k16 steps) D's n tiles 2ks, 2ks + 1 are A's
// registers of k step ks as they lie.  For int8 (k32) a thread's D
// positions {2t, 2t+1, 8+2t, 9+2t} are not A's K slots 4t..4t+3, so slot
// p of the contraction holds y's row pi(p) (exp_vpu_rates.DOT_PERM, a
// bijection on 0..15 and on 16..31): B's K row p is L's column pi(p) and
// x0's slot p its row pi(p), both read so once a launch; no step writes
// shared memory or shuffles.  The products are `wgmma` m64n32k32 and
// m64n64k32 s8 (m64n32k16 and m64n64k16 bf16, two each), B in shared
// memory as K-major core matrices (exp_vpu_rates.dot_b_image), the sum's
// product in flight while the next A is packed.  Bound on the H100 by the
// tensor cores' int8 or bf16 rate at large W; at W = 2^14 (about two
// warpgroups an SM) by a step's latency, 64 steps long.

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
    if constexpr (KIND == U32MASK) {
      // ptxas folds the trip's steps to two instructions, fewer than the
      // loop's own control: a count down to 0 spends one add and one test
      // a trip, where counting up to chain spends two adds and a test
#pragma unroll 1
      for (int t = chain / kChainUnroll; t > 0; --t) {
#pragma unroll
        for (int u = 0; u < kChainUnroll; ++u) chain_step<KIND>(x, y);
      }
#pragma unroll 1
      for (int t = chain % kChainUnroll; t > 0; --t) chain_step<KIND>(x, y);
    } else {
      int s = 0;
#pragma unroll 1
      for (; s + kChainUnroll <= chain; s += kChainUnroll) {
#pragma unroll
        for (int u = 0; u < kChainUnroll; ++u) chain_step<KIND>(x, y);
      }
#pragma unroll 1
      for (; s < chain; ++s) chain_step<KIND>(x, y);
    }
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
// Fragment layouts (PTX ISA: wgmma's A from registers and its D, a warp's
// 16 rows 16w.. laid out as mma.m16n8k32 .s8's and mma.m16n8k16 .bf16's),
// with g = lane / 4 and t = lane % 4:
//   A (16 x K): register r holds row g + 8 * (r & 1), K slots 4t..4t+3
//     (+16 for r >= 2) for s8; 2t, 2t+1 (+8 for r >= 2) for bf16;
//   D, n tile nt (8 columns): d[nt][0], d[nt][1] at row g, columns
//     8nt + 2t, 8nt + 2t + 1; d[nt][2], d[nt][3] at row g + 8.

enum DotKind { I8DOT = 0, BF16DOT = 1 };

constexpr int kDotCols = 64;  // columns of W a block (one warpgroup)

// pi(p): the row of y (and of x0) in the contraction's slot p
// (exp_vpu_rates.DOT_PERM)
__device__ __forceinline__ int dot_perm(int p) {
  const int i = p & 3;
  return (p & 16) + 2 * ((p >> 2) & 3) + (i & 1) + 8 * (i >> 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int KIND>
struct Dot;

// A thread's 16 registers of y's outputs 0..31 (n tiles 0..3), in the order
// of wgmma m64n32's D; DOT_D32 all 32 (n tiles 0..7), m64n64's
#define DOT_D16(c, d)                                                      \
  c(d[0][0]), c(d[0][1]), c(d[0][2]), c(d[0][3]), c(d[1][0]), c(d[1][1]),  \
      c(d[1][2]), c(d[1][3]), c(d[2][0]), c(d[2][1]), c(d[2][2]),          \
      c(d[2][3]), c(d[3][0]), c(d[3][1]), c(d[3][2]), c(d[3][3])
#define DOT_D32(c, d) DOT_D16(c, d), DOT_D16(c, (d + 4))
#define DOT_WG_N32                                                         \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "              \
  "{%16,%17,%18,%19}, %20, p"
#define DOT_WG_N64                                                         \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"                \
  "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "     \
  "{%32,%33,%34,%35}, %36, p"

// i8dot: acc[64, W] (int32) = sum of n_mm products y = L x, x <- int8(y[:32])
template <>
struct Dot<I8DOT> {
  using acc_t = int;
  using lhs_t = int8_t;
  using x_t = int8_t;
  static constexpr int KS = 1;             // k steps of a product
  static constexpr int kBBytes = 64 * 32;  // L^T in shared memory

  // A slot p of row m (a column of W): x0[pi(p)][m]
  static __device__ __forceinline__ void load_a(const int8_t* x0, int W,
                                                const int (&m)[2], int t,
                                                uint32_t (&a)[KS][4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t v = 0;
      if (m[r & 1] < W)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = dot_perm(16 * (r >> 1) + 4 * t + i);
          v |= (uint32_t)(uint8_t)x0[(long long)k * W + m[r & 1]] << (8 * i);
        }
      a[0][r] = v;
    }
  }

  // A register r, byte i <- the low byte of d[2(r>>1) + (i>>1)][2(r&1) + (i&1)]
  static __device__ __forceinline__ void repack(const int (&d)[4][4],
                                                uint32_t (&a)[KS][4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int nt = 2 * (r >> 1), j = 2 * (r & 1);
      a[0][r] = __byte_perm(__byte_perm(d[nt][j], d[nt][j + 1], 0x0040),
                            __byte_perm(d[nt + 1][j], d[nt + 1][j + 1], 0x0040),
                            0x5410);
    }
  }

  // one thread's 16-byte row of a core matrix: B = L^T under pi, N row n,
  // K slots 16 kb .. 16 kb + 15
  static __device__ __forceinline__ uint4 b_row(const int8_t* lhs, int n,
                                                int kb) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[q] |= (uint32_t)(uint8_t)lhs[n * 32 + dot_perm(16 * kb + 4 * q + i)]
                << (8 * i);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }

  // issues d = A . B's outputs 0..31 (one wgmma m64n32k32, A from
  // registers, B at desc)
  static __device__ __forceinline__ void wgmma_lo(int (&d)[4][4],
                                                  const uint32_t (&a)[KS][4],
                                                  uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 " DOT_WG_N32
        ";\n}\n"
        : DOT_D16("+r", d)
        : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]), "l"(desc),
          "r"(0));
  }

  // issues d += A . B, all 64 outputs (one wgmma m64n64k32)
  static __device__ __forceinline__ void wgmma_acc(int (&d)[8][4],
                                                   const uint32_t (&a)[KS][4],
                                                   uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " DOT_WG_N64
        ";\n}\n"
        : DOT_D32("+r", d)
        : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]), "l"(desc),
          "r"(1));
  }

  // after wgmma.wait_group: no use of d moves above it
  static __device__ __forceinline__ void pin(int (&d)[4][4]) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[nt][j])::"memory");
  }
};

// bf16dot: acc[64, W] (f32) = sum of n_mm products y = bf16(L) x (f32
// accumulate), x <- bf16(y[:32] * 1e-3)
template <>
struct Dot<BF16DOT> {
  using acc_t = float;
  using lhs_t = float;
  using x_t = uint16_t;
  static constexpr int KS = 2;
  static constexpr int kBBytes = 64 * 32 * 2;

  // A of k step ks, register r, half i: x0[16ks + 8(r>>1) + 2t + i][m]
  static __device__ __forceinline__ void load_a(const uint16_t* x0, int W,
                                                const int (&m)[2], int t,
                                                uint32_t (&a)[KS][4]) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint32_t v = 0;
        if (m[r & 1] < W) {
          const long long k = 16 * ks + 8 * (r >> 1) + 2 * t;
          v = x0[k * W + m[r & 1]] | (uint32_t)x0[(k + 1) * W + m[r & 1]] << 16;
        }
        a[ks][r] = v;
      }
  }

  // A of k step ks, register r <- d[2ks + (r>>1)][2(r&1)], [.. + 1], scaled
  static __device__ __forceinline__ void repack(const float (&d)[4][4],
                                                uint32_t (&a)[KS][4]) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int nt = 2 * ks + (r >> 1), j = 2 * (r & 1);
        a[ks][r] = pack_bf16(__fmul_rn(d[nt][j], 1e-3f),
                             __fmul_rn(d[nt][j + 1], 1e-3f));
      }
  }

  // one thread's 16-byte row of a core matrix: bf16(L[n][k]), k = 8kb..8kb+7
  // of the whole K (the k steps' cores 2048 bytes apart, kb = 2ks + kb')
  static __device__ __forceinline__ uint4 b_row(const float* lhs, int n,
                                                int kb) {
    const float* l = lhs + n * 32 + 8 * kb;
    return make_uint4(pack_bf16(l[0], l[1]), pack_bf16(l[2], l[3]),
                      pack_bf16(l[4], l[5]), pack_bf16(l[6], l[7]));
  }

  // issues d = A . B's outputs 0..31: two wgmma m64n32k16 into one
  // accumulator, k step 1's cores 2048 bytes on
  static __device__ __forceinline__ void wgmma_lo(float (&d)[4][4],
                                                  const uint32_t (&a)[KS][4],
                                                  uint64_t desc) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " DOT_WG_N32
          ", 1, 1, 0;\n}\n"
          : DOT_D16("+f", d)
          : "r"(a[ks][0]), "r"(a[ks][1]), "r"(a[ks][2]), "r"(a[ks][3]),
            "l"(desc + (uint64_t)(ks * (2048 >> 4))), "r"(ks));
  }

  // issues d += A . B, all 64 outputs (two wgmma m64n64k16)
  static __device__ __forceinline__ void wgmma_acc(float (&d)[8][4],
                                                   const uint32_t (&a)[KS][4],
                                                   uint64_t desc) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DOT_WG_N64
          ", 1, 1, 0;\n}\n"
          : DOT_D32("+f", d)
          : "r"(a[ks][0]), "r"(a[ks][1]), "r"(a[ks][2]), "r"(a[ks][3]),
            "l"(desc + (uint64_t)(ks * (2048 >> 4))), "r"(1));
  }

  static __device__ __forceinline__ void pin(float (&d)[4][4]) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[nt][j])::"memory");
  }
};

// B's descriptor: K-major core matrices of 8 N rows x 16 bytes of K, core
// (cb, kb) at (2 cb + kb) * 128 (exp_vpu_rates.dot_b_image); the leading
// offset is that of K-adjacent cores (128 bytes), the stride that of
// N-adjacent ones (256), no swizzle
__device__ __forceinline__ uint64_t dot_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16)
         | ((uint64_t)(256 >> 4) << 32);
}

// a step's products of a: y's outputs 0..31 into lo, and all 64 added to
// sum; two commit groups, lo's first, both in flight on return
template <class D>
__device__ __forceinline__ void dot_issue(typename D::acc_t (&lo)[4][4],
                                          typename D::acc_t (&sum)[8][4],
                                          const uint32_t (&a)[D::KS][4],
                                          uint64_t desc) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  D::wgmma_lo(lo, a, desc);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  D::wgmma_acc(sum, a, desc);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits for the last issue's lo (its sum may stay in flight), or for all
template <class D, int PENDING, int N>
__device__ __forceinline__ void dot_wait(typename D::acc_t (&d)[N][4]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
#pragma unroll
  for (int h = 0; h < N; h += 4)
    D::pin(*reinterpret_cast<typename D::acc_t(*)[4][4]>(d + h));
}

template <int KIND>
__global__ void __launch_bounds__(128)
dot_chain_kernel(const typename Dot<KIND>::lhs_t* __restrict__ lhs,
                 const typename Dot<KIND>::x_t* __restrict__ x0,
                 typename Dot<KIND>::acc_t* __restrict__ acc, int W,
                 int n_mm) {
  using D = Dot<KIND>;
  using acc_t = typename D::acc_t;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * kDotCols + 16 * warp + g;
  const int m[2] = {m0, m0 + 8};  // this thread's rows: columns of W
  // A takes turns between two register sets: the sum's product in flight
  // keeps the A it reads while the next step's A is packed.  x0's loads go
  // out before B's set-up.
  uint32_t a0[D::KS][4], a1[D::KS][4];
  D::load_a(x0, W, m, t, a0);

  // B in shared memory as core matrices
  __shared__ __align__(128) uint4 bsm[D::kBBytes / 16];
#pragma unroll
  for (int q = 0; q < D::kBBytes / 16 / 128; ++q) {
    // 16-byte row c: k step c / 128, core (c / 8) % 16 = 2 cb + kb, row
    // c % 8 of N within the core
    const int c = threadIdx.x + 128 * q, core = (c / 8) % 16;
    bsm[c] = D::b_row(lhs, 8 * (core / 2) + c % 8, 2 * (c / 128) + core % 2);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t desc = dot_desc(bsm);

  // each step: y's outputs 0..31 into d (the chain waits for these
  // alone), all 64 added to sum on the tensor cores
  acc_t sum[8][4], d[4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum[nt][j] = d[nt % 4][j] = 0;
  if (n_mm > 0) {
    dot_issue<D>(d, sum, a0, desc);  // step 0
    dot_wait<D, 1>(d);
    int s = 1;
#pragma unroll 1
    for (; s + 2 <= n_mm; s += 2) {
      D::repack(d, a1);
      dot_issue<D>(d, sum, a1, desc);
      dot_wait<D, 1>(d);
      D::repack(d, a0);
      dot_issue<D>(d, sum, a0, desc);
      dot_wait<D, 1>(d);
    }
    if (s < n_mm) {
      D::repack(d, a1);
      dot_issue<D>(d, sum, a1, desc);
    }
    dot_wait<D, 0>(sum);
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = m[j >> 1];
      if (col < W)
        acc[(long long)(8 * nt + 2 * t + (j & 1)) * W + col] = sum[nt][j];
    }
}

template <int KIND>
static void launch_dot(const void* lhs, const void* x0, void* acc, int W,
                       int n_mm, cudaStream_t s) {
  using D = Dot<KIND>;
  const unsigned blocks = (unsigned)((W + kDotCols - 1) / kDotCols);
  dot_chain_kernel<KIND><<<blocks, 128, 0, s>>>(
      static_cast<const typename D::lhs_t*>(lhs),
      static_cast<const typename D::x_t*>(x0),
      static_cast<typename D::acc_t*>(acc), W, n_mm);
}

extern "C" int zk_exp_dot(int kind, const void* lhs, const void* x0, void* acc,
                          int W, int n_mm, void* stream) {
  if (W <= 0) return 0;
  if (W % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == I8DOT)
    launch_dot<I8DOT>(lhs, x0, acc, W, n_mm, s);
  else if (kind == BF16DOT)
    launch_dot<BF16DOT>(lhs, x0, acc, W, n_mm, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
