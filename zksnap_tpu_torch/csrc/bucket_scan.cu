// Bucket-scan kernel K4: the Pippenger accumulation loop.
//
// Replaces zksnap_tpu/curves/fused.py `_bucket_scan_call` (reached through
// `bucket_scan_fused`).  The bucket-sorted affine stream of n_pad = M*K
// points is cut into M lanes; lane l owns positions [l*K, (l+1)*K) and runs
// a segmented running sum over them: at each step it adds the stream point
// to its accumulator (pmadd for RCB projective, madd for Jacobian), or
// restarts from the point where the segment flag is set, and writes every
// step's partial sum to out[k, l].  On the TPU the sequential grid carries
// the accumulator in VMEM scratch; here lanes are independent, so one
// thread owns a lane and loops over its K steps with the accumulator in
// registers.
//
// Bound on the H100: the IMAD pipe.  A pmadd step is 11 Montgomery
// products (2,904 32-bit multiply results) against 192 bytes in and 192
// out, so the products, not HBM, set the pace.  A step written with
// field.cuh's and point.cuh's out-of-line fe_mul and padd makes 11 calls
// through a 520-byte stack frame, runs the products one after another,
// issues the next step's loads after the arithmetic, and has two warps a
// scheduler to hide all of it: about a third of the IMAD rate.  Here:
//   * one inlined step (point_inline.cuh): no stack frame, the Modulus
//     read from the parameter bank, the five independent products that
//     open Algorithm 8 and the six of its second stage interleaved;
//   * loads ahead of the chain: step k+1's three rows go into a ring of
//     two stages in shared memory by cp.async (each thread its own slots,
//     chunk-major, so that a warp's copies and reads are consecutive), and
//     its flag into a register, while step k computes (K5's register
//     prefetch, reduce.cu's pt_fetch, spills here: its 48 more registers
//     on top of the step's 252 cost a 160-byte stack frame and made the
//     scan 19 % slower on the H100);
//   * __launch_bounds__(128, 2): the caller's M = 32768 lanes make 256
//     blocks, at most two on an SM, so ptxas may give a thread up to 255
//     registers for the interleaving.
// The Jacobian branch (b3 == 0; no caller on the prover's path) keeps
// point.cuh's out-of-line madd.

#include "point_inline.cuh"

constexpr int SCAN_THREADS = 128;
constexpr int SCAN_CHUNKS = 12;  // 16-byte chunks of a step's x, y, z rows

// One stage of the ring: each thread's three rows of one step.
struct ScanStage {
  int4 v[SCAN_CHUNKS][SCAN_THREADS];
};

__device__ __forceinline__ void cp_async16(int4* smem, const int32_t* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every group but the one committed last has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ Fe fe_unpack(const ScanStage& s, int c, int tid) {
  Fe r;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int4 t = s.v[c + q][tid];
    r.w[2 * q] = (uint32_t)t.x | ((uint32_t)t.y << 16);
    r.w[2 * q + 1] = (uint32_t)t.z | ((uint32_t)t.w << 16);
  }
  return r;
}

template <bool PROJ>
__global__ void __launch_bounds__(SCAN_THREADS, 2)
bucket_scan_kernel(const uint8_t* __restrict__ flags,
                   const int32_t* __restrict__ x,
                   const int32_t* __restrict__ y,
                   const int32_t* __restrict__ z, int32_t* __restrict__ ox,
                   int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                   long long M_lanes, long long K, int b3, Modulus M) {
  __shared__ ScanStage ring[2];
  const int tid = threadIdx.x;
  const long long lane = (long long)blockIdx.x * SCAN_THREADS + tid;
  if (lane >= M_lanes) return;  // no barrier below: slots are per thread
  const long long first = lane * K;
  auto fetch = [&](long long k) {
    ScanStage& s = ring[k & 1];
    const long long o = (first + k) * 16;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cp_async16(&s.v[q][tid], x + o + 4 * q);
      cp_async16(&s.v[4 + q][tid], y + o + 4 * q);
      cp_async16(&s.v[8 + q][tid], z + o + 4 * q);
    }
  };
  fetch(0);
  cp_async_commit();
  bool restart = flags[first] != 0;
  // identity: RCB (0 : 1 : 0), Jacobian (1 : 1 : 0)
  Pt acc{PROJ ? fe_zero() : fe_one(M), fe_one(M), fe_zero()};
  for (long long k = 0; k < K; ++k) {
    // step k+1 lands in the stage that step k-1 read
    if (k + 1 < K) fetch(k + 1);
    cp_async_commit();
    const bool restart_next = k + 1 < K && flags[first + k + 1] != 0;
    cp_async_wait_prior();
    const ScanStage& s = ring[k & 1];
    Pt p{fe_unpack(s, 0, tid), fe_unpack(s, 4, tid), fe_unpack(s, 8, tid)};
    Pt sum;
    if constexpr (PROJ)
      sum = padd_mixed_inl(acc, p, b3, M);
    else
      sum = jadd<true>(acc, p, M);
    acc = pt_select(restart, p, sum);
    long long w = (k * M_lanes + lane) * 16;
    fe_store(ox + w, acc.x);
    fe_store(oy + w, acc.y);
    fe_store(oz + w, acc.z);
    restart = restart_next;
  }
}

extern "C" int zk_bucket_scan(const void* flags, const void* x, const void* y,
                              const void* z, void* ox, void* oy, void* oz,
                              long long lanes, long long steps, int proj,
                              int b3, const void* mod, void* stream) {
  if (lanes <= 0 || steps <= 0) return 0;
  Modulus M = modulus_from_words(static_cast<const uint32_t*>(mod));
  unsigned blocks = (unsigned)((lanes + SCAN_THREADS - 1) / SCAN_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  auto F = static_cast<const uint8_t*>(flags);
  auto X = static_cast<const int32_t*>(x), Y = static_cast<const int32_t*>(y),
       Z = static_cast<const int32_t*>(z);
  auto OX = static_cast<int32_t*>(ox), OY = static_cast<int32_t*>(oy),
       OZ = static_cast<int32_t*>(oz);
  if (proj)
    bucket_scan_kernel<true><<<blocks, SCAN_THREADS, 0, s>>>(F, X, Y, Z, OX, OY, OZ, lanes, steps, b3, M);
  else
    bucket_scan_kernel<false><<<blocks, SCAN_THREADS, 0, s>>>(F, X, Y, Z, OX, OY, OZ, lanes, steps, b3, M);
  ZK_CHECK_RETURN();
}
