// Point kernel K3: one complete group operation per element, six kinds.
//
// Replaces zksnap_tpu/curves/fused.py `_point_call` (reached through
// `point_add_fused` / `point_dbl_fused`): padd, pmadd, pdbl (RCB 2015
// complete projective, a = 0) and add, madd, dbl (Jacobian with
// completeness selects).  The TPU kernel transposes to limb-major [16, n]
// tiles padded to 128- or 1024-lane blocks; this one reads the port's
// [n, 16] rows directly, the ragged edge masked.  The Jacobian add and
// dbl also serve K8 (zksnap_tpu/curves/pallas_point.py `_point_fns`) and
// K7 (`_staged_add_fn`, the same add in one launch): curves/pallas_point.py
// launches them through this kernel.
//
// Bound on the H100: the IMAD pipe.  A padd is 12 Montgomery products
// (3,168 32-bit multiply results) against 6 x 64 bytes read and 3 x 64
// written; a Jacobian add 16 (and the 7 of a dbl where P == Q).  Every
// kind runs point_inline.cuh's inlined formulas: no stack frame, no
// local memory.  The prover's kinds, padd, pmadd and pdbl, run a stage's
// products side by side, shared by POINT_GROUP adjacent threads a point
// (fe_mul_group): twice the warps of one thread a point, each thread
// holding half of a stage's products, so that more warps hide the
// products' latency.  zk_point picks their threads a block from n and the
// caller's SM count so that the grid covers every SM where n allows
// (point_threads): at the k=13 path's n = 8192 blocks of 128 threads
// would leave most of the card idle.  A group past the end computes the
// last row and stores nothing, so that every thread of a warp reaches the
// group's shuffles.  The Jacobian kinds (the SRS's double-and-add, K7,
// K8) take one thread a point and one product at a time, the add as a
// program through one copy of the product's code, its doubling fallback
// only in the blocks that hold a lane with P == Q.

#include "point_inline.cuh"

constexpr int POINT_THREADS = 128;  // the most threads a block
constexpr int POINT_GROUP = 2;      // threads a point of the RCB kinds

// At least three blocks an SM, so at most 170 registers a thread: bound
// to four (128 registers), padd ran 4 % slower at n = 8192 on the H100,
// and the Jacobian add spilled.
template <int KIND, int T>
__global__ void __launch_bounds__(POINT_THREADS, 3)
point_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
             const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
             const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
             int32_t* __restrict__ ox, int32_t* __restrict__ oy,
             int32_t* __restrict__ oz, long long n, int b3, Modulus M) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / T;
  const long long o = (i < n ? i : n - 1) * 16;
  Pt r;
  if constexpr (KIND == K_ADD || KIND == K_MADD) {
    r = jadd_prog<KIND == K_MADD>(PtRows{x1 + o, y1 + o, z1 + o},
                                  PtRows{x2 + o, y2 + o, z2 + o}, M);
  } else {
    Pt p{fe_load(x1 + o), fe_load(y1 + o), fe_load(z1 + o)};
    if constexpr (KIND == K_DBL) {
      r = jdbl_inl(p, M);
    } else if constexpr (KIND == K_PDBL) {
      r = pdbl_inl<T>(p, b3, M);
    } else {
      Pt q{fe_load(x2 + o), fe_load(y2 + o), fe_load(z2 + o)};
      if constexpr (KIND == K_PADD) r = padd_inl<T>(p, q, b3, M);
      if constexpr (KIND == K_PMADD) r = padd_mixed_inl<T>(p, q, b3, M);
    }
  }
  if (i < n) pt_store_share<T>(ox, oy, oz, i, r);
}

struct PointArgs {
  const int32_t *x1, *y1, *z1, *x2, *y2, *z2;
  int32_t *ox, *oy, *oz;
  long long n;
  int b3;
};

template <int KIND, int T>
static void launch_point(const PointArgs& a, unsigned blocks, int threads,
                         const Modulus& M, cudaStream_t s) {
  point_kernel<KIND, T><<<blocks, threads, 0, s>>>(
      a.x1, a.y1, a.z1, a.x2, a.y2, a.z2, a.ox, a.oy, a.oz, a.n, a.b3, M);
}

// Threads a block for `work` threads on `sms` SMs: the largest power of
// two up to POINT_THREADS that still gives every SM a block, or one warp
// where work is too little for that.
static int point_threads(long long work, int sms) {
  int threads = POINT_THREADS;
  while (threads > 32 && (work + threads - 1) / threads < sms) threads /= 2;
  return threads;
}

extern "C" int zk_point(int kind, const void* x1, const void* y1,
                        const void* z1, const void* x2, const void* y2,
                        const void* z2, void* ox, void* oy, void* oz,
                        long long n, int b3, int sms, const void* mod,
                        void* stream) {
  if (n <= 0) return 0;
  Modulus M = modulus_from_words(static_cast<const uint32_t*>(mod));
  const bool proj = kind == K_PADD || kind == K_PMADD || kind == K_PDBL;
  const long long work = n * (proj ? POINT_GROUP : 1);
  const int threads = point_threads(work, sms);
  const unsigned blocks = (unsigned)((work + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const PointArgs a{static_cast<const int32_t*>(x1),
                    static_cast<const int32_t*>(y1),
                    static_cast<const int32_t*>(z1),
                    static_cast<const int32_t*>(x2),
                    static_cast<const int32_t*>(y2),
                    static_cast<const int32_t*>(z2),
                    static_cast<int32_t*>(ox),
                    static_cast<int32_t*>(oy),
                    static_cast<int32_t*>(oz),
                    n,
                    b3};
  switch (kind) {
    case K_ADD: launch_point<K_ADD, 1>(a, blocks, threads, M, s); break;
    case K_MADD: launch_point<K_MADD, 1>(a, blocks, threads, M, s); break;
    case K_DBL: launch_point<K_DBL, 1>(a, blocks, threads, M, s); break;
    case K_PADD: launch_point<K_PADD, POINT_GROUP>(a, blocks, threads, M, s); break;
    case K_PMADD: launch_point<K_PMADD, POINT_GROUP>(a, blocks, threads, M, s); break;
    case K_PDBL: launch_point<K_PDBL, POINT_GROUP>(a, blocks, threads, M, s); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  ZK_CHECK_RETURN();
}
