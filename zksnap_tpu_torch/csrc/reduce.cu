// The fused Pippenger reduction: kernels K5 (weighted suffix) and K6
// (ladder and tree).
//
// K5 replaces zksnap_tpu/curves/fused.py `_weighted_suffix_call` (reached
// through `weighted_suffix_fused`).  Input: the window-major bucket sums
// S[w*B + b], B buckets to a window.  Output: the double suffix
// s2[w*B + b] = sum_{b' >= b} (b' - b + 1) * S[w, b'], the weighted bucket
// sum of window w at b = 0 (signed digits) or b = 1 (unsigned).  The TPU
// kernel runs 2*log2(B) Hillis-Steele rounds of rolls inside one VMEM
// block.  A window of 2^15 points (3 MB) does not fit in an SM's shared
// memory, so this kernel keeps the rounds and their operand order
// (bit-exact against the plain version) and moves the round barrier to the
// whole grid: one cooperative launch of as many blocks as can be resident,
// a grid-stride loop over the buckets inside each round, a grid.sync()
// between rounds, and two sets of (x, y, z) buffers in global memory, the
// output and the wrapper's scratch, alternating as source and destination.
// Reads go through L2 (__ldcg), as a round reads what other SMs wrote in
// the round before.
//   Bound on the H100: the function needs a sequential double suffix, 2
// complete additions per bucket: 2^20 padd at k = 21 (W = 16, B = 2^15),
// about 0.24 ms at the INT32 rate, above its 201 MB at HBM rate.  This
// kernel does 2*log2(B) additions per bucket, 30 * 2^19 ~ 15.7M, fifteen
// times the function's work, and is limited by the integer ALUs and by
// the grid barriers between its rounds.  The work-efficient chunked
// suffix is left for later; it changes the projective representatives,
// so its check would compare affine points.
//
// K6 replaces zksnap_tpu/curves/fused.py `_ladder_tree_call` (reached
// through `ladder_tree_fused`): T = sum_w 2^(c*w) S_w over 128 lanes (lane
// w < W holds window w's weighted sum, the rest (0 : 1 : 0)).  One block of
// 128 threads, one lane each: the masked doubling ladder (lane w doubles
// while i < c*w, for i < c*(W-1)) runs in registers; the 7 rounds of the
// suffix tree pass neighbours through shared memory with a barrier between
// rounds; lanes past the end read (0 : 1 : 0).  Operand order is the JAX
// kernel's, so the result is bit-exact against the plain version.
//   Bound on the H100: latency.  One SM runs c*(W-1) dependent doublings
// (240 at k = 21, 248 at K = 7) and 7 dependent additions.  The function
// itself (Horner's combine: c*(W-1) doublings and W-1 additions) is
// microseconds of the card's rate; the chain of dependent doublings is
// what the kernel waits on.
//
// Both take RCB projective points for b3 != 0 (padd / pdbl) and Jacobian
// ones for b3 == 0 (add / dbl), as the TPU kernels do.

#include <cooperative_groups.h>

#include "point.cuh"

namespace cg = cooperative_groups;

// A row read through L2 only: coherent with other SMs' earlier writes.
__device__ __forceinline__ Fe fe_load_cg(const int32_t* row) {
  const int4* v = reinterpret_cast<const int4*>(row);
  Fe r;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int4 t = __ldcg(v + q);
    r.w[2 * q] = (uint32_t)t.x | ((uint32_t)t.y << 16);
    r.w[2 * q + 1] = (uint32_t)t.z | ((uint32_t)t.w << 16);
  }
  return r;
}

__device__ __forceinline__ Pt pt_load_cg(const int32_t* x, const int32_t* y,
                                         const int32_t* z, long long i) {
  long long o = i * 16;
  return Pt{fe_load_cg(x + o), fe_load_cg(y + o), fe_load_cg(z + o)};
}

__device__ __forceinline__ void pt_store(int32_t* x, int32_t* y, int32_t* z,
                                         long long i, const Pt& p) {
  long long o = i * 16;
  fe_store(x + o, p.x);
  fe_store(y + o, p.y);
  fe_store(z + o, p.z);
}

template <bool PROJ>
__device__ __forceinline__ Pt group_add(const Pt& a, const Pt& b, int b3,
                                        const Modulus& M) {
  return PROJ ? padd<false>(a, b, b3, M) : jadd<false>(a, b, M);
}

template <bool PROJ>
__global__ void __launch_bounds__(128)
weighted_suffix_kernel(const int32_t* x, const int32_t* y, const int32_t* z,
                       int32_t* ox, int32_t* oy, int32_t* oz, int32_t* tx,
                       int32_t* ty, int32_t* tz, long long total, long long B,
                       int rounds, int b3, Modulus M) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const Pt ident{fe_zero(), fe_one(M), fe_zero()};
  const int32_t *sx = x, *sy = y, *sz = z;
  const int n_rounds = 2 * rounds;  // two suffix scans
  for (int r = 0; r < n_rounds; ++r) {
    // destinations alternate so that the last round writes the output
    const bool to_out = ((n_rounds - 1 - r) & 1) == 0;
    int32_t* dx = to_out ? ox : tx;
    int32_t* dy = to_out ? oy : ty;
    int32_t* dz = to_out ? oz : tz;
    const long long d = 1LL << (r % rounds);
    for (long long i = first; i < total; i += stride) {
      Pt a = pt_load_cg(sx, sy, sz, i);
      Pt q = (i % B) + d < B ? pt_load_cg(sx, sy, sz, i + d) : ident;
      pt_store(dx, dy, dz, i, group_add<PROJ>(a, q, b3, M));
    }
    grid.sync();
    sx = dx;
    sy = dy;
    sz = dz;
  }
  if (n_rounds == 0)  // B == 1: the double suffix of one bucket is itself
    for (long long i = first; i < total; i += stride)
      pt_store(ox, oy, oz, i, pt_load_cg(x, y, z, i));
}

template <bool PROJ>
static int launch_weighted_suffix(const int32_t* x, const int32_t* y,
                                  const int32_t* z, int32_t* ox, int32_t* oy,
                                  int32_t* oz, int32_t* tx, int32_t* ty,
                                  int32_t* tz, long long total, long long B,
                                  int rounds, int b3, Modulus M,
                                  cudaStream_t s) {
  const int threads = 128;
  auto kern = weighted_suffix_kernel<PROJ>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  long long want = (total + threads - 1) / threads;
  long long resident = (long long)per_sm * sms;
  unsigned blocks = (unsigned)(want < resident ? want : resident);
  void* args[] = {&x, &y, &z, &ox, &oy, &oz, &tx, &ty, &tz,
                  &total, &B, &rounds, &b3, &M};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks),
                                  dim3(threads), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  ZK_CHECK_RETURN();
}

extern "C" int zk_weighted_suffix(const void* x, const void* y, const void* z,
                                  void* ox, void* oy, void* oz, void* tx,
                                  void* ty, void* tz, long long total,
                                  long long B, int rounds, int proj, int b3,
                                  const void* mod, void* stream) {
  if (total <= 0) return 0;
  if (B <= 0 || total % B) return (int)cudaErrorInvalidValue;
  Modulus M = modulus_from_words(static_cast<const uint32_t*>(mod));
  auto X = static_cast<const int32_t*>(x), Y = static_cast<const int32_t*>(y),
       Z = static_cast<const int32_t*>(z);
  auto OX = static_cast<int32_t*>(ox), OY = static_cast<int32_t*>(oy),
       OZ = static_cast<int32_t*>(oz), TX = static_cast<int32_t*>(tx),
       TY = static_cast<int32_t*>(ty), TZ = static_cast<int32_t*>(tz);
  cudaStream_t s = (cudaStream_t)stream;
  if (proj)
    return launch_weighted_suffix<true>(X, Y, Z, OX, OY, OZ, TX, TY, TZ,
                                        total, B, rounds, b3, M, s);
  return launch_weighted_suffix<false>(X, Y, Z, OX, OY, OZ, TX, TY, TZ, total,
                                       B, rounds, b3, M, s);
}

constexpr int LADDER_LANES = 128;

template <bool PROJ>
__global__ void __launch_bounds__(LADDER_LANES)
ladder_tree_kernel(const int32_t* __restrict__ x,
                   const int32_t* __restrict__ y,
                   const int32_t* __restrict__ z, int32_t* __restrict__ ox,
                   int32_t* __restrict__ oy, int32_t* __restrict__ oz, int c,
                   int W, int b3, Modulus M) {
  __shared__ Fe sx[LADDER_LANES], sy[LADDER_LANES], sz[LADDER_LANES];
  const int lane = threadIdx.x;
  long long o = (long long)lane * 16;
  Pt a{fe_load(x + o), fe_load(y + o), fe_load(z + o)};
  // the ladder: step i doubles the lanes with lane * c > i
  const int steps = c * (W - 1);
  const int mine = lane * c < steps ? lane * c : steps;
  for (int i = 0; i < mine; ++i) a = PROJ ? pdbl(a, b3, M) : jdbl(a, M);
  // the suffix tree: a[lane] += a[lane + d], (0 : 1 : 0) past the end
  const Pt ident{fe_zero(), fe_one(M), fe_zero()};
  for (int r = 0; r < 7; ++r) {
    const int d = 1 << r;
    sx[lane] = a.x;
    sy[lane] = a.y;
    sz[lane] = a.z;
    __syncthreads();
    Pt q = lane + d < LADDER_LANES ? Pt{sx[lane + d], sy[lane + d],
                                        sz[lane + d]}
                                   : ident;
    __syncthreads();
    a = group_add<PROJ>(a, q, b3, M);
  }
  fe_store(ox + o, a.x);
  fe_store(oy + o, a.y);
  fe_store(oz + o, a.z);
}

extern "C" int zk_ladder_tree(const void* x, const void* y, const void* z,
                              void* ox, void* oy, void* oz, int c, int W,
                              int proj, int b3, const void* mod,
                              void* stream) {
  if (c < 0 || W < 1 || W > LADDER_LANES) return (int)cudaErrorInvalidValue;
  Modulus M = modulus_from_words(static_cast<const uint32_t*>(mod));
  cudaStream_t s = (cudaStream_t)stream;
  auto X = static_cast<const int32_t*>(x), Y = static_cast<const int32_t*>(y),
       Z = static_cast<const int32_t*>(z);
  auto OX = static_cast<int32_t*>(ox), OY = static_cast<int32_t*>(oy),
       OZ = static_cast<int32_t*>(oz);
  if (proj)
    ladder_tree_kernel<true><<<1, LADDER_LANES, 0, s>>>(X, Y, Z, OX, OY, OZ, c, W, b3, M);
  else
    ladder_tree_kernel<false><<<1, LADDER_LANES, 0, s>>>(X, Y, Z, OX, OY, OZ, c, W, b3, M);
  ZK_CHECK_RETURN();
}
