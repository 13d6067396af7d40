// The fused Pippenger reduction: kernels K5 (weighted suffix) and K6
// (ladder and tree).
//
// K5 replaces zksnap_tpu/curves/fused.py `_weighted_suffix_call` (reached
// through `weighted_suffix_fused`).  Input: the window-major bucket sums
// S[w*B + b], B buckets to a window.  Output: the double suffix
// s2[w*B + b] = sum_{b' >= b} (b' - b + 1) * S[w, b'], the weighted bucket
// sum of window w at b = 0 (signed digits) or b = 1 (unsigned): two
// window-local single suffix sums, s1 from S and s2 from s1.  The TPU
// kernel runs 2*log2(B) Hillis-Steele rounds of rolls inside one VMEM
// block; kept as they were, in one cooperative launch with a grid.sync()
// between rounds, they cost 30 additions a bucket at k = 21 where the
// function needs 2, and 30 grid-wide barriers.
//   Bound on the H100: the IMAD pipe.  The function's work is a
// sequential double suffix, 2 complete additions a bucket: 2^20 padd at
// k = 21 (W = 16, B = 2^15), above its 201 MB at HBM rate.
//   This form is work-efficient: each suffix sum is chunked, C
// consecutive buckets a chunk (the wrapper picks C so that about 2^15
// threads fill the card: C = 16 at k = 21; C <= B):
//   (a) suffix_chunk_total_kernel: a thread sums its chunk, C - 1
//       additions;
//   (b) suffix_carry_kernel, twice: the exclusive suffix of the window's
//       chunk totals (the carries), in groups of at most 64 totals: a
//       block of G <= 32 threads a group, each thread sums L = group / G
//       consecutive totals, a Hillis-Steele suffix over the G sums in
//       shared memory, then each thread reruns its L totals from the sum
//       above it and the block writes the group's total; the second
//       launch does the same over each window's group totals;
//   (c) suffix_chunk_kernel: a thread adds its group's carry to its own,
//       reruns its chunk's sequential suffix seeded by the sum, and writes
//       it; in the first sum it also adds up the chunk of s1 it writes,
//       C - 1 additions, which are (a) for the second sum.
// Groups and threads keep every carry pass at a few dependent additions
// (13 at k = 21) on hundreds of blocks.
// Seven ordinary launches on the caller's stream: (a), (b) twice, (c)
// with the totals, (b) twice, (c).  Additions a bucket: (C - 1)/C in (a),
// 1 + (C - 1)/C in the first (c), 1 in the second: 4 - 2/C, 3.875 at
// C = 16, plus O(chunks) for the carries (a group carry added to each
// chunk's, the groups' scans), and no grid-wide barrier.  The order of
// the additions is not the TPU kernel's, so the projective
// representatives differ from the JAX kernel's (the points are the
// same); the plain version in curves/fused.py follows this order
// exactly.  The RCB additions are point_inline.cuh's inlined padd; the
// Jacobian branch (b3 == 0) keeps point.cuh's out-of-line add.
//
// K6 replaces zksnap_tpu/curves/fused.py `_ladder_tree_call` (reached
// through `ladder_tree_fused`): T = sum_w 2^(c*w) S_w over 128 lanes (lane
// w < W holds window w's weighted sum, the rest (0 : 1 : 0)).  One block:
// the masked doubling ladder (lane w doubles while i < c*w, for
// i < c*(W-1)) runs in registers; the 7 rounds of the suffix tree pass
// neighbours through shared memory with a barrier between rounds; lanes
// past the end read (0 : 1 : 0).  Operand order is the JAX kernel's, so
// the result is bit-exact against the plain version.
//   Bound on the H100: latency.  One SM runs c*(W-1) dependent doublings
// (240 at k = 21, 248 at K = 7) and 7 dependent additions.  The function
// itself (Horner's combine: c*(W-1) doublings and W-1 additions) is
// microseconds of the card's rate; the chain of dependent doublings is
// what the kernel waits on, and each link of it is a formula's stages of
// products.  So the RCB kernel gives a lane a group of LADDER_GROUP = 4
// threads: the four products of a doubling's stage, one a thread, and
// the six of an addition's, two a thread, are exchanged by shuffles
// (point_inline.cuh's fe_mul_group), and a doubling waits on about two
// product latencies, not eight.  The inlined formulas keep the stack
// empty; both loops stay rolled for the instruction cache.  The kernel
// reads the W window sums only; lanes past W hold (0 : 1 : 0), a fixed
// point of the RCB doubling and addition, so the warps that hold only
// such lanes skip their work: at W = 16 two warps of sixteen compute.  The Jacobian branch (b3 == 0, off the
// prover's path) keeps one thread a lane and point.cuh's calls.
//
// Both take RCB projective points for b3 != 0 (padd / pdbl) and Jacobian
// ones for b3 == 0 (add / dbl), as the TPU kernels do.  Lanes and carries
// that hold no point hold (0 : 1 : 0), the identity of both.

#include "point_inline.cuh"

__device__ __forceinline__ Pt pt_load(const int32_t* x, const int32_t* y,
                                      const int32_t* z, long long i) {
  long long o = i * 16;
  return Pt{fe_load(x + o), fe_load(y + o), fe_load(z + o)};
}

__device__ __forceinline__ void pt_store(int32_t* x, int32_t* y, int32_t* z,
                                         long long i, const Pt& p) {
  long long o = i * 16;
  fe_store(x + o, p.x);
  fe_store(y + o, p.y);
  fe_store(z + o, p.z);
}

// K5's and K6's additions: inlined for RCB (shared by a group of T
// threads), point.cuh's for Jacobian (T = 1).
template <bool PROJ, int T = 1>
__device__ __forceinline__ Pt group_add(const Pt& a, const Pt& b, int b3,
                                        const Modulus& M) {
  if constexpr (PROJ)
    return padd_inl<T>(a, b, b3, M);
  else
    return jadd<false>(a, b, M);
}

__device__ __forceinline__ Pt pt_ident(const Modulus& M) {
  return Pt{fe_zero(), fe_one(M), fe_zero()};
}

// A point's three rows: the next one's loads stay in flight, unpacked,
// while the current addition computes.
struct PtRaw {
  int4 v[3][4];
};

__device__ __forceinline__ PtRaw pt_fetch(const int32_t* x, const int32_t* y,
                                          const int32_t* z, long long i) {
  const int4* s[3] = {reinterpret_cast<const int4*>(x + i * 16),
                      reinterpret_cast<const int4*>(y + i * 16),
                      reinterpret_cast<const int4*>(z + i * 16)};
  PtRaw r;
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int q = 0; q < 4; ++q) r.v[c][q] = s[c][q];
  return r;
}

__device__ __forceinline__ Pt pt_unpack(const PtRaw& r) {
  Fe f[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      f[c].w[2 * q] = (uint32_t)r.v[c][q].x | ((uint32_t)r.v[c][q].y << 16);
      f[c].w[2 * q + 1] =
          (uint32_t)r.v[c][q].z | ((uint32_t)r.v[c][q].w << 16);
    }
  return Pt{f[0], f[1], f[2]};
}

constexpr int SUFFIX_THREADS = 128;  // (a) and (c)
constexpr int CARRY_THREADS = 32;    // (b): the most a carry block takes

// (a): t[j] = S[jC + C-1] + S[jC + C-2] + ... + S[jC], added in that order.
template <bool PROJ>
__global__ void __launch_bounds__(SUFFIX_THREADS, 2)
suffix_chunk_total_kernel(const int32_t* __restrict__ x,
                          const int32_t* __restrict__ y,
                          const int32_t* __restrict__ z,
                          int32_t* __restrict__ tx, int32_t* __restrict__ ty,
                          int32_t* __restrict__ tz, long long chunks, int C,
                          int b3, Modulus M) {
  const long long j = (long long)blockIdx.x * SUFFIX_THREADS + threadIdx.x;
  if (j >= chunks) return;
  const long long lo = j * C;
  PtRaw next = pt_fetch(x, y, z, lo + C - 1);
  Pt u = pt_unpack(next);
  if (C > 1) next = pt_fetch(x, y, z, lo + C - 2);
  for (int i = C - 2; i >= 0; --i) {
    Pt p = pt_unpack(next);
    if (i > 0) next = pt_fetch(x, y, z, lo + i - 1);
    u = group_add<PROJ>(u, p, b3, M);
  }
  pt_store(tx, ty, tz, j, u);
}

// (b): for each group of `per` consecutive totals (a block of G threads
// each), e[j] = the sum of the group's t[j'] for j' > j ((0 : 1 : 0) for
// the group's last), and, where gx is given, the group's sum.  Thread g
// sums its L = per / G totals from the top down, a Hillis-Steele suffix
// runs over the G sums, then the thread reruns its totals from the sum
// of the threads above it.
template <bool PROJ>
__global__ void __launch_bounds__(CARRY_THREADS)
suffix_carry_kernel(const int32_t* __restrict__ tx,
                    const int32_t* __restrict__ ty,
                    const int32_t* __restrict__ tz, int32_t* __restrict__ ex,
                    int32_t* __restrict__ ey, int32_t* __restrict__ ez,
                    int32_t* __restrict__ gx, int32_t* __restrict__ gy,
                    int32_t* __restrict__ gz, int per, int b3, Modulus M) {
  __shared__ Fe sx[CARRY_THREADS], sy[CARRY_THREADS], sz[CARRY_THREADS];
  const int G = blockDim.x, g = threadIdx.x;
  const int L = per / G;
  const long long lo = (long long)blockIdx.x * per + (long long)g * L;
  Pt u = pt_load(tx, ty, tz, lo + L - 1);
  for (int i = L - 2; i >= 0; --i)
    u = group_add<PROJ>(u, pt_load(tx, ty, tz, lo + i), b3, M);
  const Pt ident = pt_ident(M);
  for (int d = 1; d < G; d <<= 1) {
    sx[g] = u.x;
    sy[g] = u.y;
    sz[g] = u.z;
    __syncthreads();
    Pt q = g + d < G ? Pt{sx[g + d], sy[g + d], sz[g + d]} : ident;
    __syncthreads();
    u = group_add<PROJ>(u, q, b3, M);
  }
  sx[g] = u.x;
  sy[g] = u.y;
  sz[g] = u.z;
  if (gx && g == 0) pt_store(gx, gy, gz, blockIdx.x, u);
  __syncthreads();
  Pt run = g + 1 < G ? Pt{sx[g + 1], sy[g + 1], sz[g + 1]} : ident;
  for (int i = L - 1;; --i) {
    pt_store(ex, ey, ez, lo + i, run);
    if (i == 0) break;
    run = group_add<PROJ>(run, pt_load(tx, ty, tz, lo + i), b3, M);
  }
}

// (c): with e'[j] = g[j / group] + e[j] (e[j] alone where gx is null),
// out[jC + i] = e'[j] + S[jC + C-1] + ... + S[jC + i], added in that
// order from i = C-1 down; with TOTAL, t[j] = out[jC + C-1] + ... +
// out[jC], added in that order.  Without TOTAL the next bucket's loads
// are in flight during an addition; with it the two chains of additions
// leave no registers for them.
template <bool PROJ, bool TOTAL>
__global__ void __launch_bounds__(SUFFIX_THREADS, 2)
suffix_chunk_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ y,
                    const int32_t* __restrict__ z,
                    const int32_t* __restrict__ ex,
                    const int32_t* __restrict__ ey,
                    const int32_t* __restrict__ ez,
                    const int32_t* __restrict__ gx,
                    const int32_t* __restrict__ gy,
                    const int32_t* __restrict__ gz, int group,
                    int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                    int32_t* __restrict__ oz, int32_t* __restrict__ tx,
                    int32_t* __restrict__ ty, int32_t* __restrict__ tz,
                    long long chunks, int C, int b3, Modulus M) {
  const long long j = (long long)blockIdx.x * SUFFIX_THREADS + threadIdx.x;
  if (j >= chunks) return;
  const long long lo = j * C;
  PtRaw next;
  if constexpr (!TOTAL) next = pt_fetch(x, y, z, lo + C - 1);
  Pt run = pt_load(ex, ey, ez, j);
  if (gx) run = group_add<PROJ>(pt_load(gx, gy, gz, j / group), run, b3, M);
  Pt tot;
  for (int i = C - 1; i >= 0; --i) {
    Pt p;
    if constexpr (TOTAL) {
      p = pt_load(x, y, z, lo + i);
    } else {
      p = pt_unpack(next);
      if (i > 0) next = pt_fetch(x, y, z, lo + i - 1);
    }
    run = group_add<PROJ>(run, p, b3, M);
    pt_store(ox, oy, oz, lo + i, run);
    if constexpr (TOTAL)
      tot = i == C - 1 ? run : group_add<PROJ>(tot, run, b3, M);
  }
  if constexpr (TOTAL) pt_store(tx, ty, tz, j, tot);
}

// A run of three coordinate arrays of `rows` rows each, carved from the
// scratch buffer.
struct Rows3 {
  int32_t* c[3];
};

static Rows3 carve(int32_t*& at, long long rows) {
  Rows3 r;
  for (int c = 0; c < 3; ++c, at += rows * 16) r.c[c] = at;
  return r;
}

template <bool PROJ>
static int launch_weighted_suffix(const int32_t* x, const int32_t* y,
                                  const int32_t* z, int32_t* ox, int32_t* oy,
                                  int32_t* oz, int32_t* scratch,
                                  long long total, long long B, int C,
                                  int group, int threads, int b3, Modulus M,
                                  cudaStream_t s) {
  const long long chunks = total / C, groups = chunks / group;
  const int per_window = (int)(B / C / group);  // groups a window
  const unsigned windows = (unsigned)(total / B);
  const unsigned blocks =
      (unsigned)((chunks + SUFFIX_THREADS - 1) / SUFFIX_THREADS);
  const int g1 = group < threads ? group : threads;
  const int g2 = per_window < threads ? per_window : threads;
  int32_t* at = scratch;
  const Rows3 s1 = carve(at, total), t = carve(at, chunks),
              e = carve(at, chunks), tg = carve(at, groups),
              eg = carve(at, groups);
  // the group carries, where a window has more than one group
  int32_t* const* egp = per_window > 1 ? eg.c : nullptr;
  for (int pass = 0; pass < 2; ++pass) {
    const int32_t* sx = pass ? s1.c[0] : x;
    const int32_t* sy = pass ? s1.c[1] : y;
    const int32_t* sz = pass ? s1.c[2] : z;
    if (pass == 0)
      suffix_chunk_total_kernel<PROJ><<<blocks, SUFFIX_THREADS, 0, s>>>(
          sx, sy, sz, t.c[0], t.c[1], t.c[2], chunks, C, b3, M);
    suffix_carry_kernel<PROJ><<<(unsigned)groups, g1, 0, s>>>(
        t.c[0], t.c[1], t.c[2], e.c[0], e.c[1], e.c[2], tg.c[0], tg.c[1],
        tg.c[2], group, b3, M);
    if (egp)
      suffix_carry_kernel<PROJ><<<windows, g2, 0, s>>>(
          tg.c[0], tg.c[1], tg.c[2], eg.c[0], eg.c[1], eg.c[2], nullptr,
          nullptr, nullptr, per_window, b3, M);
    const int32_t* gx = egp ? egp[0] : nullptr;
    const int32_t* gy = egp ? egp[1] : nullptr;
    const int32_t* gz = egp ? egp[2] : nullptr;
    if (pass == 0)
      suffix_chunk_kernel<PROJ, true><<<blocks, SUFFIX_THREADS, 0, s>>>(
          sx, sy, sz, e.c[0], e.c[1], e.c[2], gx, gy, gz, group, s1.c[0],
          s1.c[1], s1.c[2], t.c[0], t.c[1], t.c[2], chunks, C, b3, M);
    else
      suffix_chunk_kernel<PROJ, false><<<blocks, SUFFIX_THREADS, 0, s>>>(
          sx, sy, sz, e.c[0], e.c[1], e.c[2], gx, gy, gz, group, ox, oy,
          oz, nullptr, nullptr, nullptr, chunks, C, b3, M);
  }
  ZK_CHECK_RETURN();
}

extern "C" int zk_weighted_suffix(const void* x, const void* y, const void* z,
                                  void* ox, void* oy, void* oz, void* scratch,
                                  long long total, long long B, int C,
                                  int group, int threads, int proj, int b3,
                                  const void* mod, void* stream) {
  if (total <= 0) return 0;
  // whole windows of whole groups of whole chunks; a carry block's
  // threads split its totals evenly
  if (B < 1 || C < 1 || group < 1 || threads < 1 ||
      threads > CARRY_THREADS || total % B || B % C || (B / C) % group)
    return (int)cudaErrorInvalidValue;
  const long long per_window = B / C / group;
  if ((group > threads && group % threads) ||
      (per_window > threads && per_window % threads))
    return (int)cudaErrorInvalidValue;
  Modulus M = modulus_from_words(static_cast<const uint32_t*>(mod));
  auto X = static_cast<const int32_t*>(x), Y = static_cast<const int32_t*>(y),
       Z = static_cast<const int32_t*>(z);
  auto OX = static_cast<int32_t*>(ox), OY = static_cast<int32_t*>(oy),
       OZ = static_cast<int32_t*>(oz);
  auto S = static_cast<int32_t*>(scratch);
  cudaStream_t s = (cudaStream_t)stream;
  if (proj)
    return launch_weighted_suffix<true>(X, Y, Z, OX, OY, OZ, S, total, B, C,
                                        group, threads, b3, M, s);
  return launch_weighted_suffix<false>(X, Y, Z, OX, OY, OZ, S, total, B, C,
                                       group, threads, b3, M, s);
}

constexpr int LADDER_LANES = 128;
constexpr int LADDER_GROUP = 4;  // threads a lane of the RCB kernel

template <bool PROJ, int T>
__global__ void __launch_bounds__(LADDER_LANES * T)
ladder_tree_kernel(const int32_t* __restrict__ x,
                   const int32_t* __restrict__ y,
                   const int32_t* __restrict__ z, int32_t* __restrict__ ox,
                   int32_t* __restrict__ oy, int32_t* __restrict__ oz, int c,
                   int W, int b3, Modulus M) {
  __shared__ Fe sx[LADDER_LANES], sy[LADDER_LANES], sz[LADDER_LANES];
  const int lane = threadIdx.x / T;
  const Pt ident = pt_ident(M);
  Pt a = lane < W ? pt_load(x, y, z, lane) : ident;
  // the ladder: step i doubles the lanes with lane * c > i.  An RCB lane
  // past W holds (0 : 1 : 0), which Algorithm 9 maps to itself bit for
  // bit, so it skips its doublings; a warp runs as many steps as its
  // longest lane, the others keeping their point
  const int steps = c * (W - 1);
  int mine = lane * c < steps ? lane * c : steps;
  if (PROJ && lane >= W) mine = 0;
  const int warp_steps = (int)__reduce_max_sync(0xffffffffu, (unsigned)mine);
#pragma unroll 1
  for (int i = 0; i < warp_steps; ++i) {
    Pt d;
    if constexpr (PROJ)
      d = pdbl_inl<T>(a, b3, M);
    else
      d = jdbl(a, M);
    a = pt_select(i < mine, d, a);
  }
  // the suffix tree: a[lane] += a[lane + d], (0 : 1 : 0) past the end.  In
  // RCB (0 : 1 : 0) + (0 : 1 : 0) is (0 : 1 : 0) bit for bit, so a warp
  // whose lanes are all past W keeps its points
  const bool busy = !PROJ || (int)(threadIdx.x & ~31u) / T < W;
#pragma unroll 1
  for (int r = 0; r < 7; ++r) {
    const int d = 1 << r;
    if (threadIdx.x % T == 0) {
      sx[lane] = a.x;
      sy[lane] = a.y;
      sz[lane] = a.z;
    }
    __syncthreads();
    Pt q = lane + d < LADDER_LANES ? Pt{sx[lane + d], sy[lane + d],
                                        sz[lane + d]}
                                   : ident;
    __syncthreads();
    if (busy) a = group_add<PROJ, T>(a, q, b3, M);
  }
  pt_store_share<T>(ox, oy, oz, lane, a);
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
    ladder_tree_kernel<true, LADDER_GROUP>
        <<<1, LADDER_LANES * LADDER_GROUP, 0, s>>>(X, Y, Z, OX, OY, OZ, c, W,
                                                  b3, M);
  else
    ladder_tree_kernel<false, 1>
        <<<1, LADDER_LANES, 0, s>>>(X, Y, Z, OX, OY, OZ, c, W, b3, M);
  ZK_CHECK_RETURN();
}
