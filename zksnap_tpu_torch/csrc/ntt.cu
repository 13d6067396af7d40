// The single-card NTT: `poly/ntt.py` `_ntt_impl` on a CUDA tensor.
//
// Replaces no Pallas kernel: the JAX package's NTT (zksnap_tpu/poly/
// ntt.py) is jnp code, radix-2 stages over the whole array.  It replaces
// `_ntt_impl`'s PyTorch body on the card, which copied a bit-reversal
// index from the host, gathered the array through it, and made a K1
// launch, two K2 launches and a `cat` of the whole array for each of its
// k stages.
//
// Bound on the H100: the IMAD pipe.  A transform of n = 2^k is k n/2
// Montgomery products (field_inline.cuh's CIOS: 128 IMAD.WIDE, two
// IMAD-pipe slots each, and 8 IMAD, 264 slots a product), about 0.35 ms
// at 2^21; its bytes, the array read and written once a pass, about
// 0.16 ms.
//
// Design: the four-step split applied pass by pass.  n = 2^k is cut into
// passes of at most 11 bits (`poly/ntt.py` `ntt_plan`: 21 = 11 + 10).
// Digit j of the input index (from the top, width b_j) becomes digit j of
// the output index (from the bottom); with W_j = 2^(b_0 + ... + b_(j-1)):
//   * pass 0 reads the caller's rows: for each value r of the input's
//     low k - b_0 bits (a column), the 2^b_0 rows r + t 2^(k - b_0).  It
//     writes output digit t at weight 1 and moves every other digit j of
//     r to weight W_j, so every later pass works in place on `out`;
//   * pass p > 0 reads, for each setting of the other digits, the 2^b_p
//     rows that differ in the bits [log W_p, log W_p + b_p) and writes
//     them back to the same rows; the last pass leaves natural order;
//   * between passes, output digit t of pass p is multiplied by
//     w^(W_p t r), r the value of the input digits the later passes
//     still transform (four_step_ntt's twiddle, w the n-th root).
// A block holds C sub-transforms of 2^b elements, C 2^b <= 2^11 (64 KB of
// shared memory as 8 32-bit words an element, three blocks an SM): it
// loads them to bit-reversed places, runs all b radix-2 stages in shared
// memory (the first without a product: its twiddle is 1), then multiplies
// and stores.  Where a column's rows are strided the C columns of a block
// are adjacent rows, so a warp's loads come in runs of C rows.  No index
// array exists anywhere, and there is no gather pass and no `cat`.
//
// Twiddles: one packed table (8 words a row) per twiddle table and pass
// widths (`poly/ntt.py` `_tables`): the 2^(B-1) stage twiddles of the
// 2^B-th root, B the widest pass (a stage s of a narrower pass reads
// every 2^(B-1-s)-th row), then w^lo for lo < 2^split and w^(hi 2^split)
// for hi < 2^(k - split); an inter-pass twiddle w^e is the product of
// rows e mod 2^split and e >> split of the last two.
//
// Folded into the launches: the first pass may multiply input row i by
// pre[i] (the coset powers of `coset_evals`), the last may multiply
// every output by one constant (`evals_to_coeffs`' n^-1).  Input rows are
// 16 limbs as int32 or the int16 at-rest form, read in place; the
// intermediate passes keep each element packed in the first 32 bytes of
// its row of `out`; the last writes 16 int32 limbs, fully reduced.

#include <atomic>

#include "field_inline.cuh"

constexpr int NTT_MAX_PASSES = 8;
constexpr int NTT_THREADS = 256;
constexpr int NTT_TILE_LOG = 11;  // elements a block: 2^11 x 32 B = 64 KB
constexpr int NTT_MAX_DEVICES = 64;

struct NttPass {
  const void* in;        // pass 0: the caller's [batch, n, 16] rows
  int32_t* out;          // [batch, n, 16] int32
  const uint32_t* tab;   // packed twiddle rows: stage | lo | hi
  const int32_t* pre;    // [n, 16] or null (pass 0)
  const int32_t* post;   // [16] or null (last pass)
  uint32_t batch;
  int k, passes, p;
  int pb, plo;             // this pass's b_p and lo_p
  int lo[NTT_MAX_PASSES];  // digit j: position bits [lo_j, lo_j + b_j)
  int b[NTT_MAX_PASSES];
  int cols_log;          // log2 columns a block
  int stage_log;         // log2 of the stage table's root order
  int split;             // the lo table has 2^split rows
  uint32_t lo_row, hi_row;
  Modulus M;
};

__device__ __forceinline__ Fe ntt_mul(const Fe& a, const Fe& b,
                                      const Modulus& M) {
  const Fe x[1] = {a}, y[1] = {b};
  Fe r[1];
  fe_mul_n<1>(r, x, y, M);
  return r[0];
}

// 8 packed words at p (two 16-byte loads): an int16 row, a table row or
// an intermediate element.
__device__ __forceinline__ Fe load_words(const uint32_t* p) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
  const uint4 a = v[0], b = v[1];
  return Fe{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ Fe load_words_ro(const uint32_t* p) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
  const uint4 a = __ldg(v), b = __ldg(v + 1);
  return Fe{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void store_words(int32_t* p, const Fe& x) {
  uint4* v = reinterpret_cast<uint4*>(p);
  v[0] = make_uint4(x.w[0], x.w[1], x.w[2], x.w[3]);
  v[1] = make_uint4(x.w[4], x.w[5], x.w[6], x.w[7]);
}

// 16 int32 limbs at p, packed (mont.cu's load_row).
__device__ __forceinline__ Fe load_limbs(const int32_t* p) {
  const int4* v = reinterpret_cast<const int4*>(p);
  Fe r;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 t = __ldg(v + q);
    r.w[2 * q] = (uint32_t)t.x | ((uint32_t)t.y << 16);
    r.w[2 * q + 1] = (uint32_t)t.z | ((uint32_t)t.w << 16);
  }
  return r;
}

__device__ __forceinline__ uint32_t bit_rev(uint32_t t, int b) {
  return b ? __brev(t) >> (32 - b) : 0u;
}

// g with the b-bit value t inserted at bit lo.
__device__ __forceinline__ uint32_t insert_digit(uint32_t g, uint32_t t,
                                                 int lo, int b) {
  return (g & ((1u << lo) - 1)) | (t << lo) | ((g >> lo) << (lo + b));
}

// Pass 0's output place of input column r: each digit j >= 1, at bits
// [k - lo_j - b_j, k - lo_j) of the input index, moved to bit lo_j.  (The
// digit loops unroll over NTT_MAX_PASSES, so that the parameter arrays
// are read at fixed offsets of the parameter bank.)
__device__ __forceinline__ uint32_t spread_digits(const NttPass& a,
                                                  uint32_t r) {
  uint32_t pos = 0;
#pragma unroll
  for (int j = 1; j < NTT_MAX_PASSES; ++j)
    if (j < a.passes)
      pos |= ((r >> (a.k - a.lo[j] - a.b[j])) & ((1u << a.b[j]) - 1))
             << a.lo[j];
  return pos;
}

// The inverse for the digits after pass p: the input value r that the
// later passes still transform, read from a place.
__device__ __forceinline__ uint32_t gather_digits(const NttPass& a,
                                                  uint32_t pos) {
  uint32_t r = 0;
#pragma unroll
  for (int j = 1; j < NTT_MAX_PASSES; ++j)
    if (j > a.p && j < a.passes)
      r |= ((pos >> a.lo[j]) & ((1u << a.b[j]) - 1))
           << (a.k - a.lo[j] - a.b[j]);
  return r;
}

template <bool FIRST, bool LAST, bool IN16>
__global__ void __launch_bounds__(NTT_THREADS, 3)
ntt_pass_kernel(const NttPass a) {
  extern __shared__ uint4 sm[];
  const int b = a.pb, lo = a.plo;
  const uint32_t L = 1u << b, C = 1u << a.cols_log, E = C << b;
  uint4* const s0 = sm;      // words 0-3 of element e
  uint4* const s1 = sm + E;  // words 4-7
  const int gcols = a.k - b;  // log2 columns of one transform
  const uint32_t col0 = blockIdx.x << a.cols_log;
  const uint32_t ncols = a.batch << gcols;
  // Columns fastest where a column's rows are strided (adjacent columns
  // are adjacent rows), elements fastest where they are adjacent rows.
  const bool cols_fast_in = !FIRST || gcols > 0;
  const bool cols_fast_out = !FIRST;

  for (uint32_t e = threadIdx.x; e < E; e += blockDim.x) {
    const uint32_t c = cols_fast_in ? (e & (C - 1)) : (e >> b);
    const uint32_t t = cols_fast_in ? (e >> a.cols_log) : (e & (L - 1));
    const uint32_t gc = col0 + c;
    if (gc >= ncols) continue;
    const size_t base = (size_t)(gc >> gcols) << a.k;
    const uint32_t g = gc & ((1u << gcols) - 1);
    Fe x;
    if constexpr (FIRST) {
      const uint32_t i = (t << gcols) | g;
      if constexpr (IN16)
        x = load_words_ro(static_cast<const uint32_t*>(a.in) +
                          (base + i) * 8);
      else
        x = load_limbs(static_cast<const int32_t*>(a.in) + (base + i) * 16);
      if (a.pre) x = ntt_mul(x, load_limbs(a.pre + (size_t)i * 16), a.M);
    } else {
      const uint32_t pos = insert_digit(g, t, lo, b);
      x = load_words(reinterpret_cast<const uint32_t*>(a.out) +
                     (base + pos) * 16);
    }
    const uint32_t si = (c << b) | bit_rev(t, b);
    s0[si] = make_uint4(x.w[0], x.w[1], x.w[2], x.w[3]);
    s1[si] = make_uint4(x.w[4], x.w[5], x.w[6], x.w[7]);
  }
  __syncthreads();

  // radix-2 stages, decimation in time, natural order out
  for (int s = 0; s < b; ++s) {
    const uint32_t m = 1u << s;
    for (uint32_t q = threadIdx.x; q < (E >> 1); q += blockDim.x) {
      const uint32_t c = q >> (b - 1), jj = q & ((L >> 1) - 1);
      const uint32_t j = jj & (m - 1);
      const uint32_t iu = (c << b) | ((jj >> s) << (s + 1)) | j;
      const uint32_t iv = iu + m;
      const uint4 u0 = s0[iu], u1 = s1[iu], v0 = s0[iv], v1 = s1[iv];
      const Fe u{{u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w}};
      Fe v{{v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w}};
      if (s > 0)
        v = ntt_mul(v, load_words_ro(a.tab + ((size_t)j << (a.stage_log - 1 - s)) * 8),
                    a.M);
      const Fe x = fe_add(u, v, a.M), y = fe_sub(u, v, a.M);
      s0[iu] = make_uint4(x.w[0], x.w[1], x.w[2], x.w[3]);
      s1[iu] = make_uint4(x.w[4], x.w[5], x.w[6], x.w[7]);
      s0[iv] = make_uint4(y.w[0], y.w[1], y.w[2], y.w[3]);
      s1[iv] = make_uint4(y.w[4], y.w[5], y.w[6], y.w[7]);
    }
    __syncthreads();
  }

  Fe scale;
  if constexpr (LAST) {
    if (a.post) scale = load_limbs(a.post);
  }
  for (uint32_t e = threadIdx.x; e < E; e += blockDim.x) {
    const uint32_t c = cols_fast_out ? (e & (C - 1)) : (e >> b);
    const uint32_t t = cols_fast_out ? (e >> a.cols_log) : (e & (L - 1));
    const uint32_t gc = col0 + c;
    if (gc >= ncols) continue;
    const size_t base = (size_t)(gc >> gcols) << a.k;
    const uint32_t g = gc & ((1u << gcols) - 1);
    const uint32_t si = (c << b) | t;
    const uint4 x0 = s0[si], x1 = s1[si];
    Fe x{{x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w}};
    const uint32_t pos = FIRST ? (t | spread_digits(a, g))
                               : insert_digit(g, t, lo, b);
    int32_t* row = a.out + (base + pos) * 16;
    if constexpr (LAST) {
      if (a.post) x = ntt_mul(x, scale, a.M);
      fe_store(row, x);
    } else {
      const uint32_t r = FIRST ? g : gather_digits(a, pos);
      const uint32_t ex = (t * r) << lo;
      const Fe w = ntt_mul(
          load_words_ro(a.tab + (size_t)(a.lo_row + (ex & ((1u << a.split) - 1))) * 8),
          load_words_ro(a.tab + (size_t)(a.hi_row + (ex >> a.split)) * 8), a.M);
      store_words(row, ntt_mul(x, w, a.M));
    }
  }
}

template <bool FIRST, bool LAST, bool IN16>
static int launch_pass(const NttPass& a, unsigned blocks, int threads,
                       cudaStream_t stream) {
  auto kernel = ntt_pass_kernel<FIRST, LAST, IN16>;
  // once for each instantiation and device (a function's attributes
  // belong to the device's context): 64 KB of dynamic shared memory, and
  // the SM's carveout to shared memory, so that three blocks fit an SM
  static std::atomic<bool> set[NTT_MAX_DEVICES];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= NTT_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!set[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             32 << NTT_TILE_LOG);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    set[dev].store(true, std::memory_order_release);
  }
  const size_t smem = (size_t)32 << (a.cols_log + a.pb);
  kernel<<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// params: first, last, in16, batch, k, passes, p, cols_log, stage_log,
// split, lo_row, hi_row, blocks, threads, then the passes' widths.
extern "C" int zk_ntt_pass(const void* in, void* out, const void* tab,
                           const void* pre, const void* post,
                           const int* params, const void* mod,
                           void* stream) {
  NttPass a;
  const int first = params[0], last = params[1], in16 = params[2];
  a.in = in;
  a.out = static_cast<int32_t*>(out);
  a.tab = static_cast<const uint32_t*>(tab);
  a.pre = static_cast<const int32_t*>(pre);
  a.post = static_cast<const int32_t*>(post);
  a.batch = (uint32_t)params[3];
  a.k = params[4];
  a.passes = params[5];
  a.p = params[6];
  a.cols_log = params[7];
  a.stage_log = params[8];
  a.split = params[9];
  a.lo_row = (uint32_t)params[10];
  a.hi_row = (uint32_t)params[11];
  const unsigned blocks = (unsigned)params[12];
  const int threads = params[13];
  if (a.passes < 1 || a.passes > NTT_MAX_PASSES) return (int)cudaErrorInvalidValue;
  int acc = 0;
  for (int j = 0; j < a.passes; ++j) {
    a.b[j] = params[14 + j];
    a.lo[j] = acc;
    acc += a.b[j];
  }
  for (int j = a.passes; j < NTT_MAX_PASSES; ++j) a.b[j] = a.lo[j] = 0;
  if (acc != a.k || a.p < 0 || a.p >= a.passes ||
      a.cols_log + a.b[a.p] > NTT_TILE_LOG)
    return (int)cudaErrorInvalidValue;
  a.pb = a.b[a.p];
  a.plo = a.lo[a.p];
  a.M = modulus_from_words(static_cast<const uint32_t*>(mod));
  cudaStream_t s = (cudaStream_t)stream;
  if (first && last)
    return in16 ? launch_pass<true, true, true>(a, blocks, threads, s)
                : launch_pass<true, true, false>(a, blocks, threads, s);
  if (first)
    return in16 ? launch_pass<true, false, true>(a, blocks, threads, s)
                : launch_pass<true, false, false>(a, blocks, threads, s);
  return last ? launch_pass<false, true, false>(a, blocks, threads, s)
              : launch_pass<false, false, false>(a, blocks, threads, s);
}
