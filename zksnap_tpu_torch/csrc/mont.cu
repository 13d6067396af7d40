// Field kernels K1 (Montgomery multiply) and K2 (modular add / sub).
//
// Replaces zksnap_tpu/fields/pallas_mont.py: `_mont_mul_fn` (K1, body
// `_kernel_body`) and `_addsub_fn` (K2, body `_addsub_kernel_body`).  The
// TPU kernels work on limb-major [16, B] tiles padded to 1024-lane blocks;
// these take the port's [n, 16] int32 rows, one element a thread, the
// ragged edge masked.
//
// Bounds on the H100: both are memory bound (192 bytes an element: two
// rows read, one written); K1's 128 32x32->64 multiply-adds an element sit
// below that line only when nothing else goes to memory.  So K1's product
// is field_inline.cuh's CIOS, inlined, with the Modulus read from the
// kernel's parameter bank: no stack frame (the out-of-line fe_mul moved
// each product's operands and a copy of the Modulus through local
// memory).  Two elements a thread, their products interleaved, ran slower
// on the H100 at every shape of the prover's paths.
//
// Each operand is read where it lies: row i of the call is at
//   base + ((i / inner) * s_outer + (i % inner) * s_inner) rows,
// which covers a contiguous operand (inner = n, s_inner = 1), one element
// for every row (both strides 0), a twiddle slice broadcast over blocks
// (s_outer = 0) and the odd half of each NTT block (s_outer = 2m).  i /
// inner is a multiply-high by a magic number the host computes for the
// invariant divisor (i < 2^31).  The output is a fresh contiguous [n, 16].
// The host picks the block size and count (pallas_mont.launch_geometry:
// small n in small blocks, so that a k=13 call reaches every SM).
// Left for later: fusing chains of field ops so intermediates stay in
// registers.  Tensor cores (wgmma) do not apply: they have no 32-bit
// integer products.

#include "field_inline.cuh"

// An operand's rows (see above); offsets below 2^31 rows.
struct Rows {
  const int32_t* base;
  uint32_t inner, magic, shift, s_outer, s_inner;
};

__device__ __forceinline__ Fe load_row(const Rows& o, uint32_t i) {
  const uint32_t q = (__umulhi(i, o.magic) + i) >> o.shift;
  const uint32_t off = q * o.s_outer + (i - q * o.inner) * o.s_inner;
  const int4* v = reinterpret_cast<const int4*>(o.base) + (size_t)off * 4;
  Fe r;
#pragma unroll
  for (int q4 = 0; q4 < 4; ++q4) {
    const int4 t = __ldg(v + q4);
    r.w[2 * q4] = (uint32_t)t.x | ((uint32_t)t.y << 16);
    r.w[2 * q4 + 1] = (uint32_t)t.z | ((uint32_t)t.w << 16);
  }
  return r;
}

__global__ void __launch_bounds__(256)
mont_mul_kernel(Rows a, Rows b, int32_t* __restrict__ out, uint32_t n,
                Modulus M) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe x[1] = {load_row(a, i)}, y[1] = {load_row(b, i)};
  Fe r[1];
  fe_mul_n<1>(r, x, y, M);
  fe_store(out + (size_t)i * 16, r[0]);
}

__global__ void __launch_bounds__(256)
mont_addsub_kernel(Rows a, Rows b, int32_t* __restrict__ out, uint32_t n,
                   int mode, Modulus M) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe x = load_row(a, i), y = load_row(b, i);
  fe_store(out + (size_t)i * 16, mode == 0 ? fe_add(x, y, M)
                                           : fe_sub(x, y, M));
}

static Rows rows_of(const void* base, unsigned inner, unsigned magic,
                    unsigned shift, unsigned s_outer, unsigned s_inner) {
  return Rows{static_cast<const int32_t*>(base), inner, magic, shift,
              s_outer, s_inner};
}

#define ZK_ROWS_ARGS(x)                                                   \
  const void *x, unsigned x##_inner, unsigned x##_magic,                  \
      unsigned x##_shift, unsigned x##_s_outer, unsigned x##_s_inner
#define ZK_ROWS(x) \
  rows_of(x, x##_inner, x##_magic, x##_shift, x##_s_outer, x##_s_inner)

extern "C" int zk_mont_mul(ZK_ROWS_ARGS(a), ZK_ROWS_ARGS(b), void* out,
                           unsigned n, int threads, int blocks,
                           const void* mod, void* stream) {
  if (n == 0) return 0;
  const Modulus M = modulus_from_words(static_cast<const uint32_t*>(mod));
  mont_mul_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      ZK_ROWS(a), ZK_ROWS(b), static_cast<int32_t*>(out), n, M);
  ZK_CHECK_RETURN();
}

extern "C" int zk_mont_addsub(ZK_ROWS_ARGS(a), ZK_ROWS_ARGS(b), void* out,
                              unsigned n, int mode, int threads, int blocks,
                              const void* mod, void* stream) {
  if (n == 0) return 0;
  const Modulus M = modulus_from_words(static_cast<const uint32_t*>(mod));
  mont_addsub_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      ZK_ROWS(a), ZK_ROWS(b), static_cast<int32_t*>(out), n, mode, M);
  ZK_CHECK_RETURN();
}
