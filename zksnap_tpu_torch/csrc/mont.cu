// Field kernels K1 (Montgomery multiply) and K2 (modular add / sub).
//
// Replaces zksnap_tpu/fields/pallas_mont.py: `_mont_mul_fn` (K1, body
// `_kernel_body`) and `_addsub_fn` (K2, body `_addsub_kernel_body`).  The
// TPU kernels work on limb-major [16, B] tiles padded to 1024-lane blocks;
// these take the port's [n, 16] int32 rows directly, one thread per
// element, the ragged edge masked.
//
// Bounds on the H100: K1 is integer-ALU bound (64 32x32->64 multiply-adds
// for the product plus 64 for the reduction, per 192 bytes moved); K2 is
// memory bound (192 bytes per element for a few dozen integer ops).
// Left for later: carry chains in PTX (add.cc / madc), several elements
// per thread, and fusing chains of field ops so intermediates stay in
// registers.  Tensor cores (wgmma) do not apply: they have no 32-bit
// integer products.
//
// A broadcast operand (one element for all rows) is passed with stride 0.

#include "field.cuh"

__global__ void __launch_bounds__(256)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, long long n, long long sa,
                long long sb, Modulus M) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x = fe_load(a + i * sa * 16);
  Fe y = fe_load(b + i * sb * 16);
  fe_store(out + i * 16, fe_mul(x, y, M));
}

__global__ void __launch_bounds__(256)
mont_addsub_kernel(const int32_t* __restrict__ a,
                   const int32_t* __restrict__ b, int32_t* __restrict__ out,
                   long long n, long long sa, long long sb, int mode,
                   Modulus M) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x = fe_load(a + i * sa * 16);
  Fe y = fe_load(b + i * sb * 16);
  fe_store(out + i * 16, mode == 0 ? fe_add(x, y, M) : fe_sub(x, y, M));
}

extern "C" int zk_mont_mul(const void* a, const void* b, void* out,
                           long long n, long long sa, long long sb,
                           const void* mod, void* stream) {
  if (n <= 0) return 0;
  Modulus M = modulus_from_words(static_cast<const uint32_t*>(mod));
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  mont_mul_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), n, sa, sb, M);
  ZK_CHECK_RETURN();
}

extern "C" int zk_mont_addsub(const void* a, const void* b, void* out,
                              long long n, long long sa, long long sb,
                              int mode, const void* mod, void* stream) {
  if (n <= 0) return 0;
  Modulus M = modulus_from_words(static_cast<const uint32_t*>(mod));
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  mont_addsub_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), n, sa, sb, mode, M);
  ZK_CHECK_RETURN();
}
