// Kernel K9: the Montgomery-multiply variants of an experiment.
//
// Replaces scripts/exp_mul_variants.py: `run_kernel` (the pallas_call at
// :163) over `kernel_b` (variant B: stacked [16, W] rows, static loops),
// `kernel_c` (variant C: rolled fori_loop over a scratch ref) and
// `kernel_b_chain(n)` (n dependent products).  Variant A of the script is
// the production kernel K1, which the port runs as it is (csrc/mont.cu).
// The arithmetic is mont16.cuh's transcription of `mul_b`, modulus BN254 Fq
// as the script has it, operands limb-major [16, n] uint32.
//
// What bounds each variant on the H100, and what the design does about it:
//  - B: one thread an element reads its 16 limbs of a and b and writes 16
//    limbs, each row coalesced across the warp (192 bytes an element).  The
//    product and REDC are 512 IMADs of 16x16 bits and as many masks,
//    shifts and adds on 33 columns, all unrolled into registers, so it is
//    integer-ALU bound, about twice K1's 32-bit CIOS in instructions.
//  - C: the same with `#pragma unroll 1` on both 16-step loops: the
//    columns are indexed at run time and live in local memory (L1), the
//    TPU's dead end (Mosaic refused the dynamic sublane slices) made
//    legal; it is bound by local-memory traffic.
//  - chain: n dependent products on values held in registers, with one
//    load and one store: the compute-bound rate, free of HBM.
// The variants are kept as the experiment had them; none is tuned.

#include "mont16.cuh"

template <bool ROLLED>
__global__ void __launch_bounds__(256)
mul16_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
             uint32_t* __restrict__ out, long long n, int n_muls, Mod16 M) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t x[16], y[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    x[i] = a[i * n + e];
    y[i] = b[i * n + e];
  }
#pragma unroll 1
  for (int k = 0; k < n_muls; ++k) {
    uint32_t r[16];
    mont16_mul<ROLLED>(x, y, M, r);
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = r[i];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i * n + e] = x[i];
}

// rolled: 0 runs variant B (unrolled), 1 variant C (rolled loops).
extern "C" int zk_exp_mul16(const void* a, const void* b, void* out,
                            long long n, int n_muls, int rolled,
                            const void* mod, void* stream) {
  if (n <= 0) return 0;
  Mod16 M = mod16_from_words(static_cast<const uint32_t*>(mod));
  const int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  auto* pa = static_cast<const uint32_t*>(a);
  auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<uint32_t*>(out);
  if (rolled)
    mul16_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        pa, pb, po, n, n_muls, M);
  else
    mul16_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        pa, pb, po, n, n_muls, M);
  return (int)cudaGetLastError();
}
