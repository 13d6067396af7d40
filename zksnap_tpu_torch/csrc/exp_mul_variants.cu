// Kernel K9: the Montgomery-multiply variants of an experiment.
//
// Replaces scripts/exp_mul_variants.py: `run_kernel` (the pallas_call at
// :163) over `kernel_b` (variant B: stacked [16, W] rows, static loops),
// `kernel_c` (variant C: rolled fori_loop over a scratch ref) and
// `kernel_b_chain(n)` (n dependent products).  Variant A of the script is
// the production kernel K1, which the port runs as it is (csrc/mont.cu).
// The arithmetic is mont16.cuh's product over 16-bit limbs (the bits of
// `mul_b` on that domain), modulus BN254 Fq as the script has it, operands
// limb-major [16, n] uint32, one thread an element.
//
// What bounds each variant on the H100, and what the design does about it:
//  - B: each thread reads its 16 limbs of a and b and writes 16 limbs,
//    each row coalesced across the warp (192 bytes an element), and runs
//    the product unrolled: 512 IMAD.WIDE.U32 and a few hundred ALU
//    operations, the columns in a sliding window of registers.  It is
//    bound by its bytes and, nearly as much, by the IMAD pipe, which an
//    IMAD.WIDE takes twice.
//  - C: the same 16 steps as a rolled loop, the variant's subject (a small
//    loop body).  The TPU kept its columns in a VMEM scratch ref; here the
//    window stays in registers with static indices, and only a's limb,
//    indexed by the trip, is read at run time, from shared memory in a
//    thread-minor [16][threads] layout (free of bank conflicts).  No local
//    memory: a 0-byte stack frame.
//  - chain: n dependent products on values held in registers, with one
//    load and one store: the compute-bound rate, free of HBM.  Its bound
//    is the IMAD pipe's: 16-bit limbs take four times the 32-bit CIOS's
//    multiplies, each IMAD.WIDE two of the pipe's slots.

#include "mont16.cuh"

constexpr int kThreads = 256;

template <bool ROLLED>
__global__ void __launch_bounds__(kThreads)
mul16_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
             uint32_t* __restrict__ out, long long n, int n_muls, Mod16 M) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t y[16], r[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) y[i] = b[i * n + e];
  if constexpr (ROLLED) {
    __shared__ uint32_t xs[16][kThreads];
    uint32_t* x = &xs[0][threadIdx.x];
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i * kThreads] = a[i * n + e];
#pragma unroll 1
    for (int k = 0; k < n_muls; ++k) {
      mont16_mul_rolled(x, kThreads, y, M, r);
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i * kThreads] = r[i];
    }
  } else {
    uint32_t x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = a[i * n + e];
#pragma unroll 1
    for (int k = 0; k < n_muls; ++k) {
      mont16_mul(x, y, M, r);
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] = r[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i * n + e] = r[i];
}

// rolled: 0 runs variant B (unrolled), 1 variant C (rolled loop).
extern "C" int zk_exp_mul16(const void* a, const void* b, void* out,
                            long long n, int n_muls, int rolled,
                            const void* mod, void* stream) {
  if (n <= 0) return 0;
  if (n_muls < 1) return (int)cudaErrorInvalidValue;
  Mod16 M = mod16_from_words(static_cast<const uint32_t*>(mod));
  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  auto* pa = static_cast<const uint32_t*>(a);
  auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<uint32_t*>(out);
  if (rolled)
    mul16_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        pa, pb, po, n, n_muls, M);
  else
    mul16_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        pa, pb, po, n, n_muls, M);
  return (int)cudaGetLastError();
}
