// Point kernel K3: one complete group operation per element, six kinds.
//
// Replaces zksnap_tpu/curves/fused.py `_point_call` (reached through
// `point_add_fused` / `point_dbl_fused`): padd, pmadd, pdbl (RCB 2015
// complete projective, a = 0) and add, madd, dbl (Jacobian with branchless
// completeness selects).  The TPU kernel transposes to limb-major [16, n]
// tiles padded to 128- or 1024-lane blocks; this one reads the port's
// [n, 16] rows directly, one thread per point, the ragged edge masked.
//
// Bounds on the H100: integer-ALU bound, 11-21 Montgomery multiplies per
// point for 3-6 x 64 bytes read and 192 bytes written.  The multiply is
// one out-of-line function to keep the build short; inlining it, the lazy
// [0, 2p) form of the TPU kernels and register tuning are left for later.

#include "point.cuh"

template <int KIND>
__global__ void __launch_bounds__(128)
point_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
             const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
             const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
             int32_t* __restrict__ ox, int32_t* __restrict__ oy,
             int32_t* __restrict__ oz, long long n, int b3, Modulus M) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long o = i * 16;
  Pt p{fe_load(x1 + o), fe_load(y1 + o), fe_load(z1 + o)};
  Pt r;
  if (KIND == K_DBL) {
    r = jdbl(p, M);
  } else if (KIND == K_PDBL) {
    r = pdbl(p, b3, M);
  } else {
    Pt q{fe_load(x2 + o), fe_load(y2 + o), fe_load(z2 + o)};
    if (KIND == K_ADD) r = jadd<false>(p, q, M);
    if (KIND == K_MADD) r = jadd<true>(p, q, M);
    if (KIND == K_PADD) r = padd<false>(p, q, b3, M);
    if (KIND == K_PMADD) r = padd<true>(p, q, b3, M);
  }
  fe_store(ox + o, r.x);
  fe_store(oy + o, r.y);
  fe_store(oz + o, r.z);
}

extern "C" int zk_point(int kind, const void* x1, const void* y1,
                        const void* z1, const void* x2, const void* y2,
                        const void* z2, void* ox, void* oy, void* oz,
                        long long n, int b3, const void* mod, void* stream) {
  if (n <= 0) return 0;
  Modulus M = modulus_from_words(static_cast<const uint32_t*>(mod));
  const int threads = 128;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  auto X1 = static_cast<const int32_t*>(x1), Y1 = static_cast<const int32_t*>(y1),
       Z1 = static_cast<const int32_t*>(z1), X2 = static_cast<const int32_t*>(x2),
       Y2 = static_cast<const int32_t*>(y2), Z2 = static_cast<const int32_t*>(z2);
  auto OX = static_cast<int32_t*>(ox), OY = static_cast<int32_t*>(oy),
       OZ = static_cast<int32_t*>(oz);
  switch (kind) {
    case K_ADD:
      point_kernel<K_ADD><<<blocks, threads, 0, s>>>(X1, Y1, Z1, X2, Y2, Z2, OX, OY, OZ, n, b3, M);
      break;
    case K_MADD:
      point_kernel<K_MADD><<<blocks, threads, 0, s>>>(X1, Y1, Z1, X2, Y2, Z2, OX, OY, OZ, n, b3, M);
      break;
    case K_DBL:
      point_kernel<K_DBL><<<blocks, threads, 0, s>>>(X1, Y1, Z1, X2, Y2, Z2, OX, OY, OZ, n, b3, M);
      break;
    case K_PADD:
      point_kernel<K_PADD><<<blocks, threads, 0, s>>>(X1, Y1, Z1, X2, Y2, Z2, OX, OY, OZ, n, b3, M);
      break;
    case K_PMADD:
      point_kernel<K_PMADD><<<blocks, threads, 0, s>>>(X1, Y1, Z1, X2, Y2, Z2, OX, OY, OZ, n, b3, M);
      break;
    case K_PDBL:
      point_kernel<K_PDBL><<<blocks, threads, 0, s>>>(X1, Y1, Z1, X2, Y2, Z2, OX, OY, OZ, n, b3, M);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  ZK_CHECK_RETURN();
}
