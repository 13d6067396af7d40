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
// Bounds on the H100: integer-ALU bound (11 multiplies per pmadd step) with
// K*M*(64 + 192) bytes of traffic.  Left for later: coalescing (a lane's
// reads are K rows apart), the lane count (the caller picks M), lazy
// reduction.

#include "point.cuh"

template <bool PROJ>
__global__ void __launch_bounds__(128)
bucket_scan_kernel(const uint8_t* __restrict__ flags,
                   const int32_t* __restrict__ x,
                   const int32_t* __restrict__ y,
                   const int32_t* __restrict__ z, int32_t* __restrict__ ox,
                   int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                   long long M_lanes, long long K, int b3, Modulus M) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= M_lanes) return;
  // identity: RCB (0 : 1 : 0), Jacobian (1 : 1 : 0)
  Pt acc{PROJ ? fe_zero() : fe_one(M), fe_one(M), fe_zero()};
  for (long long k = 0; k < K; ++k) {
    long long pos = lane * K + k;
    long long o = pos * 16;
    Pt p{fe_load(x + o), fe_load(y + o), fe_load(z + o)};
    Pt s = PROJ ? padd<true>(acc, p, b3, M) : jadd<true>(acc, p, M);
    acc = pt_select(flags[pos] != 0, p, s);
    long long w = (k * M_lanes + lane) * 16;
    fe_store(ox + w, acc.x);
    fe_store(oy + w, acc.y);
    fe_store(oz + w, acc.z);
  }
}

extern "C" int zk_bucket_scan(const void* flags, const void* x, const void* y,
                              const void* z, void* ox, void* oy, void* oz,
                              long long lanes, long long steps, int proj,
                              int b3, const void* mod, void* stream) {
  if (lanes <= 0 || steps <= 0) return 0;
  Modulus M = modulus_from_words(static_cast<const uint32_t*>(mod));
  const int threads = 128;
  unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  auto F = static_cast<const uint8_t*>(flags);
  auto X = static_cast<const int32_t*>(x), Y = static_cast<const int32_t*>(y),
       Z = static_cast<const int32_t*>(z);
  auto OX = static_cast<int32_t*>(ox), OY = static_cast<int32_t*>(oy),
       OZ = static_cast<int32_t*>(oz);
  if (proj)
    bucket_scan_kernel<true><<<blocks, threads, 0, s>>>(F, X, Y, Z, OX, OY, OZ, lanes, steps, b3, M);
  else
    bucket_scan_kernel<false><<<blocks, threads, 0, s>>>(F, X, Y, Z, OX, OY, OZ, lanes, steps, b3, M);
  ZK_CHECK_RETURN();
}
