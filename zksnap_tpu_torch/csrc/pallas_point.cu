// Batched Jacobian point kernels K8 (add, dbl) and K7 (the staged add).
//
// K8 replaces zksnap_tpu/curves/pallas_point.py `_point_fns` (reached
// through `point_add_batch` / `point_dbl_batch`): the complete Jacobian add
// (add-2007-bl with the doubling fallback and the identity selects, 3 + 3
// coordinates in, 3 out) and dbl-2009-l, one point per TPU lane over
// limb-major [16, n] tiles.  These kernels read the port's [n, 16] rows, one
// thread per point, the ragged edge masked, through point.cuh's `jadd<false>`
// and `jdbl` (the same formulas and selects as the TPU kernel bodies).
//
// K7 replaces zksnap_tpu/curves/pallas_point.py `_staged_add_fn` (reached
// through `point_add_staged`): the same add split in three launches, kept
// as on the TPU: stage A writes the six cross products u1, u2, s1, s2,
// z1z1, z2z2 to device memory, K8's dbl kernel doubles P, and stage B
// combines them with the same selects.  The TPU split exists to keep each
// body inside Mosaic's size budget; on this card it trades registers for
// six [n, 16] intermediates in HBM.
//
// Bound on the H100: integer ALUs.  The function needs add-2007-bl's 16
// Montgomery products and 13 adds a point, and dbl-2009-l's 7 and 14 only
// where P == Q, for 6 x 64 bytes read and 3 x 64 written: about 0.27 ns a
// point at the INT32 rate against 0.17 ns at HBM rate.  These kernels, like
// the TPU's, compute the dbl on every lane and select it (23 products and
// 27 adds a point, 0.40 ns): branch-free, at 1.48x the function's work.
// K7 computes the same function and moves 27 more rows a point through HBM
// (stage A's 6 out and in, the dbl's 3 in and 3 out and in, stage B's 9
// inputs read again).  The multiply is out of line, as in point.cu;
// inlining and register tuning are left for later.

#include "point.cuh"

__global__ void __launch_bounds__(128)
jac_add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
               const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
               const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
               int32_t* __restrict__ ox, int32_t* __restrict__ oy,
               int32_t* __restrict__ oz, long long n, Modulus M) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long o = i * 16;
  Pt p{fe_load(x1 + o), fe_load(y1 + o), fe_load(z1 + o)};
  Pt q{fe_load(x2 + o), fe_load(y2 + o), fe_load(z2 + o)};
  Pt r = jadd<false>(p, q, M);
  fe_store(ox + o, r.x);
  fe_store(oy + o, r.y);
  fe_store(oz + o, r.z);
}

__global__ void __launch_bounds__(128)
jac_dbl_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
               const int32_t* __restrict__ z1, int32_t* __restrict__ ox,
               int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n,
               Modulus M) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long o = i * 16;
  Pt r = jdbl(Pt{fe_load(x1 + o), fe_load(y1 + o), fe_load(z1 + o)}, M);
  fe_store(ox + o, r.x);
  fe_store(oy + o, r.y);
  fe_store(oz + o, r.z);
}

// Stage A of the staged add: the six cross products of add-2007-bl.
__global__ void __launch_bounds__(128)
staged_add_a_kernel(const int32_t* __restrict__ x1,
                    const int32_t* __restrict__ y1,
                    const int32_t* __restrict__ z1,
                    const int32_t* __restrict__ x2,
                    const int32_t* __restrict__ y2,
                    const int32_t* __restrict__ z2, int32_t* __restrict__ u1o,
                    int32_t* __restrict__ u2o, int32_t* __restrict__ s1o,
                    int32_t* __restrict__ s2o, int32_t* __restrict__ zz1o,
                    int32_t* __restrict__ zz2o, long long n, Modulus M) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long o = i * 16;
  Fe zp = fe_load(z1 + o), zq = fe_load(z2 + o);
  Fe z1z1 = fe_sqr(zp, M);
  Fe z2z2 = fe_sqr(zq, M);
  fe_store(u1o + o, fe_mul(fe_load(x1 + o), z2z2, M));
  fe_store(u2o + o, fe_mul(fe_load(x2 + o), z1z1, M));
  fe_store(s1o + o, fe_mul(fe_mul(fe_load(y1 + o), zq, M), z2z2, M));
  fe_store(s2o + o, fe_mul(fe_mul(fe_load(y2 + o), zp, M), z1z1, M));
  fe_store(zz1o + o, z1z1);
  fe_store(zz2o + o, z2z2);
}

// Stage B of the staged add: the rest of add-2007-bl from stage A's
// products, then the doubling fallback (P doubled by jac_dbl_kernel) and
// the identity selects, in the order of jadd.
__global__ void __launch_bounds__(128)
staged_add_b_kernel(const int32_t* __restrict__ u1r,
                    const int32_t* __restrict__ u2r,
                    const int32_t* __restrict__ s1r,
                    const int32_t* __restrict__ s2r,
                    const int32_t* __restrict__ zz1r,
                    const int32_t* __restrict__ zz2r,
                    const int32_t* __restrict__ x1,
                    const int32_t* __restrict__ y1,
                    const int32_t* __restrict__ z1,
                    const int32_t* __restrict__ x2,
                    const int32_t* __restrict__ y2,
                    const int32_t* __restrict__ z2,
                    const int32_t* __restrict__ dxr,
                    const int32_t* __restrict__ dyr,
                    const int32_t* __restrict__ dzr, int32_t* __restrict__ ox,
                    int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                    long long n, Modulus M) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long o = i * 16;
  Fe u1 = fe_load(u1r + o), s1 = fe_load(s1r + o);
  Fe z1z1 = fe_load(zz1r + o), z2z2 = fe_load(zz2r + o);
  Fe zp = fe_load(z1 + o), zq = fe_load(z2 + o);
  Fe h = fe_sub(fe_load(u2r + o), u1, M);
  Fe r = fe_sub(fe_load(s2r + o), s1, M);
  Fe ii = fe_sqr(fe_dbl(h, M), M);
  Fe j = fe_mul(h, ii, M);
  Fe r2 = fe_dbl(r, M);
  Fe v = fe_mul(u1, ii, M);
  Fe x3 = fe_sub(fe_sub(fe_sqr(r2, M), j, M), fe_dbl(v, M), M);
  Fe y3 = fe_sub(fe_mul(r2, fe_sub(v, x3, M), M),
                 fe_dbl(fe_mul(s1, j, M), M), M);
  Fe z3 = fe_mul(
      fe_sub(fe_sub(fe_sqr(fe_add(zp, zq, M), M), z1z1, M), z2z2, M), h, M);
  bool h_zero = fe_is_zero(h);
  bool r_zero = fe_is_zero(r);
  bool p_inf = fe_is_zero(zp);
  bool q_inf = fe_is_zero(zq);
  bool use_dbl = h_zero && r_zero && !p_inf && !q_inf;
  bool to_inf = h_zero && !r_zero && !p_inf && !q_inf;
  Pt d{fe_load(dxr + o), fe_load(dyr + o), fe_load(dzr + o)};
  Pt s{x3, y3, z3};
  s = pt_select(use_dbl, d, s);
  if (to_inf) s.z = fe_zero();
  s = pt_select(p_inf, Pt{fe_load(x2 + o), fe_load(y2 + o), zq}, s);
  s = pt_select(q_inf, Pt{fe_load(x1 + o), fe_load(y1 + o), zp}, s);
  fe_store(ox + o, s.x);
  fe_store(oy + o, s.y);
  fe_store(oz + o, s.z);
}

static inline unsigned blocks_for(long long n) {
  return (unsigned)((n + 127) / 128);
}

#define I32(p) static_cast<const int32_t*>(p)
#define O32(p) static_cast<int32_t*>(p)

extern "C" int zk_jac_add(const void* x1, const void* y1, const void* z1,
                          const void* x2, const void* y2, const void* z2,
                          void* ox, void* oy, void* oz, long long n,
                          const void* mod, void* stream) {
  if (n <= 0) return 0;
  Modulus M = modulus_from_words(static_cast<const uint32_t*>(mod));
  jac_add_kernel<<<blocks_for(n), 128, 0, (cudaStream_t)stream>>>(
      I32(x1), I32(y1), I32(z1), I32(x2), I32(y2), I32(z2), O32(ox), O32(oy),
      O32(oz), n, M);
  ZK_CHECK_RETURN();
}

extern "C" int zk_jac_dbl(const void* x1, const void* y1, const void* z1,
                          void* ox, void* oy, void* oz, long long n,
                          const void* mod, void* stream) {
  if (n <= 0) return 0;
  Modulus M = modulus_from_words(static_cast<const uint32_t*>(mod));
  jac_dbl_kernel<<<blocks_for(n), 128, 0, (cudaStream_t)stream>>>(
      I32(x1), I32(y1), I32(z1), O32(ox), O32(oy), O32(oz), n, M);
  ZK_CHECK_RETURN();
}

// ins: x1, y1, z1, x2, y2, z2; outs: u1, u2, s1, s2, z1z1, z2z2.
extern "C" int zk_staged_add_a(const void* const* ins, void* const* outs,
                               long long n, const void* mod, void* stream) {
  if (n <= 0) return 0;
  Modulus M = modulus_from_words(static_cast<const uint32_t*>(mod));
  staged_add_a_kernel<<<blocks_for(n), 128, 0, (cudaStream_t)stream>>>(
      I32(ins[0]), I32(ins[1]), I32(ins[2]), I32(ins[3]), I32(ins[4]),
      I32(ins[5]), O32(outs[0]), O32(outs[1]), O32(outs[2]), O32(outs[3]),
      O32(outs[4]), O32(outs[5]), n, M);
  ZK_CHECK_RETURN();
}

// ins: u1, u2, s1, s2, z1z1, z2z2, x1, y1, z1, x2, y2, z2, dx, dy, dz;
// outs: x, y, z.
extern "C" int zk_staged_add_b(const void* const* ins, void* const* outs,
                               long long n, const void* mod, void* stream) {
  if (n <= 0) return 0;
  Modulus M = modulus_from_words(static_cast<const uint32_t*>(mod));
  staged_add_b_kernel<<<blocks_for(n), 128, 0, (cudaStream_t)stream>>>(
      I32(ins[0]), I32(ins[1]), I32(ins[2]), I32(ins[3]), I32(ins[4]),
      I32(ins[5]), I32(ins[6]), I32(ins[7]), I32(ins[8]), I32(ins[9]),
      I32(ins[10]), I32(ins[11]), I32(ins[12]), I32(ins[13]), I32(ins[14]),
      O32(outs[0]), O32(outs[1]), O32(outs[2]), n, M);
  ZK_CHECK_RETURN();
}
