// Inlined RCB 2015 formulas (Algorithms 7, 8, 9) for the kernels whose
// work is a chain of group operations: the point kernel's projective
// kinds (K3, point.cu), the bucket scan (K4, bucket_scan.cu), the
// weighted suffix (K5) and the ladder and tree (K6, reduce.cu).
//
// field.cuh's fe_mul is an out-of-line call, which keeps K7 and K8 and the
// Jacobian formulas of point.cuh short to build; in a chain it costs a
// stack frame (each product's operands and a copy of the Modulus go
// through local memory) and serialises the products.  Here every product
// is inlined (field_inline.cuh, which K1 uses too), the Modulus is read
// from the kernel's parameter bank, and the independent products of a
// formula stage run through fe_mul_n, which issues the products' CIOS
// rounds side by side so that their instructions interleave.  A stage's
// products may also be shared by a group of T adjacent threads that hold
// the same point (fe_mul_group): each computes every T-th product and
// shuffles pass the results round, so that a dependent chain waits on
// about N / T products a stage, not N, and a kernel gets T times the
// warps.  The formulas are RCB's with the same field operations on the
// same values as the plain versions (curves/fused.py); every value stays
// canonical, so the results are bit-exact against them.
#pragma once

#include "point.cuh"
#include "field_inline.cuh"

// r[j] = a[j] * b[j] * 2^-256 mod p for j < N, shared by a group of T
// adjacent threads (T divides 32, and the block's threads are whole
// groups): thread s of the group computes products s, s + T, ..., side by
// side, and every thread gets all N results by shuffles.  Every thread of
// the warp must reach it.  T = 1 is fe_mul_n.
template <int N, int T>
__device__ __forceinline__ void fe_mul_group(Fe (&r)[N], const Fe (&a)[N],
                                             const Fe (&b)[N],
                                             const Modulus& M) {
  if constexpr (T == 1) {
    fe_mul_n<N>(r, a, b, M);
  } else {
    constexpr int K = (N + T - 1) / T;
    const int s = threadIdx.x % T;
    Fe x[K], y[K], m[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[k] = a[k * T];
      y[k] = b[k * T];
#pragma unroll
      for (int t = 1; t < T; ++t)
        if (k * T + t < N) {
          x[k] = fe_select(s == t, a[k * T + t], x[k]);
          y[k] = fe_select(s == t, b[k * T + t], y[k]);
        }
    }
    fe_mul_n<K>(m, x, y, M);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (k * T + t < N)
#pragma unroll
          for (int w = 0; w < 8; ++w)
            r[k * T + t].w[w] = __shfl_sync(0xffffffffu, m[k].w[w], t, T);
  }
}

// The second half of RCB Algorithms 7 and 8, from t0 = X1 X2, t1 = Y1 Y2,
// t3, t4, y3 and t2m = 3b Z1 Z2 (Algorithm 7) or 3b Z1 (Algorithm 8).
template <int T>
__device__ __forceinline__ Pt rcb_tail(const Fe& t0, Fe t1, const Fe& t3,
                                       const Fe& t4, Fe y3, const Fe& t2m,
                                       int b3, const Modulus& M) {
  Fe t0_3 = fe_add(fe_dbl(t0, M), t0, M);
  Fe z3 = fe_add(t1, t2m, M);
  t1 = fe_sub(t1, t2m, M);
  y3 = fe_small_mul(y3, b3, M);
  Fe m[6];
  fe_mul_group<6, T>(m, {t3, t4, t1, y3, z3, t0_3},
                     {t1, y3, z3, t0_3, t4, t3}, M);
  return Pt{fe_sub(m[0], m[1], M), fe_add(m[2], m[3], M),
            fe_add(m[4], m[5], M)};
}

// RCB 2015 Algorithm 8: p + q for an affine q (q.z == 0 encodes the
// identity and passes p through).
template <int T = 1>
__device__ __forceinline__ Pt padd_mixed_inl(const Pt& p, const Pt& q,
                                             int b3, const Modulus& M) {
  Fe m[5];
  fe_mul_group<5, T>(m, {p.x, p.y, fe_add(q.x, q.y, M), q.y, q.x},
                     {q.x, q.y, fe_add(p.x, p.y, M), p.z, p.z}, M);
  Fe t3 = fe_sub(m[2], fe_add(m[0], m[1], M), M);
  Pt r = rcb_tail<T>(m[0], m[1], t3, fe_add(m[3], p.y, M),
                     fe_add(m[4], p.x, M), fe_small_mul(p.z, b3, M), b3, M);
  return pt_select(fe_is_zero(q.z), p, r);
}

// RCB 2015 Algorithm 7: complete p + q.
template <int T = 1>
__device__ __forceinline__ Pt padd_inl(const Pt& p, const Pt& q, int b3,
                                       const Modulus& M) {
  Fe m[6];
  fe_mul_group<6, T>(m, {p.x, p.y, p.z, fe_add(p.x, p.y, M),
                         fe_add(p.y, p.z, M), fe_add(p.x, p.z, M)},
                     {q.x, q.y, q.z, fe_add(q.x, q.y, M),
                      fe_add(q.y, q.z, M), fe_add(q.x, q.z, M)}, M);
  Fe t3 = fe_sub(m[3], fe_add(m[0], m[1], M), M);
  Fe t4 = fe_sub(m[4], fe_add(m[1], m[2], M), M);
  Fe y3 = fe_sub(m[5], fe_add(m[0], m[2], M), M);
  return rcb_tail<T>(m[0], m[1], t3, t4, y3, fe_small_mul(m[2], b3, M), b3,
                     M);
}

// RCB 2015 Algorithm 9: complete doubling, in two stages of four
// products: {Y^2, Y Z, Z^2, X Y}, then with t2 = 3b Z^2,
// {t2 * 8 Y^2, Y Z * 8 Y^2, (Y^2 - 3 t2)(Y^2 + t2), (Y^2 - 3 t2) X Y}.
template <int T = 1>
__device__ __forceinline__ Pt pdbl_inl(const Pt& p, int b3,
                                       const Modulus& M) {
  Fe m[4];
  fe_mul_group<4, T>(m, {p.y, p.y, p.z, p.x}, {p.y, p.z, p.z, p.y}, M);
  const Fe t2 = fe_small_mul(m[2], b3, M);
  const Fe z3 = fe_dbl(fe_dbl(fe_dbl(m[0], M), M), M);
  const Fe y3 = fe_add(m[0], t2, M);
  const Fe t0 = fe_sub(m[0], fe_add(fe_dbl(t2, M), t2, M), M);
  Fe n[4];
  fe_mul_group<4, T>(n, {t2, m[1], t0, t0}, {z3, z3, y3, m[3]}, M);
  return Pt{fe_dbl(n[3], M), fe_add(n[0], n[2], M), n[1]};
}

// The rows of point i from a thread of a group of T that holds it: thread
// s stores the 16-byte chunks s, s + T, ... of x, y and z (T = 1: all).
template <int T>
__device__ __forceinline__ void pt_store_share(int32_t* x, int32_t* y,
                                               int32_t* z, long long i,
                                               const Pt& p) {
  const int s = threadIdx.x % T;
  int4* dst[3] = {reinterpret_cast<int4*>(x + i * 16),
                  reinterpret_cast<int4*>(y + i * 16),
                  reinterpret_cast<int4*>(z + i * 16)};
  const Fe f[3] = {p.x, p.y, p.z};
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if ((4 * c + q) % T == s)
        dst[c][q] = make_int4((int)(f[c].w[2 * q] & 0xFFFFu),
                              (int)(f[c].w[2 * q] >> 16),
                              (int)(f[c].w[2 * q + 1] & 0xFFFFu),
                              (int)(f[c].w[2 * q + 1] >> 16));
}
