// Kernel K10: Montgomery multiply with a Karatsuba product and a REDC on the
// tensor cores, an experiment.
//
// Replaces scripts/exp_mul_mxu.py: `make_kernel` (the pallas_call at :329),
// modulus BN254 Fr, operands limb-major [16, n] uint32, in six variants:
//   base       16x16 schoolbook + word REDC (mont16.cuh, interleaved);
//   kar        two-level Karatsuba product + word REDC;
//   mxu        schoolbook + the REDC as two products by fixed Toeplitz
//              matrices: m = NMAT . digits of T (mod 2^256 after a carry
//              pass), then m * p = PMAT[64, 32] . m;
//   kar+mxu    Karatsuba + the tensor-core REDC;
//   convonly   timing ablation: cols[i] ^ cols[i + 16] of the schoolbook's
//              columns (each product's low and high 16 bits added apart);
//   mxunocarry timing ablation: both products with no carry pass on the
//              digits of those columns, mp[i] ^ mp[i + 32].
// The four product variants return the Montgomery product, the bits of the
// JAX kernel's base on every input of 16-bit limbs (the domain of
// mont16.cuh).  The JAX kar carries its signed Karatsuba columns with a
// uint32 shift and is wrong on a few inputs in a thousand, the JAX kar+mxu
// splits them into 8-bit digits as if they were nonnegative and is wrong on
// every input; here Karatsuba sums whole products in 64-bit columns, which
// are nonnegative (z1 - z0 - z2 is the cross products' sum, column by
// column), so neither fault can arise.  The ablations return the JAX
// kernels' bits.
//
// The products.  Every column sums whole 16x16-bit products (17x17 in
// Karatsuba's middle term) in 64 bits, one IMAD.WIDE.U32 a product; base
// interleaves its REDC with the schoolbook (mont16.cuh).  The ablations'
// columns are the transcription's, each product split in two: they come
// from whole-product sums too, the products summed mod 2^32 (IMAD) beside
// their high halves (IMAD.HI), two instructions a product instead of five.
//
// The tensor-core REDC, one warp a tile of 32 elements, `mma.sync`
// m16n8k32 with u8 digits and s32 sums (exact: digits <= 255, sums below
// 2^22), turned round so that the elements are the M rows and the digit
// positions the N columns:
//  - each thread computes its element's product and writes its row of 64
//    digit bytes (T's, or the ablation's 47 components) to the warp's
//    shared memory as four 16-byte stores, its chunks swizzled (chunk q at
//    slot q ^ (row >> 1 & 3)) so that neither those stores nor the A
//    fragments' 32-bit reads meet a bank conflict;
//  - NMAT and PMAT are the B operands, their fragments packed on the host
//    (exp_mul_mxu.fragment_tables) and held in 24 (mxunocarry: 32)
//    registers a thread for the whole launch, which strides over tiles;
//  - the products come back in the D fragments' registers.  B's columns
//    are permuted so that thread t of a quad holds its two rows'
//    positions 8t..8t+7 of m and 16t..16t+15 of m * p: the carry passes
//    run on each thread's own columns, and three `__shfl_sync`s across
//    the quad pass the carries (a block of 16-bit digits passes a carry
//    in on only where all but its lowest are 0xFFFF); m's bytes reach the
//    second product's A fragments by shuffles within the quad, and the
//    conditional subtract runs on the two threads that hold the result's
//    16 limbs, which they store.
// kar+mxu, whose Karatsuba product leaves the fewest registers free, runs
// its two products as `wgmma` m64n32k32 and m64n64k32 instead: the block's
// four warps' m-tiles are the 64 rows, A comes from the same registers, B
// from the block's shared memory, and 34 fewer registers made it faster
// there; mxu and mxunocarry ran faster on `mma.sync`.
// Bounds on the H100: base and kar are IMAD-bound (512 and 416
// IMAD.WIDE); the mxu variants move the REDC's 256 products to the tensor
// cores (about 1 us of their time at B = 2^18) and are bound by the
// schoolbook, the digits' round trip through shared memory and the carry
// passes.

#include "mont16.cuh"

enum Variant { BASE = 0, KAR = 1, MXU = 2, KAR_MXU = 3, CONVONLY = 4,
               MXUNOCARRY = 5 };

// ------------------------------------------------------------ products

// cols[0..2N-2] <- the whole-product columns of a * b (N limbs each, below
// 2^17)
template <int N>
__device__ __forceinline__ void conv_wide(const uint32_t* a, const uint32_t* b,
                                          uint64_t* cols) {
#pragma unroll
  for (int k = 0; k < 2 * N - 1; ++k) cols[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) cols[i + j] += wide(a[i], b[j]);
}

// Karatsuba (conv_karatsuba of the script) on whole-product columns: depth
// D, the middle term the product of the halves' 17-bit sums (conv_mid)
template <int N, int D>
__device__ __forceinline__ void conv_kar(const uint32_t* a, const uint32_t* b,
                                         uint64_t* out) {
  if constexpr (D == 0 || N <= 4) {
    conv_wide<N>(a, b, out);
  } else {
    constexpr int H = N / 2;
    uint32_t sa[H], sb[H];
    uint64_t z0[2 * H - 1], z1[2 * H - 1], z2[2 * H - 1];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      sa[i] = a[i] + a[H + i];
      sb[i] = b[i] + b[H + i];
    }
    conv_kar<H, D - 1>(a, b, z0);
    conv_kar<H, D - 1>(a + H, b + H, z2);
    conv_wide<H>(sa, sb, z1);
#pragma unroll
    for (int k = 0; k < 2 * N - 1; ++k) out[k] = 0;
#pragma unroll
    for (int i = 0; i < 2 * H - 1; ++i) {
      out[i] += z0[i];
      out[i + 2 * H] += z2[i];
      out[i + H] += z1[i] - z0[i] - z2[i];
    }
  }
}

// out <- the word REDC of whole-product columns cols[0..30] (cols[31] = 0;
// consumed)
__device__ __forceinline__ void word_redc_wide(uint64_t* cols, const Mod16& M,
                                               uint32_t* out) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint32_t m = ((uint32_t)cols[i] * M.n0) & kMask16;
#pragma unroll
    for (int j = 0; j < 16; ++j) cols[i + j] += wide(m, M.p[j]);
    cols[i + 1] += cols[i] >> 16;
  }
  mont16_finish(cols + 16, M, out);
}

// t16[0..31] <- the 16-bit digits of sum cols[k] 2^(16k), k < 31 (a
// product: below 2^512)
__device__ __forceinline__ void carry_digits(const uint64_t* cols,
                                             uint32_t* t16) {
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < 31; ++k) {
    uint64_t v = cols[k] + c;
    t16[k] = (uint32_t)v & kMask16;
    c = (uint32_t)(v >> 16);
  }
  t16[31] = c;
}

// cols[0..NC-1] <- the schoolbook's split columns (conv_schoolbook: each
// product's low 16 bits added to column i + j, its high bits to i + j + 1),
// from whole-product sums: L_k the column's products mod 2^32, H_k their
// high halves (the product of a limb shifted up 16, high word), and column
// k = L_k - 2^16 H_k + H_{k-1}, exact (it is below 2^21).
template <int NC>
__device__ __forceinline__ void split_columns(const uint32_t* a,
                                              const uint32_t* b,
                                              uint32_t* cols) {
  uint32_t L[NC], H[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) L[k] = H[k] = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t ah = a[i] << 16;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (i + j < NC) {
        L[i + j] += a[i] * b[j];
        H[i + j] += __umulhi(ah, b[j]);
      }
  }
#pragma unroll
  for (int k = 0; k < NC; ++k)
    cols[k] = L[k] - (H[k] << 16) + (k ? H[k - 1] : 0u);
}

// ------------------------------------------------------------ tensor cores

constexpr int kWarps = 4;
// the packed B fragments (exp_mul_mxu.fragment_tables): uint32 [40, 32],
// row r lane l at r * 32 + l; PMAT's [8 n tiles][b0, b1], NMAT's on T's 32
// bytes [4][b0, b1], NMAT's on the ablation's 64 components
// [4][2 k steps][b0, b1]
constexpr int kTabPmat = 0, kTabNmat = 16, kTabNmatSplit = 24;

// d = A . B (+ d), m16n8k32, u8 x u8 -> s32
__device__ __forceinline__ void mma_u8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16-byte slot of chunk q (words 4q..4q+3) of row r in a warp's rows
__device__ __forceinline__ int chunk_slot(int r, int q) {
  return r * 4 + (q ^ ((r >> 1) & 3));
}

// The carry into the digits of this thread of a quad, whose four threads
// hold one number's 16-bit columns ND t .. ND t + ND - 1 as digits d (each
// below 2^16, from a carry pass with none in) and a carry c out of them
// (below 2^15): adding a carry below 2^16 carries one more out of the
// digits only where d[1..] are all 0xFFFF and d[0] + carry >= 2^16.
template <int ND>
__device__ __forceinline__ uint32_t quad_carry_in(const uint32_t* d,
                                                  uint32_t c, int t) {
  bool ones = true;
#pragma unroll
  for (int k = 1; k < ND; ++k) ones = ones && d[k] == kMask16;
  const uint32_t need = ones ? 0x10000u - d[0] : 0xFFFFFFFFu;
  uint32_t cin = 0;
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    uint32_t x = __shfl_up_sync(0xFFFFFFFFu, c + (cin >= need), 1, 4);
    if (t == r) cin = x;
  }
  return cin;
}

// w's carry pass with a carry in from the quad: d <- the digits; returns the
// carry out of this thread's columns
template <int ND>
__device__ __forceinline__ uint32_t quad_carry(const uint32_t* w, uint32_t* d,
                                               int t) {
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    uint32_t v = w[k] + c;
    d[k] = v & kMask16;
    c = v >> 16;
  }
  uint32_t cin = quad_carry_in<ND>(d, c, t);
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    uint32_t v = d[k] + cin;
    d[k] = v & kMask16;
    cin = v >> 16;
  }
  return c + cin;
}

struct Tables {
  uint32_t p[8][2];      // PMAT, N = 64 positions of m * p
  uint32_t nm[4][2][2];  // NMAT, N = 32 positions of m; [k step]
};

template <bool SPLIT>
__device__ __forceinline__ Tables load_tables(const uint32_t* tab, int lane) {
  Tables T;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      T.p[nt][h] = tab[(kTabPmat + 2 * nt + h) * 32 + lane];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int ks = 0; ks < (SPLIT ? 2 : 1); ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        T.nm[nt][ks][h] =
            SPLIT ? tab[(kTabNmatSplit + 4 * nt + 2 * ks + h) * 32 + lane]
                  : tab[(kTabNmat + 2 * nt + h) * 32 + lane];
  return T;
}

// kar+mxu's B operands for `wgmma` (m64nNk32, the block's four warps'
// m-tiles as its 64 rows, A from registers): the same matrices in the
// block's shared memory as K-major core matrices of 8 N rows x 16 K bytes,
// core (cb, kb) at (cb * 2 + kb) * 128.  The descriptor's leading offset
// is that of K-adjacent cores (128 bytes), its stride that of N-adjacent
// ones (256).  Its D fragments have mma.sync's layout, n tile by n tile.
struct WgTables {
  const uint8_t* pm;  // PMAT, 8 x 2 cores
  const uint8_t* nm;  // NMAT on T's 32 bytes, 4 x 2 cores
};

__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16)
         | ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// waits for the warpgroup's products; then no use of d moves above it
template <int NT>
__device__ __forceinline__ void wg_wait(int (&d)[NT][4]) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(d[i][r])::"memory");
}

// d = A . B, m64n32k32 u8 x u8 -> s32, A from registers
__device__ __forceinline__ void wgmma_n32(int (&d)[4][4], const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

// d = A . B, m64n64k32 u8 x u8 -> s32, A from registers
__device__ __forceinline__ void wgmma_n64(int (&d)[8][4], const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

// The REDC on the tensor cores for the warp's tile of 32 elements, from
// row[16]: this lane's element's digit words (SPLIT: the ablation's
// components, K = 64, and NOCARRY; else T's 64 bytes, of which m takes the
// first 32).  Stores the results of the tile's elements below n.  With
// WG the products are the warpgroup's `wgmma`s (Tab WgTables; every warp
// of the block calls it for a tile at once), else the warp's `mma.sync`s
// (Tab Tables).
template <bool SPLIT, bool WG, class Tab>
__device__ __forceinline__ void tc_redc(const uint32_t (&row)[16],
                                        const Mod16& M, const Tab& T,
                                        uint4* rows, int lane, uint32_t* out,
                                        long long base, long long n) {
  static_assert(!(WG && SPLIT), "wgmma runs kar+mxu only");
  const int g = lane >> 2, t = lane & 3;
  const unsigned quad = lane & ~3;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    rows[chunk_slot(lane, q)] = make_uint4(row[4 * q], row[4 * q + 1],
                                           row[4 * q + 2], row[4 * q + 3]);
  __syncwarp();
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(rows);
  auto word = [&](int r, int w) {
    return rw[chunk_slot(r, w >> 2) * 4 + (w & 3)];
  };
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = 16 * mt + g;  // this thread's rows r0 and r0 + 8
    // m's columns: positions 8t + 2nt + b in dm[nt][2 h + b]
    int dm[4][4] = {};
    if constexpr (WG) {
      const uint32_t am[4] = {word(r0, t), word(r0 + 8, t), word(r0, 4 + t),
                              word(r0 + 8, 4 + t)};
      wg_fence();
      wgmma_n32(dm, am, wg_desc(T.nm));
      wg_wait(dm);
    } else {
#pragma unroll
      for (int ks = 0; ks < (SPLIT ? 2 : 1); ++ks) {
        uint32_t a0 = word(r0, 8 * ks + t), a1 = word(r0 + 8, 8 * ks + t);
        uint32_t a2 = word(r0, 8 * ks + 4 + t);
        uint32_t a3 = word(r0 + 8, 8 * ks + 4 + t);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_u8(dm[nt], a0, a1, a2, a3, T.nm[nt][ks][0], T.nm[nt][ks][1]);
      }
    }
    // m's bytes 8t..8t+7 of each row, two words
    uint32_t mw[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (SPLIT) {  // no carry: each column's low byte
#pragma unroll
        for (int x = 0; x < 2; ++x)
          mw[h][x] = __byte_perm(__byte_perm(dm[2 * x][2 * h],
                                             dm[2 * x][2 * h + 1], 0x40),
                                 __byte_perm(dm[2 * x + 1][2 * h],
                                             dm[2 * x + 1][2 * h + 1], 0x40),
                                 0x5410);
      } else {
        uint32_t w[4], d[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          w[c] = (uint32_t)dm[c][2 * h] + ((uint32_t)dm[c][2 * h + 1] << 8);
        quad_carry<4>(w, d, t);  // m mod 2^256: the top carry dropped
        mw[h][0] = d[0] | (d[1] << 16);
        mw[h][1] = d[2] | (d[3] << 16);
      }
    }
    // the second product's A fragments: m's word t of each row from
    // thread t / 2 of the quad, word 4 + t from thread 2 + t / 2
    uint32_t af[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int h = f & 1, src = quad | ((f >> 1) * 2 + (t >> 1));
      uint32_t x0 = __shfl_sync(0xFFFFFFFFu, mw[h][0], src);
      uint32_t x1 = __shfl_sync(0xFFFFFFFFu, mw[h][1], src);
      af[f] = (t & 1) ? x1 : x0;
    }
    // m * p: positions 16t + 2nt + b in dp[nt][2 h + b]
    int dp[8][4] = {};
    if constexpr (WG) {
      wg_fence();
      wgmma_n64(dp, af, wg_desc(T.pm));
      wg_wait(dp);
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mma_u8(dp[nt], af[0], af[1], af[2], af[3], T.p[nt][0], T.p[nt][1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long e = base + r0 + 8 * h;
      // the limbs this thread stores: lo..lo+7, upper where lo = 8
      const bool upper = SPLIT ? t >> 1 : t & 1;
      const int lo = upper ? 8 : 0;
      uint32_t res[8];
      if constexpr (SPLIT) {
        // mp[i] ^ mp[i + 32]: thread 0 of the quad holds i = 0..15, thread
        // 2 the positions 32..47; they swap half, and store 8 limbs each
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t low = (uint32_t)dp[i >> 1][2 * h + (i & 1)];
          const uint32_t high = (uint32_t)dp[(8 + i) >> 1][2 * h + (i & 1)];
          res[i] = (upper ? high : low)
                   ^ __shfl_xor_sync(0xFFFFFFFFu, upper ? low : high, 2);
        }
      } else {
        // U = (T + m p) / 2^256: 16-bit columns 8t..8t+7 of T + m p here,
        // T's digits from the row (chunk t of the row is words 4t..4t+3)
        const uint4 tq = rows[chunk_slot(r0 + 8 * h, t)];
        const uint32_t tw[4] = {tq.x, tq.y, tq.z, tq.w};
        uint32_t w[8], d[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          w[c] = (uint32_t)dp[c][2 * h] + ((uint32_t)dp[c][2 * h + 1] << 8)
                 + ((tw[c >> 1] >> (16 * (c & 1))) & kMask16);
        const uint32_t top = quad_carry<8>(w, d, t);
        // the conditional subtract on threads 2 (U's limbs 0..7) and 3
        // (8..15, and U's bit 256 in top): thread 3 takes thread 2's borrow
        uint32_t borrow = 0, s[8], pl[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) pl[i] = upper ? M.p[8 + i] : M.p[i];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          uint32_t x = d[i] - pl[i] - borrow;
          borrow = x >> 31;
        }
        borrow = __shfl_up_sync(0xFFFFFFFFu, borrow, 1, 4);
        borrow = upper ? borrow : 0u;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          uint32_t x = d[i] - pl[i] - borrow;
          s[i] = x & kMask16;
          borrow = x >> 31;
        }
        const int ge = __shfl_sync(0xFFFFFFFFu,
                                   (int)(top != 0 || borrow == 0), quad | 3);
#pragma unroll
        for (int i = 0; i < 8; ++i) res[i] = ge ? s[i] : d[i];
      }
      const bool stores = SPLIT ? (t & 1) == 0 : t >= 2;
      if (stores && e < n) {
#pragma unroll
        for (int i = 0; i < 8; ++i) out[(lo + i) * n + e] = res[i];
      }
    }
  }
}

// One tile of a tensor-core variant: this lane's element's product and its
// digits, then the tile's REDC.
template <int V, bool WG, class Tab>
__device__ __forceinline__ void tc_tile(const uint32_t* __restrict__ a,
                                        const uint32_t* __restrict__ b,
                                        uint32_t* __restrict__ out,
                                        long long n, const Mod16& M,
                                        const Tab& T, uint4* rows, int lane,
                                        long long base) {
  constexpr bool SPLIT = V == MXUNOCARRY;
  const long long e = base + lane;
  const bool valid = e < n;
  uint32_t x[16], y[16], row[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    x[i] = valid ? a[i * n + e] : 0u;
    y[i] = valid ? b[i * n + e] : 0u;
  }
  if constexpr (SPLIT) {
    // the components: the low three bytes of the first 16 columns
    uint32_t cols[16];
    split_columns<16>(x, y, cols);
#pragma unroll
    for (int w = 0; w < 16; ++w) {
      uint32_t v = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 4 * w + q;
        if (c < 48) v |= ((cols[c / 3] >> (8 * (c % 3))) & 0xFFu) << (8 * q);
      }
      row[w] = v;
    }
  } else {
    uint64_t cols[31];
    if constexpr (V == KAR_MXU)
      conv_kar<16, 2>(x, y, cols);
    else
      conv_wide<16>(x, y, cols);
    uint32_t t16[32];
    carry_digits(cols, t16);
#pragma unroll
    for (int w = 0; w < 16; ++w) row[w] = t16[2 * w] | (t16[2 * w + 1] << 16);
  }
  tc_redc<SPLIT, WG>(row, M, T, rows, lane, out, base, n);
  __syncwarp();
}

template <int V>
__global__ void __launch_bounds__(kWarps * 32)
mxu_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, long long n, Mod16 M,
               const uint32_t* __restrict__ tab) {
  constexpr bool TC = V == MXU || V == KAR_MXU || V == MXUNOCARRY;
  if constexpr (!TC) {
    long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    uint32_t x[16], y[16], r[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      x[i] = a[i * n + e];
      y[i] = b[i * n + e];
    }
    if constexpr (V == BASE) {
      mont16_mul(x, y, M, r);
    } else if constexpr (V == KAR) {
      uint64_t cols[32];
      conv_kar<16, 2>(x, y, cols);
      cols[31] = 0;
      word_redc_wide(cols, M, r);
    } else {  // CONVONLY
      uint32_t cols[32];
      split_columns<32>(x, y, cols);
#pragma unroll
      for (int i = 0; i < 16; ++i) r[i] = cols[i] ^ cols[i + 16];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i * n + e] = r[i];
  } else {
    // one warp a tile of 32 elements, striding over the tiles; a tile with
    // a ragged edge runs whole, its idle lanes on zeros.  kar+mxu's wgmma
    // takes the block's four warps at once: the block strides together.
    constexpr bool SPLIT = V == MXUNOCARRY, WG = V == KAR_MXU;
    __shared__ uint4 rows_all[kWarps][32 * 4];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if constexpr (WG) {
      __shared__ __align__(128) uint8_t tab_pm[16 * 128], tab_nm[8 * 128];
      // the fragment table's words to their cores: row r = 2 nt + h holds
      // B[16h + 4t .. +3][8nt + g] at lane g * 4 + t
      for (int i = threadIdx.x; i < 16 * 32; i += kWarps * 32) {
        const int r = i / 32, l = i % 32, at = (l >> 2) * 16 + 4 * (l & 3);
        *reinterpret_cast<uint32_t*>(tab_pm + r * 128 + at) =
            tab[(kTabPmat + r) * 32 + l];
        if (r < 8)
          *reinterpret_cast<uint32_t*>(tab_nm + r * 128 + at) =
              tab[(kTabNmat + r) * 32 + l];
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const WgTables T{tab_pm, tab_nm};
      for (long long blk = (long long)blockIdx.x * kWarps * 32; blk < n;
           blk += (long long)gridDim.x * kWarps * 32)
        tc_tile<V, WG>(a, b, out, n, M, T, rows_all[warp], lane,
                       blk + 32 * warp);
    } else {
      const Tables T = load_tables<SPLIT>(tab, lane);
      for (long long base = ((long long)blockIdx.x * kWarps + warp) * 32;
           base < n; base += (long long)gridDim.x * kWarps * 32)
        tc_tile<V, WG>(a, b, out, n, M, T, rows_all[warp], lane, base);
    }
  }
}

template <int V>
static void launch(long long n, cudaStream_t s, const uint32_t* a,
                   const uint32_t* b, uint32_t* out, const Mod16& M,
                   const uint32_t* tab) {
  constexpr int threads = kWarps * 32;
  long long blocks = (n + threads - 1) / threads;
  if (V == MXU || V == KAR_MXU || V == MXUNOCARRY) {
    // the tensor-core variants stride: as many blocks as run at once
    static int resident = 0;
    if (resident == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mxu_mul_kernel<V>, threads, 0);
      resident = sms * (per_sm > 0 ? per_sm : 1);
    }
    if (blocks > resident) blocks = resident;
  }
  mxu_mul_kernel<V><<<(unsigned)blocks, threads, 0, s>>>(a, b, out, n, M, tab);
}

// tab: uint32 [40, 32], the fragments of NMAT and PMAT
// (exp_mul_mxu.fragment_tables)
extern "C" int zk_exp_mxu_mul(int variant, const void* a, const void* b,
                              void* out, long long n, const void* mod,
                              const void* tab, void* stream) {
  if (n <= 0) return 0;
  Mod16 M = mod16_from_words(static_cast<const uint32_t*>(mod));
  auto* pa = static_cast<const uint32_t*>(a);
  auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<uint32_t*>(out);
  auto* tb = static_cast<const uint32_t*>(tab);
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case BASE: launch<BASE>(n, s, pa, pb, po, M, tb); break;
    case KAR: launch<KAR>(n, s, pa, pb, po, M, tb); break;
    case MXU: launch<MXU>(n, s, pa, pb, po, M, tb); break;
    case KAR_MXU: launch<KAR_MXU>(n, s, pa, pb, po, M, tb); break;
    case CONVONLY: launch<CONVONLY>(n, s, pa, pb, po, M, tb); break;
    case MXUNOCARRY: launch<MXUNOCARRY>(n, s, pa, pb, po, M, tb); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
