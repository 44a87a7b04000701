// Warm-started ADMM ladder for a constant-matrix QP, whole solve in one kernel,
// its three products on Hopper's tensor cores from split TF32 pieces.
//
// Replaces: emplanner_carla_tpu/ops/qp_pallas.py make_pallas_qp (warm=True,
// and warm=False as the ladder from the zero state; the fused Pallas kernel
// the path QP dispatches to at ops/qp.py:489 and the speed QP at
// planner/speed_planner.py:493). Computes, per lane b, with the Ruiz
// scalings D, E, c of the QP family:
//   qs = c*(D*q), ls = E*l, us = E*u, z = clip(z0, ls, us)
//   for each rho phase p, iters times:
//     rhs = sigma*x - qs + A^T (rho_p*z - y)
//     x   = Kinv_p rhs
//     Ax_rel = alpha*(A x) + (1-alpha)*z
//     z'  = clip(Ax_rel + y/rho_p, ls, us);  y += rho_p*(Ax_rel - z');  z = z'
//   out: x = D*x_s, and the scaled state (x_s, z, y).
//
// What bounds it on the H100: the products. Per lane and iteration they are
// 2*nnz(A) + n*n multiply-adds (nnz(A) = 547, n = 100 at the path site; A is
// sparse, Kinv dense), every iteration depends on the previous one, and the
// batch is the only parallelism. The matrix operand (A, A^T, the phase's
// Kinv) is one constant shared by every lane, so across a tile of lanes each
// product is a small GEMM: lanes x constant. The operations bound is those
// products' flops x 3 passes at the dense TF32 rate (495 TFLOP/s) plus the
// elementwise flops at the FP32 rate (67 TFLOP/s). What limits this kernel
// is the rate at which it dispatches instructions: five mma.sync TF32 (below
// wgmma's rate) and the splits and sums around them per (k-step, tile,
// 16-lane half), over A's nonzero 8 x 8 blocks (below) where nnz(A) needs
// far fewer multiply-adds.
//
// Precision: the products run on the tensor cores from TF32 pieces with
// FP32 accumulation. The lane operand x is split in registers into hi = x
// rounded to TF32 as cvt.rna.tf32.f32 rounds (by two integer operations; cvt
// runs at a quarter of their rate) and lo = the same rounding of x - hi; the
// constant b into three pieces by truncation, hi + mid + lo = b exactly, in
// registers at each use (A's three pieces alone would take 230 KB of shared
// memory, more than a block has). Of
// the six piece products the five above 2^-24 of the whole are formed
// (al*bl, ~2^-33, is dropped). Plain 3xTF32 (both operands in two pieces,
// three products) did not meet the speed site's bar: a constant held to
// 2^-22 is a fixed perturbation of Kinv, which the rho ladder amplifies (x
// off by ~1.5e-3 against the 1e-3 bar on the card); the three-piece constant
// removes it. Each (k-step, tile) sums its products in fresh accumulators
// and adds them to the running sum in FP32, and the largest partial is
// unbiased first: the tensor cores round their sums toward zero, and that
// bias, k-step after k-step, moved the ladder several times further from the
// plain version than float32's own round-off (see k_step). No single-pass
// TF32 product is on the path. The TPU kernel's bf16x3 split
// (qp_pallas.py:136 dot3, ~2^-17 an operand) is not used. A NaN in a lane
// operand is stored as the quiet NaN (see quiet()), so a NaN lane stays NaN
// as in the plain version.
//
// Tile and waves: one block of 8 warps (256 threads) per tile of 32 lanes.
// Batch 4096 is 128 blocks on 132 SMs: one wave, one block an SM (the
// previous 16-lane tile made 256 blocks, two waves). Lanes past B compute on
// zeros and are not stored.
//
// Products: mma.sync.m16n8k8 TF32 (row.col, FP32 accumulate). The 32 lanes
// are the MMA's M dimension (two 16-row tiles), the constant is the B
// operand (N = the product's output rows in 8-column tiles, K = its
// reduction), so each B fragment is loaded and split once and feeds 2 halves
// x 5 products. Warp w owns the output tiles w, w+8, ... of each product:
// the n-sized ones (A^T v and Kinv rhs: 13 tiles at the path site, 2 a warp
// at most) and the m-sized one (A x: 23 tiles, 3 a warp at most). wgmma is
// not used: its 64-row tiles would need 64 lanes a block (64 blocks for
// batch 4096, half the SMs idle). A is banded (58 of the path QP's 299 8 x 8
// blocks are not all zero, 25 of the speed QP's 91): A^T v and A x run over
// the nonzero blocks only, from lists the host builds once (ops/qp.py
// kernel_constants). Skipping a zero block is exact for finite lane values;
// Kinv is dense and runs in full.
//
// State: the thread that owns an A x accumulator entry (lane, row i) keeps
// z and y of that entry and rho, 1/rho of row i in registers for the whole
// solve (the scaled bounds ls, us in shared memory), so the over-relaxation,
// projection (with y * (1/rho), as the TPU kernel forms it, for y / rho),
// dual update and the next v = rho*z - y are the epilogue of the A x
// product. Likewise the thread that owns an (lane, j) entry of the n-sized
// products keeps x and qs, so rhs = sigma*x - qs + A^T v and x = Kinv rhs
// are epilogues too. Each epilogue stores its outputs as the next product's
// lane operand; an iteration has three __syncthreads (five before).
//
// Shared-memory layout, floats (n8 = n rounded up to 8, m8 likewise):
//   A      m8 x pa, pa = n8 if n8/8 is odd, else n8 + 8 (8 or 24 mod 32);
//   Kinv^T n8 x pk, pk = n8 + 4 (4 or 12 mod 16), the phase's, staged by
//          cp.async at the phase's start (A once, while the lane inputs load);
//          a second buffer to prefetch the next phase's would not fit;
//   ls, us 32 x pl, pl = 2 m8 (+ 16 where that is a multiple of 32), a
//          thread's pair of entries as one 16-byte {ls, ls, us, us};
//   v      32 x pv(m8), rhs and x 32 x pv(n8), pv as pa: the k-step's
//          reduction slots are ordered so that A-fragment slot tig is column
//          2 tig and slot tig + 4 column 2 tig + 1 (B follows), so the thread
//          that produces a lane's columns 2 tig, + 1 reads them back, with
//          one 8-byte access each way;
//   blocks the lists of A's nonzero blocks (ints, at most 2 kn km + kn + km + 2).
// Every access is free of bank conflicts except A^T v's B loads, which are
// two-way. Budget: path site (n 100, m 179) 221,296 bytes; speed site
// (n 51, m 99) 91,824 bytes; the H100 gives a block 232,448.
//
// Limits: n <= 104 variables and m <= 184 constraint rows (the register
// tiles: 2 n-tiles and 3 m-tiles a warp; and the shared-memory budget,
// 221,296 bytes at the limits). The path site (n 100, m 179) and the speed
// site (n 51, m 99) are inside. The launcher returns cudaErrorInvalidValue
// past them; the wrapper (ops/qp.py warm_admm_kernel) raises first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;    // lanes per block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int N_MAX = 104;   // variables
constexpr int M_MAX = 184;   // constraint rows
constexpr int TN = 2;        // n-tiles a warp: ceil(N_MAX / 8 / WARPS)
constexpr int TM = 3;        // m-tiles a warp: ceil(M_MAX / 8 / WARPS)

inline int pad8(int v) { return (v + 7) & ~7; }
// A's and the staging tiles' row pitch: 8 or 24 mod 32
inline int row_pitch(int k8) { return ((k8 >> 3) & 1) ? k8 : k8 + 8; }
inline int kinv_pitch(int n8) { return n8 + 4; }
// the bounds' row pitch: 16 mod 32
inline int bound_pitch(int m8) { return 2 * m8 + ((2 * m8) % 32 == 0 ? 16 : 0); }

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  // jnp.clip / torch.clamp semantics: NaN passes through
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// NaN as the quiet NaN 0x7fc00000, which tf32() keeps a NaN: the card's own
// NaN, 0x7fffffff, would carry into the sign bit there and come out -0, and
// a NaN lane would then leave the products finite. Every lane operand passes
// through store_tile, which applies this.
__device__ __forceinline__ float quiet(float v) {
  return v != v ? __uint_as_float(0x7fc00000u) : v;
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, the low 13 mantissa bits zeroed), by two integer operations:
// cvt runs at a quarter of their rate. Exact for finite x, infinities and
// the quiet NaN; other NaNs may lose their NaN-ness (see quiet())
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the lane operand: x = hi + lo + O(2^-22 |x|), both rounded to nearest
__device__ __forceinline__ void split2(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// the constant operand: x = hi + mid + lo exactly, by truncation to TF32
// (11 + 11 + 2 significant bits; each difference is exact)
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  const float r = x - __uint_as_float(hi);
  mid = __float_as_uint(r) & 0xffffe000u;
  lo = __float_as_uint(r - __uint_as_float(mid));
}

// p, a tensor-core result truncated toward zero, moved by half its ulp away
// from zero: the truncation's error becomes unbiased, as a rounding's is
// (a zero moves to +-2^-126)
__device__ __forceinline__ float unbias(float p) {
  const uint32_t e = max(__float_as_uint(p) & 0x7f800000u, 25u << 23);
  return p + __uint_as_float((__float_as_uint(p) & 0x80000000u) | (e - (24u << 23)));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, FP32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                     uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// stage `floats` (a multiple of 4) floats from global to shared, 16 bytes a copy
__device__ __forceinline__ void stage(float* dst, const float* src, int floats) {
  for (int e = threadIdx.x * 4; e < floats; e += THREADS * 4) cp_async16(dst + e, src + e);
}

// One k-step of the product for the warp's tiles T0 .. T0+NT-1, added to
// acc. The k-step's reduction slots are ordered so that A-fragment slot tig
// holds column k0 + 2 tig and slot tig + 4 column k0 + 2 tig + 1 (B's rows
// follow), so a thread reads its lane operand as one 8-byte load a row. The
// lane operand is split in two TF32 pieces (ah, al), the constant in three
// (bh, bm, bl, exactly), and the five products above 2^-24 of the whole are
// formed in three accumulators: the 2^-22 terms (ah*bl, al*bm), the 2^-11
// terms (ah*bm, al*bh) and the largest, ah*bh, alone. The tensor cores
// truncate their sums toward zero; a bias of half an ulp on the large
// partial, k-step after k-step, drifted the ladder several times further
// from the plain version than float32's own round-off, so that partial is
// unbiased before the three are added to acc in FP32.
template <int NT, bool PAIR, int T0, int TT, class Addr>
__device__ __forceinline__ void k_step(float (&acc)[TT][2][4], const float* s0, int pv,
                                       const float* Bm, int k0, Addr addr) {
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // lane g + 8 h: a[h] at column 2 tig, a[h + 2] at + 1
      const float2 v =
          *reinterpret_cast<const float2*>(s0 + (16 * mt + 8 * h) * pv + k0);
      split2(v.x, ah[mt][h], al[mt][h]);
      split2(v.y, ah[mt][h + 2], al[mt][h + 2]);
    }
  uint32_t bh[NT][2], bm[NT][2], bl[NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    int o0, o1;
    addr(T0 + t, k0, o0, o1);
    float b0, b1;
    if (PAIR) {  // (k, k + 1) adjacent in a row: one 8-byte load
      const float2 b = *reinterpret_cast<const float2*>(Bm + o0);
      b0 = b.x;
      b1 = b.y;
    } else {
      b0 = Bm[o0];
      b1 = Bm[o1];
    }
    split3(b0, bh[t][0], bm[t][0], bl[t][0]);
    split3(b1, bh[t][1], bm[t][1], bl[t][1]);
  }
  float ps[NT][2][4], pm[NT][2][4], pb[NT][2][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      mma0(ps[t][mt], ah[mt], bl[t][0], bl[t][1]);
      mma0(pm[t][mt], ah[mt], bm[t][0], bm[t][1]);
      mma0(pb[t][mt], ah[mt], bh[t][0], bh[t][1]);
    }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      mma(ps[t][mt], al[mt], bm[t][0], bm[t][1]);
      mma(pm[t][mt], al[mt], bh[t][0], bh[t][1]);
    }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[T0 + t][mt][e] += (ps[t][mt][e] + pm[t][mt][e]) + unbias(pb[t][mt][e]);
}

template <int TT>
__device__ __forceinline__ void zero(float (&acc)[TT][2][4]) {
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][mt][e] = 0.f;
}

// acc[t] = (lane operand, 32 x 8*ksteps, from staging S of pitch pv) x
// (constant B tile t) for the warp's first NT of its TT tile slots, dense.
// `addr(t, k, o0, o1)` gives the shared-memory offsets of this thread's B
// elements (k + 2 tig, col g) and (k + 2 tig + 1, col g) in Bm.
template <int NT, bool PAIR, int TT, class Addr>
__device__ __forceinline__ void product_n(float (&acc)[TT][2][4], const float* s0, int pv,
                                          const float* Bm, int ksteps, Addr addr) {
  for (int ks = 0; ks < ksteps; ++ks) k_step<NT, PAIR, 0>(acc, s0, pv, Bm, 8 * ks, addr);
}

// the dense product for a warp's cnt (<= NT) tiles: one branch-free
// instantiation per tile count, chosen once per warp
template <bool PAIR, int NT, class Addr>
__device__ __forceinline__ void lane_product(float (&acc)[NT][2][4], const float* S, int pv,
                                             const float* Bm, int ksteps, int cnt, int g,
                                             int tig, Addr addr) {
  const float* s0 = S + g * pv + 2 * tig;
  zero(acc);
  if (cnt == NT) {
    product_n<NT, PAIR>(acc, s0, pv, Bm, ksteps, addr);
  } else if (NT > 1 && cnt == NT - 1) {
    product_n<(NT > 1 ? NT - 1 : 1), PAIR>(acc, s0, pv, Bm, ksteps, addr);
  } else if (NT > 2 && cnt == NT - 2) {
    product_n<(NT > 2 ? NT - 2 : 1), PAIR>(acc, s0, pv, Bm, ksteps, addr);
  }
}

// tile T of a block-sparse product: only the k-steps where its 8 x 8 block
// of the constant is not all zero, listed at list[off[tile] .. off[tile + 1])
template <bool PAIR, int T, int NT, class Addr>
__device__ __forceinline__ void sparse_tile(float (&acc)[NT][2][4], const float* s0, int pv,
                                            const float* Bm, const int* off, int warp,
                                            Addr addr) {
  const int tile = warp + WARPS * T;
  for (int i = off[tile]; i < off[tile + 1]; ++i)
    k_step<1, PAIR, T>(acc, s0, pv, Bm, 8 * off[i], addr);
}

// the product with a block-sparse constant (A in A^T v and A x)
template <bool PAIR, int NT, class Addr>
__device__ __forceinline__ void sparse_product(float (&acc)[NT][2][4], const float* S, int pv,
                                               const float* Bm, const int* off, int cnt,
                                               int warp, int g, int tig, Addr addr) {
  static_assert(NT <= 3, "tiles a warp");
  const float* s0 = S + g * pv + 2 * tig;
  zero(acc);
  if (cnt > 0) sparse_tile<PAIR, 0>(acc, s0, pv, Bm, off, warp, addr);
  if (NT > 1 && cnt > 1) sparse_tile<PAIR, (NT > 1 ? 1 : 0)>(acc, s0, pv, Bm, off, warp, addr);
  if (NT > 2 && cnt > 2) sparse_tile<PAIR, (NT > 2 ? 2 : 0)>(acc, s0, pv, Bm, off, warp, addr);
}

// store accumulator-shaped values of tile `tile` (columns 8 * tile + 2 * tig
// and + 1; lanes g and g + 8 of both 16-lane halves) into a staging tile of
// pitch pv: the lane operand of the next product, which this thread reads
// back at the same place
__device__ __forceinline__ void store_tile(float* S, int pv, int tile, int g, int tig,
                                           const float (&v)[2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(S + (16 * mt + g + 8 * h) * pv + 8 * tile + 2 * tig) =
          make_float2(quiet(v[mt][2 * h]), quiet(v[mt][2 * h + 1]));
}

__global__ void __launch_bounds__(THREADS, 1)
qp_admm_kernel(const float* __restrict__ A_pad, const float* __restrict__ KT_pad,
               const float* __restrict__ rho_all, const float* __restrict__ D,
               const float* __restrict__ E, const float* __restrict__ q,
               const float* __restrict__ l, const float* __restrict__ u,
               const float* __restrict__ x0, const float* __restrict__ z0,
               const float* __restrict__ y0, const int* __restrict__ blk, int blk_len,
               float* __restrict__ x_out, float* __restrict__ xs_out,
               float* __restrict__ z_out, float* __restrict__ y_out, int B, int n, int m,
               int n8, int m8, int pa, int pk, int pvm, int pvn, int pl, int n_phases,
               int iters, float c, float sigma, float alpha) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);   // [m8][pa]
  float* sK = sA + m8 * pa;                      // [n8][pk], the phase's Kinv^T
  float* sL = sK + n8 * pk;                      // [32][pl]  ls, us
  float* sV = sL + LANES * pl;                   // [32][pvm] rho*z - y
  float* sR = sV + LANES * pvm;                  // [32][pvn] rhs
  float* sX = sR + LANES * pvn;                  // [32][pvn] x
  int* sBlk = reinterpret_cast<int*>(sX + LANES * pvn);  // A's nonzero 8 x 8 blocks

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int b0 = blockIdx.x * LANES;
  const int kn = n8 >> 3, km = m8 >> 3;                // 8-wide tiles
  const int cnt_n = warp < kn ? (kn - warp + WARPS - 1) / WARPS : 0;
  const int cnt_m = warp < km ? (km - warp + WARPS - 1) / WARPS : 0;
  const int kt_floats = n8 * pk;
  const float oma = 1.0f - alpha;

  // A lands while the lane inputs load
  stage(sA, A_pad, m8 * pa);
  cp_commit();
  for (int e = threadIdx.x; e < blk_len; e += THREADS) sBlk[e] = blk[e];

  // per-entry state of the accumulator fragments this thread owns: entry
  // (t, mt, e) is lane 16*mt + g + 8*(e >> 1), column 8*(warp + 8*t) + 2*tig + (e & 1).
  // ls, us sit in shared memory as {ls, ls, us, us} of the entry pair (e, e + 1).
  float xr[TN][2][4], qs[TN][2][4];
  float zr[TM][2][4], yr[TM][2][4], rho[TM][2], rinv[TM][2];
#pragma unroll
  for (int t = 0; t < TN; ++t)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = b0 + 16 * mt + g + 8 * (e >> 1);
        const int j = 8 * (warp + WARPS * t) + 2 * tig + (e & 1);
        const bool ok = t < cnt_n && b < B && j < n;
        qs[t][mt][e] = ok ? c * (D[j] * q[(size_t)b * n + j]) : 0.f;
        xr[t][mt][e] = ok ? x0[(size_t)b * n + j] : 0.f;
      }
#pragma unroll
  for (int t = 0; t < TM; ++t)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float lo[2], hi[2];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int e = 2 * h + f;
          const int b = b0 + 16 * mt + g + 8 * h;
          const int i = 8 * (warp + WARPS * t) + 2 * tig + f;
          const bool ok = t < cnt_m && b < B && i < m;
          lo[f] = ok ? E[i] * l[(size_t)b * m + i] : 0.f;
          hi[f] = ok ? E[i] * u[(size_t)b * m + i] : 0.f;
          zr[t][mt][e] = clip(ok ? z0[(size_t)b * m + i] : 0.f, lo[f], hi[f]);
          yr[t][mt][e] = ok ? y0[(size_t)b * m + i] : 0.f;
        }
        if (t < cnt_m)
          *reinterpret_cast<float4*>(sL + (16 * mt + g + 8 * h) * pl +
                                     16 * (warp + WARPS * t) + 4 * tig) =
              make_float4(lo[0], lo[1], hi[0], hi[1]);
      }

  // B-fragment offsets, rows k + 2 * tig and + 1 (the slot order of
  // k_step): A^T v reads A by (k = i, col = j), Kinv rhs reads Kinv^T by
  // (k, col = j), A x reads A by (k = j, col = i), the pair adjacent
  auto addr_at = [=](int t, int k0, int& o0, int& o1) {
    o0 = (k0 + 2 * tig) * pa + 8 * (warp + WARPS * t) + g;
    o1 = o0 + pa;
  };
  auto addr_k = [=](int t, int k0, int& o0, int& o1) {
    o0 = (k0 + 2 * tig) * pk + 8 * (warp + WARPS * t) + g;
    o1 = o0 + pk;
  };
  auto addr_ax = [=](int t, int k0, int& o0, int& o1) {
    o0 = (8 * (warp + WARPS * t) + g) * pa + k0 + 2 * tig;
    o1 = o0 + 1;
  };

  float acc_n[TN][2][4], acc_m[TM][2][4];
  for (int ph = 0; ph < n_phases; ++ph) {
    // this phase's Kinv^T (the previous phase's readers are past its last barrier)
    stage(sK, KT_pad + (size_t)ph * kt_floats, kt_floats);
    cp_commit();
    // this phase's rho on the owned rows (1 on padded rows), and v
#pragma unroll
    for (int t = 0; t < TM; ++t) {
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int i = 8 * (warp + WARPS * t) + 2 * tig + f;
        rho[t][f] = (t < cnt_m && i < m) ? rho_all[(size_t)ph * m + i] : 1.f;
        rinv[t][f] = 1.f / rho[t][f];
      }
      if (t < cnt_m) {
        float v[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[mt][e] = rho[t][e & 1] * zr[t][mt][e] - yr[t][mt][e];
        store_tile(sV, pvm, warp + WARPS * t, g, tig, v);
      }
    }
    cp_wait_all();
    __syncthreads();

    for (int it = 0; it < iters; ++it) {
      // rhs = sigma*x - qs + A^T v
      sparse_product<false>(acc_n, sV, pvm, sA, sBlk, cnt_n, warp, g, tig, addr_at);
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        if (t < cnt_n) {
          float r[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              r[mt][e] = sigma * xr[t][mt][e] - qs[t][mt][e] + acc_n[t][mt][e];
          store_tile(sR, pvn, warp + WARPS * t, g, tig, r);
        }
      }
      __syncthreads();
      // x = Kinv rhs
      lane_product<false>(acc_n, sR, pvn, sK, kn, cnt_n, g, tig, addr_k);
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        if (t < cnt_n) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) xr[t][mt][e] = acc_n[t][mt][e];
          store_tile(sX, pvn, warp + WARPS * t, g, tig, xr[t]);
        }
      }
      __syncthreads();
      // A x, then over-relaxation, projection, dual update and the next v
      sparse_product<true>(acc_m, sX, pvn, sA, sBlk + kn + 1, cnt_m, warp, g, tig,
                           addr_ax);
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        if (t < cnt_m) {
          float v[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4 lu = *reinterpret_cast<const float4*>(
                  sL + (16 * mt + g + 8 * h) * pl + 16 * (warp + WARPS * t) + 4 * tig);
              const float lo[2] = {lu.x, lu.y}, hi[2] = {lu.z, lu.w};
#pragma unroll
              for (int f = 0; f < 2; ++f) {
                const int e = 2 * h + f;
                const float rh = rho[t][f];
                const float z = zr[t][mt][e], y = yr[t][mt][e];
                const float ax_rel = alpha * acc_m[t][mt][e] + oma * z;
                const float zn = clip(ax_rel + y * rinv[t][f], lo[f], hi[f]);
                const float yn = y + rh * (ax_rel - zn);
                zr[t][mt][e] = zn;
                yr[t][mt][e] = yn;
                v[mt][e] = rh * zn - yn;
              }
            }
          store_tile(sV, pvm, warp + WARPS * t, g, tig, v);
        }
      }
      __syncthreads();
    }
  }
  cp_wait_all();

#pragma unroll
  for (int t = 0; t < TN; ++t)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = b0 + 16 * mt + g + 8 * (e >> 1);
        const int j = 8 * (warp + WARPS * t) + 2 * tig + (e & 1);
        if (t < cnt_n && b < B && j < n) {
          xs_out[(size_t)b * n + j] = xr[t][mt][e];
          x_out[(size_t)b * n + j] = D[j] * xr[t][mt][e];
        }
      }
#pragma unroll
  for (int t = 0; t < TM; ++t)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = b0 + 16 * mt + g + 8 * (e >> 1);
        const int i = 8 * (warp + WARPS * t) + 2 * tig + (e & 1);
        if (t < cnt_m && b < B && i < m) {
          z_out[(size_t)b * m + i] = zr[t][mt][e];
          y_out[(size_t)b * m + i] = yr[t][mt][e];
        }
      }
}

}  // namespace

// Shared-memory bytes of one block for an (n, m) QP (the layout above).
extern "C" int qp_admm_smem_bytes(int n, int m) {
  const int n8 = pad8(n), m8 = pad8(m);
  const int kn = n8 / 8, km = m8 / 8;
  return (int)sizeof(float) *
         (m8 * row_pitch(n8) + n8 * kinv_pitch(n8) + LANES * bound_pitch(m8) +
          LANES * row_pitch(m8) + 2 * LANES * row_pitch(n8) + kn + km + 2 + 2 * kn * km);
}

// A_pad (m8, pa), KT_pad (n_phases, n8, pk) and the block lists blk, from
// ops/qp.py kernel_constants; rho (n_phases, m), D (n,), E (m,); lanes
// (B, n) / (B, m).
extern "C" int qp_admm_warm(const float* A_pad, const float* KT_pad, const float* rho,
                            const float* D, const float* E, const float* q,
                            const float* l, const float* u, const float* x0,
                            const float* z0, const float* y0, const int* blk,
                            int blk_len, float* x_out, float* xs_out, float* z_out,
                            float* y_out, int B, int n, int m, int pa, int n_phases,
                            int iters, float c, float sigma, float alpha, void* stream) {
  const int n8 = pad8(n), m8 = pad8(m);
  const int kn = n8 / 8, km = m8 / 8;
  if (n < 1 || m < 1 || n > N_MAX || m > M_MAX || pa != row_pitch(n8) ||
      blk_len < kn + km + 2 || blk_len > kn + km + 2 + 2 * kn * km || n_phases < 0 ||
      iters < 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int bytes = qp_admm_smem_bytes(n, m);
  cudaError_t err = cudaFuncSetAttribute(
      qp_admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + LANES - 1) / LANES;
  qp_admm_kernel<<<blocks, THREADS, bytes, (cudaStream_t)stream>>>(
      A_pad, KT_pad, rho, D, E, q, l, u, x0, z0, y0, blk, blk_len, x_out, xs_out, z_out,
      y_out, B, n, m, n8, m8, pa, kinv_pitch(n8), row_pitch(m8), row_pitch(n8),
      bound_pitch(m8), n_phases, iters, c, sigma, alpha);
  return (int)cudaGetLastError();
}
