// Path-DP transition-edge obstacle costs, (B, cols-1, rows*rows).
//
// Replaces: emplanner_carla_tpu/ops/path_obs_pallas.py
// transition_obstacle_costs_batched (dispatched at planner/path_dp.py:125).
// Per lane, obstacle slot k (<= dp_top_m) and candidate edge c (2): the edge
// index cn = floor((r + safe)/h) - 1 + c with r = obs_s - plan_start_s; for a
// valid candidate, m smoothstep samples against the (rows x rows) lateral
// table give d^2 = (obs_s - s_q)^2 + (obs_l - l_q)^2. d^2 <= danger^2 marks a
// collision (w_collision), danger^2 < d^2 < safe^2 adds num/d^2. The
// (slot, candidate) cost lands in column cn - 1.
//
// What bounds it on the H100: float32 arithmetic once obstacles reach the
// DP window: every (lane, slot, candidate) inside it costs rows^2 = 144
// edges x m = 10 samples (~23.5k candidates at B = 4096 on config 3's third
// cycle, ~0.4 GFLOP with an IEEE division per in-band sample); otherwise the
// write of the (B, 5, 144) float32 output (11.8 MB, 3.5 us at 3.35 TB/s)
// and the launch.
//
// Design: one thread per (lane, lateral edge rr) item, as before, so that
// 590k threads keep the card busy, consecutive threads on consecutive rr so
// that the output stores coalesce; but what does not depend on rr is done
// once per warp: its threads stage, per (batch lane, slot, candidate) that
// its 32 items touch (two batch lanes at 12 rows), the window test, the hit
// column and the m
// longitudinal terms ds^2 = (obs_s - (base + u_q h))^2 in shared memory
// (__syncwarp, no block barrier). A lane with no candidate in its window
// writes its zeros at once. Otherwise the thread keeps its edge's lateral
// table l_q[rr] in registers and, per slot with a candidate in the window,
// forms dl^2 = (obs_l - l_q)^2 once for both candidates; per candidate
// d^2 = ds^2 + dl^2 for every sample, the collision flag and the band
// samples' quotients; the (slot, candidate) cost is added to its column of
// the thread's own accumulator row in shared memory, indexed directly. The
// fold order is the plain PyTorch version's: slot outer, candidate inner,
// samples ascending, and every operation is a separately rounded IEEE
// float32 op (__fmul_rn/__fadd_rn/__fdiv_rn, and the file builds with
// -fmad=false), so kernel and plain version agree bit for bit. Costs are
// added only to the hit column, and a sample outside the band adds nothing
// to the band sum: the plain version adds exact zeros there, which change
// nothing.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_COLS = 16;
constexpr int THREADS = 256;   // threads a block at most, one (lane, rr) item each
constexpr size_t SMEM_MAX = 232448;   // shared memory a block can use

struct ObsArgs {
  const float* obs_s;
  const float* obs_l;
  const bool* obs_valid;
  const float* plan_start_s;
  const float* tl;   // (m, RR) lateral table
  const float* uh;   // (m,) sample offsets u_q h
  float* out;        // (B, ncols, RR)
  int B, K, RR, ncols, m;
  int lanes;         // lanes a warp's 32 items can touch
  float h, span, safe, danger2, safe2, num, w_coll;
};

// the longitudinal terms of a candidate start 16-byte aligned
__host__ __device__ inline int padded(int m) { return (m + 3) & ~3; }

// floats of one warp's staging area: per (lane, slot) obs_l, per (lane,
// slot, candidate) the hit column (an int) and the m longitudinal terms,
// per lane whether any candidate is in its window (an int)
__host__ __device__ inline int warp_floats(int lanes, int K, int m) {
  return padded(lanes * K * (1 + 2 + 2 * padded(m)) + lanes);
}

// one (slot, candidate): its m samples' collision flag and band sum; the
// lateral terms from dl2 (M > 0) or formed here from obs_l o and row rr. A
// squared distance is >= +0 or NaN, so its bits order as unsigned integers
// do (NaN above every number): d2 <= danger2 and danger2 < d2 < safe2 are
// integer compares of the bits. A NaN or +inf d2 is neither (its bits lie
// above safe2's), so only finite band samples reach the fmaxf below, as only
// they reach the plain version's where(band, ...): a NaN obstacle costs 0. At the main path's m the squared distances
// come first and the quotients (an IEEE division each) only for the samples
// in the band.
template <int M>
__device__ __forceinline__ float candidate_cost(const float* ds2, const float* dl2, float o,
                                                int rr, int m, const ObsArgs& a) {
  const unsigned lo = __float_as_uint(a.danger2);
  // the bits of (danger2, safe2) counted from lo + 1; none if safe2 <= danger2
  const unsigned width = a.safe2 > a.danger2 ? __float_as_uint(a.safe2) - lo - 1u : 0u;
  bool coll = false;
  float bc = 0.f;
  if (M) {
    float d2s[M ? M : 1];
    const float4* d4 = reinterpret_cast<const float4*>(ds2);
#pragma unroll
    for (int v = 0; v < (M + 3) / 4; ++v) {
      const float4 x = d4[v];
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * v + u < M) d2s[4 * v + u] = xs[u];
    }
    unsigned band = 0;
#pragma unroll
    for (int q = 0; q < (M ? M : 1); ++q) {
      d2s[q] = __fadd_rn(d2s[q], dl2[q]);
      const unsigned bits = __float_as_uint(d2s[q]);
      coll = coll || bits <= lo;
      if (bits - lo - 1u < width) band |= 1u << q;
    }
#pragma unroll
    for (int q = 0; q < (M ? M : 1); ++q)
      if ((band >> q) & 1u) bc = __fadd_rn(bc, __fdiv_rn(a.num, fmaxf(d2s[q], 1e-6f)));
  } else {
    for (int q = 0; q < m; ++q) {
      const float dl = __fsub_rn(o, __ldg(a.tl + q * a.RR + rr));
      const float d2 = __fadd_rn(ds2[q], __fmul_rn(dl, dl));
      const unsigned bits = __float_as_uint(d2);
      coll = coll || bits <= lo;
      if (bits - lo - 1u < width) bc = __fadd_rn(bc, __fdiv_rn(a.num, fmaxf(d2, 1e-6f)));
    }
  }
  return __fadd_rn(coll ? a.w_coll : 0.f, bc);
}

// M: samples an edge (0: read at run time)
template <int M>
__global__ void __launch_bounds__(THREADS, 5) path_obs_kernel(ObsArgs a) {
  const int m = M ? M : a.m;
  const int K = a.K, RR = a.RR, ncols = a.ncols, lanes = a.lanes;
  const int tid = threadIdx.x, lid = tid & 31, warp = tid >> 5;
  const int n_items = a.B * RR;
  const int nthreads = blockDim.x;
  const int e0 = blockIdx.x * nthreads + warp * 32;   // the warp's first item
  if (e0 >= n_items) return;
  const int e = e0 + lid;
  const int b0 = e0 / RR;
  extern __shared__ float smem[];
  float* acc = smem;                                           // [ncols][nthreads]
  const int mp = padded(m);
  float* ds2 = acc + ncols * nthreads + warp * warp_floats(lanes, K, m);  // [lanes][K][2][mp]
  float* ol = ds2 + lanes * K * 2 * mp;                        // [lanes][K]
  int* col = reinterpret_cast<int*>(ol + lanes * K);           // [lanes][K][2], -1: adds nothing

  // ---- the warp stages each (lane, slot, candidate) it touches, once ----
  int* lane_live = col + lanes * K * 2;                        // [lanes] any candidate
  for (int l = lid; l < lanes; l += 32) lane_live[l] = 0;
  __syncwarp();
  for (int s = lid; s < lanes * K; s += 32) {
    const int l = s / K, k = s - l * K, b = b0 + l;
    int* cl = col + 2 * s;
    cl[0] = cl[1] = -1;
    if (b >= a.B) continue;
    // all four loads issued together
    const bool valid = a.obs_valid[b * K + k];
    const float ps = __ldg(a.plan_start_s + b);
    const float os = __ldg(a.obs_s + b * K + k);
    ol[s] = __ldg(a.obs_l + b * K + k);
    if (!valid) continue;
    const float r = __fsub_rn(os, ps);
    const float n1 = floorf(__fdiv_rn(__fadd_rn(r, a.safe), a.h));
    const float n_lo = __fdiv_rn(__fsub_rn(__fsub_rn(r, a.safe), a.span), a.h);
    for (int c = 0; c < 2; ++c) {
      const float cn = c == 0 ? __fsub_rn(n1, 1.0f) : n1;
      if (!(cn >= 1.0f && cn <= (float)ncols && cn >= n_lo)) continue;
      cl[c] = (int)cn - 1;
      lane_live[l] = 1;
      const float base = __fadd_rn(ps, __fmul_rn(cn, a.h));
      float* d = ds2 + (2 * s + c) * mp;
      for (int q = 0; q < m; ++q) {
        const float ds = __fsub_rn(os, __fadd_rn(base, a.uh[q]));
        d[q] = __fmul_rn(ds, ds);
      }
    }
  }
  __syncwarp();
  if (e >= n_items) return;

  // ---- this thread's item (lane b, rr): slot outer, candidate inner ----
  const int b = e / RR, l = b - b0;
  const int rr = e - b * RR;
  float* o = a.out + (size_t)b * ncols * RR + rr;
  if (!lane_live[l]) {
    for (int cc = 0; cc < ncols; ++cc) o[(size_t)cc * RR] = 0.f;
    return;
  }
  float* my = acc + tid;
  for (int cc = 0; cc < ncols; ++cc) my[cc * nthreads] = 0.f;
  float dl2[M ? M : 1], tlr[M ? M : 1];
  if (M) {
#pragma unroll
    for (int q = 0; q < (M ? M : 1); ++q) tlr[q] = __ldg(a.tl + q * RR + rr);
  }
  for (int k = 0; k < K; ++k) {
    const int* cl = col + 2 * (l * K + k);
    if (cl[0] < 0 && cl[1] < 0) continue;
    const float o = ol[l * K + k];
    if (M) {
#pragma unroll
      for (int q = 0; q < (M ? M : 1); ++q) {
        const float dl = __fsub_rn(o, tlr[q]);
        dl2[q] = __fmul_rn(dl, dl);
      }
    }
    for (int c = 0; c < 2; ++c) {
      if (cl[c] < 0) continue;
      const float po = candidate_cost<M>(ds2 + (2 * (l * K + k) + c) * mp, dl2, o, rr, m, a);
      my[cl[c] * nthreads] = __fadd_rn(my[cl[c] * nthreads], po);
    }
  }
  for (int cc = 0; cc < ncols; ++cc) o[(size_t)cc * RR] = my[cc * nthreads];
}

template <int M>
cudaError_t launch(const ObsArgs& a, cudaStream_t stream) {
  // 8 warps a block, fewer where a warp's staging area is large (few rows,
  // many slots or samples)
  const size_t warp_bytes = (size_t)(a.ncols * 32 + warp_floats(a.lanes, a.K, a.m)) * 4;
  const int warps = (int)(SMEM_MAX / warp_bytes < THREADS / 32 ? SMEM_MAX / warp_bytes
                                                                : THREADS / 32);
  if (warps < 1) return cudaErrorInvalidValue;
  const int threads = 32 * warps;
  const size_t bytes = warps * warp_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      path_obs_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (a.B * a.RR + threads - 1) / threads;
  path_obs_kernel<M><<<blocks, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int path_obs_costs(const float* obs_s, const float* obs_l,
                              const bool* obs_valid, const float* plan_start_s,
                              const float* tl, const float* uh, float* out, int B,
                              int K, int RR, int ncols, int m, float h, float span,
                              float safe, float danger2, float safe2, float num,
                              float w_coll, void* stream) {
  if (ncols > MAX_COLS || (long long)B * RR > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  // 32 consecutive items touch at most 32 / RR + 2 lanes (2 at 12 rows)
  const int lanes = 32 / RR + 2 < B ? 32 / RR + 2 : B;
  ObsArgs a{obs_s, obs_l, obs_valid, plan_start_s, tl, uh, out, B, K, RR, ncols, m, lanes,
            h, span, safe, danger2, safe2, num, w_coll};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(m == 10 ? launch<10>(a, s) : launch<0>(a, s));
}
