// S-T speed DP over the (n_s stations x n_t columns) lattice with the
// obstacle edge costs computed in the kernel from the raw ST segments, the
// terminal choice and the backtrack, for a batch of lanes.
//
// Replaces: emplanner_carla_tpu/ops/speed_dp_pallas.py speed_dp_recursion
// (:61, the pallas_call at :306) and its wrapper speed_dp_batched (:369,
// termination + backtrack). Semantics: planner/speed_planner._speed_dp_xla,
// whose batch-first transcription is the port's _speed_dp_torch.
// Per lane: the start column's cost (start-edge obstacle samples, reference
// speed, acceleration from the plan-start speed); for each of the n_t - 1
// transitions and every (predecessor k, station j) edge the cost
//   cost_prev[k] + ((obs + ref[k][j]) + forbidden[k][j]) + acc
// with obs = (A[k] + B[j]) + C[k][j] from the m-2 interior samples and the
// two endpoint pieces of every live segment, a running first minimum over
// ascending k (strict <); the terminal as the best of the right column and
// the s_max row (<= keeps the later column); the backtrack to stations.
//
// What bounds it on the H100: float32 operations. Per lane and transition
// the recursion does ~8 operations on each of the n_s^2 = 1600 edges, and a
// live (lane, column, segment) adds ~25 operations per interior sample on
// 3 x 1600 points; the inputs are 5 floats per segment and the outputs
// n_t + 1 numbers a lane, so bytes are negligible. The 15 columns of a lane
// are serial, but the stations of a column are independent.
//
// Design: one thread per (lane, station j), 8 lanes x n_s threads a block.
// A lane's cost and arrival-speed rows sit in shared memory, double
// buffered per column; the endpoint piece A (one evaluation per station k)
// is computed once per column into shared memory and the per-(sample,
// segment) time terms are hoisted there too; each thread loops k in
// registers. The predecessor stations stay in shared memory (one byte each,
// 15 x 40 a lane), and one thread per lane chooses the terminal and
// backtracks, so only s, valid and end_index reach device memory. No
// batch-in-lanes layout and no liveness packing as on the TPU: the same
// exact time-gap gate (a pure-time gap >= obs_danger_dist makes every
// sample cost exactly 0) skips a lane's obstacle work per column and
// segment. The file builds with -fmad=false and follows the plain
// version's association order and IEEE quotients, so the two agree bit for
// bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int LPB = 8;        // lanes per block
constexpr int KMAX = 8;       // segment slots
constexpr int NSMAX = 64;     // stations
constexpr int NTMAX = 32;     // columns
constexpr int QMAX = 8;       // interior samples per edge

enum {
  F_DT, F_W_ACC, F_PEN_W, F_A_LO, F_A_HI, F_W_OBS, F_COLL, F_DANG, F_LOG_W,
  F_BAND_C, F_BIG, F_COUNT
};

struct DPArgs {
  const float* seg;     // (B, 5, K) s_in, s_out, t_in, t_out, valid (0/1)
  const float* v0;      // (B,) plan-start speed
  const float* sg;      // (n_s,) stations, ascending
  const float* dv;      // (n_s, n_s) edge speed (s_j - s_k) / dt, [k][j]
  const float* ref_tr;  // (n_s, n_s) edge reference-speed cost, [k][j]
  const float* v0e;     // (n_s,) start-edge speed s_j / t_0
  const float* ref0;    // (n_s,) start-edge reference-speed cost
  float* s_out;         // (B, n_t)
  bool* valid_out;      // (B, n_t)
  int* end_out;         // (B,)
  int B, K, n_s, n_t, m;
  float f[F_COUNT];
};

// per-lane shared state
struct Lane {
  float cost[2][NSMAX];
  float sdot[2][NSMAX];
  float costA[NSMAX];
  float top[NTMAX];
  float seg[5][KMAX];
  float v3s[KMAX], v3t[KMAX], nrm[KMAX], inv[KMAX];
  float cq[QMAX][KMAX][4];   // interior-sample time terms c1..c4
  int live[KMAX];
  int any_live;
  unsigned char pred[NTMAX - 1][NSMAX];
};

__device__ __forceinline__ float min_nan(float a, float b) {
  // torch.minimum: NaN propagates
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}

// _collision_cost: w_obs below coll, exp band below danger, exactly 0 beyond
__device__ __forceinline__ float cost_of(float d, const float* F) {
  if (d < F[F_COLL]) return F[F_W_OBS];
  if (d < F[F_DANG]) return expf(F[F_LOG_W] * (F[F_BAND_C] - d));
  return 0.f;
}

// _seg_distance for one sample point against one segment
__device__ __forceinline__ float seg_dist(float s, float t, float si, float so,
                                          float ti, float to) {
  const float v1s = si - s, v1t = ti - t, v2s = so - s, v2t = to - t;
  const float v3s = v2s - v1s, v3t = v2t - v1t;
  const float d1 = v1s * v1s + v1t * v1t;
  const float d2 = v2s * v2s + v2t * v2t;
  const float nrm = (v3s * v3s + v3t * v3t) + 1e-24f;
  const float cross = v1s * v3t - v1t * v3s;
  const float dperp = cross * cross * (1.f / nrm);
  const float p1 = v1s * v3s + v1t * v3t;
  const float p2 = v2s * v3s + v2t * v3t;
  const bool endpoint = (p1 > 0.f) == (p2 > 0.f);
  return sqrtf(endpoint ? min_nan(d1, d2) : dperp);
}

__device__ __forceinline__ float acc_cost(float a, const float* F) {
  const float w = (a < F[F_A_HI] && a > F[F_A_LO]) ? F[F_W_ACC] : F[F_PEN_W];
  return w * (a * a);
}

__global__ void speed_dp_kernel(DPArgs a) {
  extern __shared__ float4 smem4[];
  float* s_dv = reinterpret_cast<float*>(smem4);   // [n_s][n_s]
  const int n_s = a.n_s, n_t = a.n_t, K = a.K, m = a.m;
  float* s_ref = s_dv + n_s * n_s;                  // [n_s][n_s]
  float* s_sg = s_ref + n_s * n_s;                  // [n_s]
  Lane* lanes = reinterpret_cast<Lane*>(s_sg + ((n_s + 3) & ~3));
  const float* F = a.f;

  const int tid = threadIdx.x;
  const int li = tid / n_s;          // lane within the block
  const int j = tid - li * n_s;      // station
  const int b = blockIdx.x * LPB + li;
  const bool in_batch = b < a.B;
  Lane& L = lanes[li];

  for (int e = tid; e < n_s * n_s; e += blockDim.x) {
    s_dv[e] = a.dv[e];
    s_ref[e] = a.ref_tr[e];
  }
  for (int e = tid; e < n_s; e += blockDim.x) s_sg[e] = a.sg[e];
  if (j < 5 * K) {
    const int f = j / K, k = j - f * K;
    L.seg[f][k] = in_batch ? a.seg[((size_t)b * 5 + f) * K + k] : 0.f;
  }
  __syncthreads();

  const float dt = F[F_DT];
  const float dang = F[F_DANG];
  const float t0 = 1.0f * dt;        // t_grid[0] = (0 + 1) * dt
  const float mm1 = (float)(m - 1);
  if (j < K) {
    const float si = L.seg[0][j], so = L.seg[1][j], ti = L.seg[2][j], to = L.seg[3][j];
    const float v3s = so - si, v3t = to - ti;
    const float nrm = (v3s * v3s + v3t * v3t) + 1e-24f;
    L.v3s[j] = v3s;
    L.v3t[j] = v3t;
    L.nrm[j] = nrm;
    L.inv[j] = 1.f / nrm;
    // start-edge liveness: the samples' times lie in [0, t_0]
    L.live[j] = L.seg[4][j] > 0.5f && fmaxf(ti - t0, -to) < dang;
  }
  __syncthreads();

  // ---- column 0: start edges from the plan start ----
  const float sj = s_sg[j];
  float obs0 = 0.f;
  for (int q = 0; q < m; ++q) {
    const float fr = (float)q / mm1;
    const float s_q = sj * fr, t_q = t0 * fr;
    for (int k = 0; k < K; ++k) {
      if (!L.live[k]) continue;
      obs0 = obs0 + cost_of(seg_dist(s_q, t_q, L.seg[0][k], L.seg[1][k], L.seg[2][k],
                                     L.seg[3][k]), F);
    }
  }
  const float v0 = in_batch ? a.v0[b] : 0.f;
  const float a0 = (a.v0e[j] - v0) / t0;
  const float cost0 = (obs0 + a.ref0[j]) + acc_cost(a0, F);
  L.cost[0][j] = cost0;
  L.sdot[0][j] = a.v0e[j];
  if (j == n_s - 1) L.top[0] = cost0;
  int cur = 0;

  // ---- transitions: column c -> c + 1 ----
  const int nq = m - 2;
  for (int c = 0; c < n_t - 1; ++c) {
    const float t_start = ((float)c + 1.0f) * dt;
    const float t_end = t_start + dt;
    __syncthreads();  // previous column's rows complete; live/cq free to overwrite
    if (j < K) {
      const float gap = fmaxf(L.seg[2][j] - t_end, t_start - L.seg[3][j]);
      L.live[j] = L.seg[4][j] > 0.5f && gap < dang;
    }
    __syncthreads();
    if (j == 0) {
      int any = 0;
      for (int k = 0; k < K; ++k) any |= L.live[k];
      L.any_live = any;
    }
    if (j < nq * K) {
      // time-only terms of interior sample q for segment k
      const int q = j / K, k = j - q * K;
      const float fm = (float)(q + 1) / mm1;
      const float t_p = t_start + dt * fm;
      const float v1t = L.seg[2][k] - t_p;
      const float v2t = L.seg[3][k] - t_p;
      L.cq[q][k][0] = v1t * v1t;
      L.cq[q][k][1] = v2t * v2t;
      L.cq[q][k][2] = v1t * L.v3s[k];
      L.cq[q][k][3] = v1t * L.v3t[k];
    }
    // endpoint pieces: A at (s_j, t_start) for row k = j, B at (s_j, t_end)
    float cA = 0.f, cB = 0.f;
    for (int k = 0; k < K; ++k) {
      if (!L.live[k]) continue;
      const float si = L.seg[0][k], so = L.seg[1][k], ti = L.seg[2][k], to = L.seg[3][k];
      cA = cA + cost_of(seg_dist(sj, t_start, si, so, ti, to), F);
      cB = cB + cost_of(seg_dist(sj, t_end, si, so, ti, to), F);
    }
    L.costA[j] = cA;
    __syncthreads();

    const bool any_live = L.any_live != 0;
    const float* cost_prev = L.cost[cur];
    const float* sdot_prev = L.sdot[cur];
    float best = 0.f;
    int bk = 0;
    for (int k = 0; k < n_s; ++k) {
      const float dv = s_dv[k * n_s + j];
      const float forb = dv < 0.f ? F[F_BIG] : 0.f;
      float obs = 0.f;
      if (any_live) {
        const float sk = s_sg[k];
        float obsC = 0.f;
        for (int q = 0; q < nq; ++q) {
          const float fm = (float)(q + 1) / mm1;
          const float s_mid = sk + (sj - sk) * fm;
          for (int kk = 0; kk < K; ++kk) {
            if (!L.live[kk]) continue;
            const float v3s = L.v3s[kk], v3t = L.v3t[kk];
            const float v1s = L.seg[0][kk] - s_mid;
            const float d1 = v1s * v1s + L.cq[q][kk][0];
            const float v2s = v1s + v3s;
            const float d2 = v2s * v2s + L.cq[q][kk][1];
            const float cross = v1s * v3t - L.cq[q][kk][2];
            const float dperp = cross * cross * L.inv[kk];
            const float p1 = v1s * v3s + L.cq[q][kk][3];
            const float p2 = p1 + L.nrm[kk];
            const bool endpoint = (p1 > 0.f) == (p2 > 0.f);
            obsC = obsC + cost_of(sqrtf(endpoint ? min_nan(d1, d2) : dperp), F);
          }
        }
        obs = (L.costA[k] + cB) + obsC;
      }
      const float st = (obs + s_ref[k * n_s + j]) + forb;
      const float accel = (dv - sdot_prev[k]) / dt;
      const float total = (cost_prev[k] + st) + acc_cost(accel, F);
      if (k == 0 || total < best) {
        best = total;
        bk = k;
      }
    }
    const int nxt = cur ^ 1;
    L.cost[nxt][j] = best;
    L.sdot[nxt][j] = s_dv[bk * n_s + j];
    L.pred[c][j] = (unsigned char)bk;
    if (j == n_s - 1) L.top[c + 1] = best;
    cur = nxt;
  }
  __syncthreads();

  // ---- terminal and backtrack, one thread per lane ----
  if (j != 0 || !in_batch) return;
  const float* last = L.cost[cur];
  int best_right = 0;
  float right_cost = last[0];
  for (int k = 1; k < n_s; ++k)
    if (last[k] < right_cost) { right_cost = last[k]; best_right = k; }
  int best_top = 0;
  float top_cost = L.top[0];
  for (int c = 1; c < n_t; ++c)
    if (L.top[c] <= top_cost) { top_cost = L.top[c]; best_top = c; }  // last minimum
  const bool use_top = top_cost <= right_cost;
  const int end_col = use_top ? best_top : n_t - 1;
  int row = use_top ? n_s - 1 : best_right;
  float* so = a.s_out + (size_t)b * n_t;
  bool* vo = a.valid_out + (size_t)b * n_t;
  for (int c = n_t - 1; c >= 0; --c) {
    if (c > end_col) {
      so[c] = 0.f;
      vo[c] = false;
      continue;
    }
    so[c] = s_sg[row];
    vo[c] = true;
    if (c > 0) row = L.pred[c - 1][row];
  }
  a.end_out[b] = end_col;
}

}  // namespace

extern "C" int speed_dp(void* const* ptrs, const float* fparams, const int* iparams,
                        void* stream) {
  DPArgs a;
  a.seg = (const float*)ptrs[0];
  a.v0 = (const float*)ptrs[1];
  a.sg = (const float*)ptrs[2];
  a.dv = (const float*)ptrs[3];
  a.ref_tr = (const float*)ptrs[4];
  a.v0e = (const float*)ptrs[5];
  a.ref0 = (const float*)ptrs[6];
  a.s_out = (float*)ptrs[7];
  a.valid_out = (bool*)ptrs[8];
  a.end_out = (int*)ptrs[9];
  a.B = iparams[0];
  a.K = iparams[1];
  a.n_s = iparams[2];
  a.n_t = iparams[3];
  a.m = iparams[4];
  for (int e = 0; e < F_COUNT; ++e) a.f[e] = fparams[e];
  if (a.K < 1 || a.K > KMAX || a.n_s < 2 || a.n_s > NSMAX || a.n_t < 2 ||
      a.n_t > NTMAX || a.m < 2 || a.m - 2 > QMAX || 5 * a.K > a.n_s ||
      (a.m - 2) * a.K > a.n_s)
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0) return 0;
  const size_t bytes = (size_t)(2 * a.n_s * a.n_s + ((a.n_s + 3) & ~3)) * sizeof(float) +
                       (size_t)LPB * sizeof(Lane);
  cudaError_t err = cudaFuncSetAttribute(
      speed_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.B + LPB - 1) / LPB;
  speed_dp_kernel<<<blocks, LPB * a.n_s, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
