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
// with obs = (A[k] + B[j]) + C[k][j] from the two endpoint pieces and the
// m-2 interior samples of every live segment (C summed sample-major,
// segment-minor), a first minimum over ascending k; the terminal as the
// best of the right column and the s_max row (<= keeps the later column);
// the backtrack to stations.
//
// What bounds it on the H100: instruction issue. A lane's columns are
// serial, but 4096 lanes fill the card many times over, so once a lane's
// chain is short the launch is the instructions it issues: per transition
// ~14 on each of the n_s^2 = 1600 edges, and per interior sample inside a
// live segment's window ~35 more; the inputs are 5 floats per segment and
// the outputs n_t + 1 numbers a lane, so bytes are negligible.
//
// Design: one block a lane (the card balances the lanes, live or dead, over
// its SMs), G = 4 threads a station: n_s * G threads, a whole number of
// warps at n_s = 40, so no lane straddles a warp and every branch on a
// lane's liveness is uniform in the block. Thread t of station j's group
// owns predecessors k = t, t + G, ... and keeps their edge speeds and
// obstacle-free static costs in registers for the launch; each column reads
// (cost, arrival speed) of its k's as one float2 from the double-buffered
// row in shared memory, runs the plain rule over its slice and combines the
// group's results with two shuffles; one thread a station stores the row,
// the arrival speed dv[k*][j] and one predecessor byte, and one barrier
// ends the column. Everything that does not depend on the recursion is
// computed once, up front, by the whole block: each segment's constants, the
// live mask of every column, the interior samples' time terms, the endpoint
// pieces A and B, column 0, and the list of near edges, those with an
// interior sample inside a live segment's window, each with the bits of
// its samples that are. A live column first sums, per near edge, only those
// samples (bits ascending: sample q outer, segment inner, the plain
// version's order) into a matrix in shared memory, then runs the
// recursion with obs = (A[k] + B[j]) + C[k][j]. Warp 0 chooses the terminal
// and backtracks.
//
// The first minimum over a group. The plain rule, over ascending k, is
//   take k if k == 0 || total < best
// so a NaN total at k = 0 stays (NaN, k 0), a NaN at k > 0 is never taken,
// +inf ties keep the lower k and -0 ties +0. Each thread runs that rule over
// its own k's from (+inf, NO_K) (an empty slice), and the G partial results
// combine with __shfl_xor_sync by group_better: a NaN partial (only k 0 can
// hold one) wins, otherwise the smaller total, ties to the lower k. An empty
// or all-+inf slice loses to any real k of equal total, so it never changes
// the result; the right column's first minimum uses the same combine.
//
// Exact zeros skipped. st_gate_window (mirrored from speed_planner.py)
// gives each segment a station window [lo, hi]: the segment's s range widened
// by obs_danger_dist plus a float margin that covers the rounding of the
// distance (1e-4 of the inputs' magnitudes), or the whole line for a
// segment shorter than that margin; a sample outside it has a distance of at
// least obs_danger_dist and a cost of exactly 0, and adding 0 to a sum of
// non-negative costs changes nothing. The live mask (a pure-time gap >=
// obs_danger_dist) skips whole columns as before. The collision cost
// compares the squared distance with the least floats whose square roots
// reach obs_collision_dist and obs_danger_dist (correctly rounded sqrtf is
// monotone), so the square root runs only in the danger band.
//
// The acceleration quotient (dv - sdot) / dt is an exact product by 1/dt
// when the host finds 1/dt exactly representable (dt a power of two, as
// t_step = 0.5 is), and an IEEE division otherwise. The file builds with
// -fmad=false and keeps the plain version's association order inside each
// edge's total, so the two agree bit for bit.
//
// Instantiations: <K, m-2, n_s> = <2, 3, 40> (st_top_m 2: configs 4, 5, 7)
// and <4, 3, 40> (bench config 1), with an exact 1/dt, fix their shapes at
// compile time (no guards on the predecessor loop, 32-bit sample bits);
// <0, 0, 0> reads them at run time for every other shape inside the
// wrapper's limits: the same kernel, not a plain fallback.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int G = 4;          // threads a station
constexpr int KMAX = 8;       // segment slots
constexpr int NSMAX = 64;     // stations
constexpr int NTMAX = 32;     // columns
constexpr int QMAX = 8;       // interior samples per edge
constexpr int NO_K = 1 << 20;      // an empty slice's predecessor

enum {
  F_DT, F_W_ACC, F_PEN_W, F_A_LO, F_A_HI, F_W_OBS, F_COLL, F_DANG, F_LOG_W,
  F_BAND_C, F_BIG, F_INV_DT, F_DD_COLL, F_DD_DANG, F_GATE_SCALE, F_GATE_REL,
  F_COUNT
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
  int B, K, n_s, n_t, m, exact_inv_dt;
  float f[F_COUNT];
};

// one segment's constants
enum { C_SI, C_SO, C_TI, C_TO, C_V3S, C_V3T, C_NRM, C_INV, C_LO, C_HI, C_COUNT };

__device__ __forceinline__ float min_nan(float a, float b) {
  // torch.minimum: NaN propagates
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

// _collision_cost(sqrtf(dd)): w_obs below coll, the exp band below danger,
// exactly 0 beyond (and for NaN); dd_coll / dd_dang are the least floats
// whose square roots reach coll / danger
__device__ __forceinline__ float cost_dd(float dd, const float* F) {
  if (dd < F[F_DD_COLL]) return F[F_W_OBS];
  if (dd < F[F_DD_DANG]) return expf(F[F_LOG_W] * (F[F_BAND_C] - sqrtf(dd)));
  return 0.f;
}

// _seg_distance squared, for one sample point against one segment
__device__ __forceinline__ float seg_dist_sq(float s, float t, float si, float so,
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
  return endpoint ? min_nan(d1, d2) : dperp;
}

// speed_planner.st_gate_window: the stations outside [lo, hi] that no
// sample of this segment can cost; (-inf, inf) for a segment shorter than the
// margin. NaN inputs give NaN bounds, which skip nothing.
__device__ __forceinline__ void st_gate_window(float si, float so, float ti, float to,
                                               const float* F, float& lo, float& hi) {
  const float scale = max_nan(max_nan(max_nan(fabsf(si), fabsf(so)),
                                      max_nan(fabsf(ti), fabsf(to))), F[F_GATE_SCALE]);
  const float margin = F[F_GATE_REL] * (1.f + scale);
  const float reach = F[F_DANG] + margin;
  const float v3s = so - si, v3t = to - ti;
  const bool shortseg = (v3s * v3s + v3t * v3t) < margin * margin;
  lo = shortseg ? -INFINITY : min_nan(si, so) - reach;
  hi = shortseg ? INFINITY : max_nan(si, so) + reach;
}

// speed_planner.st_sample_skipped
__device__ __forceinline__ bool st_sample_skipped(float s, float lo, float hi) {
  return s < lo || s > hi;
}

__device__ __forceinline__ float acc_cost(float a, const float* F) {
  const float w = (a < F[F_A_HI] && a > F[F_A_LO]) ? F[F_W_ACC] : F[F_PEN_W];
  return w * (a * a);
}

// does partial first minimum (v2, k2) beat (v1, k1)? (see the header)
__device__ __forceinline__ bool group_better(float v2, int k2, float v1, int k1) {
  if (isnan(v1)) return false;
  if (isnan(v2)) return true;
  return v2 < v1 || (v2 == v1 && k2 < k1);
}

// one step of the plain rule over ascending k within a thread's slice (k0:
// k is predecessor 0, taken whatever its total)
__device__ __forceinline__ void first_min_step(float total, int k, bool k0, float& best,
                                               int& bk) {
  if (k0 || total < best) {
    best = total;
    bk = k;
  }
}

// combine the first minima of the `width` threads of an aligned group
__device__ __forceinline__ void group_argmin(float& v, int& k, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
    const int k2 = __shfl_xor_sync(0xffffffffu, k, off);
    if (group_better(v2, k2, v, k)) {
      v = v2;
      k = k2;
    }
  }
}

// KT, QT, NS: K, m - 2 and n_s (0: read at run time; the fixed
// instantiations also take the exact product by 1/dt)
template <int KT, int QT, int NS>
__global__ void __launch_bounds__(NS ? NS * G : NSMAX * G, 960 / (NS ? NS * G : NSMAX * G))
    speed_dp_kernel(DPArgs a) {
  constexpr bool FIXED = NS > 0;
  constexpr int NK = FIXED ? NS / G : NSMAX / G;   // predecessors a thread
  const int n_s = FIXED ? NS : a.n_s;
  const int K = FIXED ? KT : a.K;
  const int nq = FIXED ? QT : a.m - 2;
  const int n_t = a.n_t, m = a.m;
  const int C = n_t - 1;                     // transitions
  const float* F = a.f;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int j = tid / G;                     // station
  const int t = tid - j * G;                 // thread within the station's group
  const bool active = j < n_s;

  __shared__ float segc[KMAX][C_COUNT];
  __shared__ float2 row[2][NSMAX];           // (cost, arrival speed) of each station
  __shared__ float top[NTMAX];
  __shared__ int live[NTMAX];                // live-segment bits of column c; [C]: column 0
  __shared__ unsigned char pred[NTMAX - 1][NSMAX];
  __shared__ int rows[NTMAX];
  __shared__ float fmq[QMAX];                // interior-sample fractions (q + 1) / (m - 1)
  __shared__ int n_cells, end_s;
  // the near edges' samples inside a window: bit q * K + kk
  using Bits = typename std::conditional<FIXED, unsigned, unsigned long long>::type;
  extern __shared__ float4 dyn4[];
  Bits* cbits = reinterpret_cast<Bits*>(dyn4);     // [n_s * n_s] of the edge list
  float* s_obs = reinterpret_cast<float*>(cbits + n_s * n_s);  // [n_s][n_s] interior sums C
  float* costA = s_obs + n_s * n_s;                // [C][n_s] endpoint piece at t_start
  float* costB = costA + C * n_s;                  // [C][n_s] endpoint piece at t_end
  float* tm = costB + C * n_s;                     // [C][nq][K][4] interior time terms
  float* s_sg = tm + 4 * C * nq * K;               // [n_s] stations
  unsigned short* cells = reinterpret_cast<unsigned short*>(s_sg + n_s);  // (k << 8) | j

  // ---- set-up 1: tables, segment constants, live masks ----
  const float dt = F[F_DT];
  const float dang = F[F_DANG];
  const float t0 = 1.0f * dt;        // t_grid[0] = (0 + 1) * dt
  const float mm1 = (float)(m - 1);
  const float* s_lane = a.seg + (size_t)b * 5 * K;
  for (int e = tid; e < n_s * n_s; e += nthreads) s_obs[e] = 0.f;
  for (int e = tid; e < n_s; e += nthreads) s_sg[e] = a.sg[e];
  if (tid == 0) n_cells = 0;
  if (tid < nq) fmq[tid] = (float)(tid + 1) / mm1;
  for (int e = tid; e < K + C + 1; e += nthreads) {
    if (e < K) {
      const float si = s_lane[e], so = s_lane[K + e], ti = s_lane[2 * K + e],
                  to = s_lane[3 * K + e];
      const float v3s = so - si, v3t = to - ti;
      const float nrm = (v3s * v3s + v3t * v3t) + 1e-24f;
      float* sc = segc[e];
      sc[C_SI] = si;
      sc[C_SO] = so;
      sc[C_TI] = ti;
      sc[C_TO] = to;
      sc[C_V3S] = v3s;
      sc[C_V3T] = v3t;
      sc[C_NRM] = nrm;
      sc[C_INV] = 1.f / nrm;
      st_gate_window(si, so, ti, to, F, sc[C_LO], sc[C_HI]);
    } else {
      // column c's pure-time gap; [C]: column 0's start edges
      const int c = e - K;
      const float t_start = ((float)c + 1.0f) * dt;
      const float t_end = t_start + dt;
      int mask = 0;
      for (int kk = 0; kk < K; ++kk) {
        const float ti = s_lane[2 * K + kk], to = s_lane[3 * K + kk];
        // torch.maximum's NaN: a segment with a NaN time is live nowhere
        const float gap = c < C ? max_nan(ti - t_end, t_start - to) : max_nan(ti - t0, -to);
        if (s_lane[4 * K + kk] > 0.5f && gap < dang) mask |= 1 << kk;
      }
      live[c] = mask;
    }
  }
  __syncthreads();

  // ---- set-up 2: what does not depend on the recursion ----
  int any_live = 0;                  // segments live in some transition
  for (int c = 0; c < C; ++c) any_live |= live[c];
  // interior time terms of every live (column, sample, segment)
  for (int e = tid; e < C * nq * K; e += nthreads) {
    const int kk = e % K, q = (e / K) % nq, c = e / (K * nq);
    if (!((live[c] >> kk) & 1)) continue;
    const float t_start = ((float)c + 1.0f) * dt;
    const float fm = (float)(q + 1) / mm1;
    const float t_p = t_start + dt * fm;
    const float v1t = segc[kk][C_TI] - t_p;
    const float v2t = segc[kk][C_TO] - t_p;
    float* o = tm + 4 * e;
    o[0] = v1t * v1t;
    o[1] = v2t * v2t;
    o[2] = v1t * segc[kk][C_V3S];
    o[3] = v1t * segc[kk][C_V3T];
  }
  // endpoint pieces: A at (s_k, t_start) and B at (s_j, t_end), per live column
  for (int e = tid; e < 2 * C * n_s; e += nthreads) {
    const int st = e % n_s, c = (e / n_s) % C, piece = e / (n_s * C);
    const int mask = live[c];
    if (!mask) continue;
    const float t_start = ((float)c + 1.0f) * dt;
    const float tt = piece ? t_start + dt : t_start;
    const float s = s_sg[st];
    float acc = 0.f;
    for (int kk = 0; kk < K; ++kk) {
      if (!((mask >> kk) & 1)) continue;
      const float* sc = segc[kk];
      if (st_sample_skipped(s, sc[C_LO], sc[C_HI])) continue;
      acc = acc + cost_dd(seg_dist_sq(s, tt, sc[C_SI], sc[C_SO], sc[C_TI], sc[C_TO]), F);
    }
    (piece ? costB : costA)[c * n_s + st] = acc;
  }
  // the edges (k, j) with an interior sample inside some live segment's window
  if (any_live) {
    for (int e = tid; e < n_s * n_s; e += nthreads) {
      const int k = e / n_s, jj = e - k * n_s;
      const float sk = s_sg[k], sj = s_sg[jj];
      Bits bits = 0;
      for (int q = 0; q < nq; ++q) {
        const float fm = (float)(q + 1) / mm1;
        const float s_mid = sk + (sj - sk) * fm;
        for (int kk = 0; kk < K; ++kk)
          if (((any_live >> kk) & 1) &&
              !st_sample_skipped(s_mid, segc[kk][C_LO], segc[kk][C_HI]))
            bits |= (Bits)1 << (q * K + kk);
      }
      if (bits) {
        const int at = atomicAdd(&n_cells, 1);
        cells[at] = (unsigned short)((k << 8) | jj);
        cbits[at] = bits;
      }
    }
  }
  // column 0: start edges from the plan start (one thread a station)
  const bool exact = FIXED || a.exact_inv_dt != 0;
  const float inv_dt = F[F_INV_DT];
  if (active && t == 0) {
    const int mask = live[C];
    const float sj = s_sg[j];
    float obs0 = 0.f;
    for (int q = 0; q < m && mask; ++q) {
      const float fr = (float)q / mm1;
      const float s_q = sj * fr, t_q = t0 * fr;
      for (int kk = 0; kk < K; ++kk) {
        if (!((mask >> kk) & 1)) continue;
        const float* sc = segc[kk];
        if (st_sample_skipped(s_q, sc[C_LO], sc[C_HI])) continue;
        obs0 = obs0 + cost_dd(seg_dist_sq(s_q, t_q, sc[C_SI], sc[C_SO], sc[C_TI], sc[C_TO]),
                              F);
      }
    }
    const float dv0 = a.v0e[j] - a.v0[b];
    const float a0 = exact ? dv0 * inv_dt : dv0 / t0;
    const float cost0 = (obs0 + a.ref0[j]) + acc_cost(a0, F);
    row[0][j] = make_float2(cost0, a.v0e[j]);
    if (j == n_s - 1) top[0] = cost0;
  }
  // this thread's predecessors k = t + G i: edge speed and the static cost
  // of a column without obstacles, ((0 + ref) + forbidden), for the launch
  float dv_r[NK], sd_r[NK];
#pragma unroll
  for (int i = 0; i < NK; ++i) {
    const int k = t + G * i;
    const bool on = active && k < n_s;
    const float dv = on ? a.dv[k * n_s + j] : 0.f;
    dv_r[i] = dv;
    sd_r[i] = (0.f + (on ? a.ref_tr[k * n_s + j] : 0.f)) + (dv < 0.f ? F[F_BIG] : 0.f);
  }
  __syncthreads();

  // ---- transitions: column c -> c + 1 ----
  int cur = 0;
  for (int c = 0; c < C; ++c) {
    const int mask = live[c];
    if (mask) {
      // the interior-sample sums of the near edges, over their samples inside
      // a live segment's window, q outer and kk inner (ascending bits)
      Bits live_bits = 0;
      for (int q = 0; q < nq; ++q) live_bits |= (Bits)mask << (q * K);
      const int nc = n_cells;
      for (int e = tid; e < nc; e += nthreads) {
        const int cell = cells[e];
        const int k = cell >> 8, jj = cell & 0xff;
        const float sk = s_sg[k], sj = s_sg[jj];
        float sum = 0.f;
        for (Bits bits = cbits[e] & live_bits; bits; bits &= bits - 1) {
          const int bit = FIXED ? __ffs((unsigned)bits) - 1 : __ffsll((long long)bits) - 1;
          const int q = bit / K, kk = bit - q * K;
          const float s_mid = sk + (sj - sk) * fmq[q];
          const float* sc = segc[kk];
          const float* tq = tm + 4 * ((c * nq + q) * K + kk);
          const float v3s = sc[C_V3S];
          const float v1s = sc[C_SI] - s_mid;
          const float d1 = v1s * v1s + tq[0];
          const float v2s = v1s + v3s;
          const float d2 = v2s * v2s + tq[1];
          const float cross = v1s * sc[C_V3T] - tq[2];
          const float dperp = cross * cross * sc[C_INV];
          const float p1 = v1s * v3s + tq[3];
          const float p2 = p1 + sc[C_NRM];
          const bool endpoint = (p1 > 0.f) == (p2 > 0.f);
          sum = sum + cost_dd(endpoint ? min_nan(d1, d2) : dperp, F);
        }
        s_obs[k * n_s + jj] = sum;
      }
      __syncthreads();
    }
    const float2* prev = row[cur];
    float best = INFINITY;
    int bk = NO_K;
    if (mask) {
      const float cB = active ? costB[c * n_s + j] : 0.f;
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const int k = t + G * i;
        if (!FIXED && (!active || k >= n_s)) break;
        const float2 pk = prev[k];
        const int e = k * n_s + j;
        const float obs = (costA[c * n_s + k] + cB) + s_obs[e];
        const float st = (obs + __ldg(a.ref_tr + e)) + (dv_r[i] < 0.f ? F[F_BIG] : 0.f);
        const float dvs = dv_r[i] - pk.y;
        const float accel = exact ? dvs * inv_dt : dvs / dt;
        const float total = (pk.x + st) + acc_cost(accel, F);
        first_min_step(total, k, i == 0 && t == 0, best, bk);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const int k = t + G * i;
        if (!FIXED && (!active || k >= n_s)) break;
        const float2 pk = prev[k];
        const float dvs = dv_r[i] - pk.y;
        const float accel = exact ? dvs * inv_dt : dvs / dt;
        const float total = (pk.x + sd_r[i]) + acc_cost(accel, F);
        first_min_step(total, k, i == 0 && t == 0, best, bk);
      }
    }
    group_argmin(best, bk, G);
    const int nxt = cur ^ 1;
    if (active && t == 0) {
      row[nxt][j] = make_float2(best, __ldg(a.dv + bk * n_s + j));
      pred[c][j] = (unsigned char)bk;
      if (j == n_s - 1) top[c + 1] = best;
    }
    cur = nxt;
    __syncthreads();
  }

  // ---- terminal and backtrack: warp 0 ----
  if (tid >= 32) return;
  const float2* last = row[cur];
  float right = INFINITY;
  int best_right = NO_K;
  for (int k = tid; k < n_s; k += 32) first_min_step(last[k].x, k, k == 0, right, best_right);
  group_argmin(right, best_right, 32);
  if (tid == 0) {
    int best_top = 0;
    float top_cost = top[0];
    for (int cc = 1; cc < n_t; ++cc)
      if (top[cc] <= top_cost) { top_cost = top[cc]; best_top = cc; }  // last minimum
    const bool use_top = top_cost <= right;
    const int end_col = use_top ? best_top : n_t - 1;
    int r = use_top ? n_s - 1 : best_right;
    for (int cc = end_col; cc >= 0; --cc) {
      rows[cc] = r;
      if (cc > 0) r = pred[cc - 1][r];
    }
    end_s = end_col;
    a.end_out[b] = end_col;
  }
  __syncwarp();
  if (tid < n_t) {
    const bool on = tid <= end_s;
    float s = 0.f;
    if (on) s = s_sg[rows[tid]];
    a.s_out[(size_t)b * n_t + tid] = s;
    a.valid_out[(size_t)b * n_t + tid] = on;
  }
}

// dynamic shared memory of a launch: the edge list's sample bits, the
// interior sums, the endpoint pieces, the time terms, the stations and the
// edge list
size_t dyn_bytes(int n_s, int n_t, int nq, int K, size_t bits_bytes) {
  const int C = n_t - 1;
  return (size_t)n_s * n_s * bits_bytes +
         (size_t)(n_s * n_s + 2 * C * n_s + 4 * C * nq * K + n_s) * sizeof(float) +
         (size_t)n_s * n_s * sizeof(unsigned short);
}

template <int KT, int QT, int NS>
cudaError_t launch(const DPArgs& a, cudaStream_t stream) {
  const size_t bytes = dyn_bytes(a.n_s, a.n_t, a.m - 2, a.K, NS ? 4 : 8);
  cudaError_t err = cudaFuncSetAttribute(
      speed_dp_kernel<KT, QT, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int threads = (a.n_s * G + 31) / 32 * 32;
  speed_dp_kernel<KT, QT, NS><<<a.B, threads, bytes, stream>>>(a);
  return cudaGetLastError();
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
  a.exact_inv_dt = iparams[5];
  for (int e = 0; e < F_COUNT; ++e) a.f[e] = fparams[e];
  if (a.K < 1 || a.K > KMAX || a.n_s < 2 || a.n_s > NSMAX || a.n_t < 2 ||
      a.n_t > NTMAX || a.m < 2 || a.m - 2 > QMAX || 5 * a.K > a.n_s ||
      (a.m - 2) * a.K > a.n_s)
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0) return 0;
  const int nq = a.m - 2;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  // the shapes of the main paths, at 40 stations and an exact 1/dt
  const bool fixed = a.n_s == 40 && nq == 3 && a.exact_inv_dt != 0;
  if (fixed && a.K == 2)
    err = launch<2, 3, 40>(a, s);
  else if (fixed && a.K == 4)
    err = launch<4, 3, 40>(a, s);
  else
    err = launch<0, 0, 0>(a, s);
  return (int)err;
}
