// One plan cycle's control/plant tick loop (LQR + kinematic bicycle, with or
// without traffic lights), all ticks in one kernel.
//
// Replaces: emplanner_carla_tpu/ops/tick_pallas.py run_ticks_batched in its
// LQR / kinematic branch, with its red-light branch (lights=, :211-217,
// :286-308, :393-401) (dispatched at sim/closed_loop.py:706-746).
// Semantics: sim/closed_loop._full_ticks_base.
// Per tick and lane: hat lookup of the planned speed; time-headway ACC cap on
// the nearest lead in the ego's corridor (heading fallback below 0.5 m/s);
// with lights, the red stop line's time-headway cap in the same corridor
// (phase = floored mod of t0 + t_rel + offset by max(period, 1e-3));
// predicted-pose first-minimum match on the target path; LQR gain-table
// lerp + curvature feedforward; PID with the 60-deep error buffer and
// integral separation; arrival / bad-plan brake; kinematic plant with the
// lagged, rate-limited steering actuator; constant-velocity obstacle
// advance; collision check; lateral error at the new pose; 8 metric
// channels written as (channel, B, ticks).
//
// What bounds it on the H100: latency of the serial tick chain. The work is
// small (about 3.8 KB in and out per lane, the speed profile counted only
// where the ticks look it up, and ~9e4 flops per lane and cycle, which
// makes its floor a few microseconds of float32 arithmetic at B = 4096),
// but the ticks of a lane are strictly sequential and there is one lane per
// scenario: 4096 lanes are 128 warps for 132 SMs, so each SM runs about one
// warp and cannot hide the latency of its dependent arithmetic and loads.
//
// What the design does about it: one thread per lane keeps the whole ego,
// PID and obstacle state in registers (the PID buffer in a per-thread ring
// in local memory) across all ticks, so nothing goes back to device memory
// until the cycle ends; 32-thread blocks spread the warps over every SM; the
// gain table sits in shared memory; the lane's target path and speed
// profile are re-read from the L1-resident rows. A warp per lane for the
// path match would raise the parallelism and is left to a later change.
// The file builds with -fmad=false and uses jnp.hypot's formula, so the
// arithmetic matches the plain PyTorch loop term for term.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KMAX = 16;     // obstacle slots
constexpr int NBMAX = 64;    // PID buffer depth
constexpr int TABMAX = 256;  // gain-table rows
constexpr int THREADS = 32;

enum {
  F_DT, F_STANDOFF, F_HEADWAY, F_MIN_VX, F_TS, F_TAB_V0, F_TAB_DV, F_A, F_B, F_AB,
  F_BCF, F_ACR, F_CR, F_M, F_MAX_STEER, F_STEER_LIMIT, F_KP, F_KI, F_KD, F_PID_DT,
  F_SEP, F_ARRIVAL, F_MAX_ACCEL, F_MAX_BRAKE, F_TAU_DEN, F_RATE_DT, F_COLL_R,
  F_STOP_STANDOFF, F_STOP_HEADWAY, F_STOP_LAT, F_COUNT
};

struct TickArgs {
  const float* ego;       // (B, 9) x y phi vx vy omega ax ay steer
  const float* pbuf;      // (B, NB)
  const int* pcnt;        // (B,)
  const float* plast;     // (B,)
  const float* obs;       // (B, 5, K) x y vx vy valid
  const float* tspeed;    // (B, ND)
  const float* ttime;     // (ND,)
  const float* target;    // (B, 4, NP) x y theta kappa
  const bool* feas;       // (B,)
  const bool* plan_ok;    // (B,)
  const bool* arrived0;   // (B,)
  const float* dest_x;    // (B,)
  const float* dest_y;    // (B,)
  const float* ktab;      // (n_tab, 4)
  float* ego_out;         // (B, 9)
  float* pbuf_out;        // (B, NB)
  int* pcnt_out;          // (B,)
  float* plast_out;       // (B,)
  float* obsxy_out;       // (B, 2, K)
  bool* arrived_out;      // (B,)
  float* metrics;         // (8, B, n_ticks)
  const float* lights;    // (B, 6, L) x y period offset green_frac valid, or null
  const float* t0;        // (B,) cycle start time, or null
  int B, K, NP, ND, NB, n_ticks, n_tab, L;
  float f[F_COUNT];
};

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// jnp.hypot: max * sqrt(1 + (min/max)^2)
__device__ __forceinline__ float hypot_j(float a, float b) {
  a = fabsf(a);
  b = fabsf(b);
  if (isinf(a) || isinf(b)) return INFINITY;
  float hi = fmaxf(a, b), lo = fminf(a, b);
  if (hi == 0.f) return hi;
  float r = lo / hi;
  return hi * sqrtf(1.0f + r * r);
}

// torch.remainder / jnp.mod: the floored modulo
__device__ __forceinline__ float floored_mod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.f && ((r < 0.f) != (b < 0.f))) r += b;
  return r;
}

// first-minimum nearest node of (px, py) on the lane's target path
__device__ __forceinline__ int match(const float* tx, const float* ty, int NP,
                                     float px, float py) {
  float best = INFINITY;
  int bi = 0;
  for (int j = 0; j < NP; ++j) {
    float dx = tx[j] - px, dy = ty[j] - py;
    float d = dx * dx + dy * dy;
    if (d < best) { best = d; bi = j; }
  }
  return bi;
}

__global__ void __launch_bounds__(THREADS) tick_lqr_kernel(TickArgs a) {
  __shared__ float s_tab[TABMAX * 4];
  for (int e = threadIdx.x; e < a.n_tab * 4; e += blockDim.x) s_tab[e] = a.ktab[e];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const float* F = a.f;
  const int K = a.K, NP = a.NP, ND = a.ND, NB = a.NB;

  const float* e0 = a.ego + (size_t)b * 9;
  float x = e0[0], y = e0[1], phi = e0[2], vx = e0[3], vy = e0[4], omega = e0[5];
  float ax = e0[6], ay = e0[7], steer_ap = e0[8];

  float buf[NBMAX];
  for (int j = 0; j < NB; ++j) buf[j] = a.pbuf[(size_t)b * NB + j];
  int head = 0;  // ring index of the oldest entry
  int cnt = a.pcnt[b];
  float last = a.plast[b];

  float ox[KMAX], oy[KMAX], ovx[KMAX], ovy[KMAX];
  bool ovalid[KMAX];
  const float* ob = a.obs + (size_t)b * 5 * K;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    bool in = k < K;
    ox[k] = in ? ob[k] : 0.f;
    oy[k] = in ? ob[K + k] : 0.f;
    ovx[k] = in ? ob[2 * K + k] : 0.f;
    ovy[k] = in ? ob[3 * K + k] : 0.f;
    ovalid[k] = in && ob[4 * K + k] > 0.5f;
  }
  const float* spd = a.tspeed + (size_t)b * ND;
  const float* tgx = a.target + (size_t)b * 4 * NP;
  const float* tgy = tgx + NP;
  const float* tgt = tgy + NP;
  const float* tgk = tgt + NP;
  const bool feas = a.feas[b];
  const bool plan_ok = a.plan_ok[b];
  bool arrived = a.arrived0[b];
  const float destx = a.dest_x[b], desty = a.dest_y[b];
  const float t0 = a.ttime[0];
  const float t_dx = a.ttime[1] - a.ttime[0];
  const float dt = F[F_DT];
  const float coll_r = F[F_COLL_R];
  const size_t plane = (size_t)a.B * a.n_ticks;
  float* m_out = a.metrics + (size_t)b * a.n_ticks;
  const int L = a.L;
  const float* tl = L > 0 ? a.lights + (size_t)b * 6 * L : nullptr;
  const float t_cycle = L > 0 ? a.t0[b] : 0.f;

  for (int i = 0; i < a.n_ticks; ++i) {
    // planned speed at t_rel: uniform hat, two nonzero weights
    const float t_rel = (float)(i + 1) * dt;
    const float u = clip((t_rel - t0) / t_dx, 0.f, (float)(ND - 1));
    const int k0 = min((int)floorf(u), ND - 2);
    const float w0 = fmaxf(0.f, 1.f - fabsf(u - (float)k0));
    const float w1 = fmaxf(0.f, 1.f - fabsf(u - (float)(k0 + 1)));
    float plan_speed = w0 * spd[k0] + w1 * spd[k0 + 1];
    plan_speed = plan_ok ? plan_speed : 0.f;

    // time-headway ACC guard along the motion direction
    const float cphi = cosf(phi), sphi = sinf(phi);
    const float vxw = vx * cphi - vy * sphi;
    const float vyw = vy * cphi + vx * sphi;
    const float spd_w = hypot_j(vxw, vyw);
    const bool slow = spd_w < 0.5f;
    const float den = slow ? 1.f : fmaxf(spd_w, 1e-3f);
    const float ux = slow ? cphi : vxw / den;
    const float uy = slow ? sphi : vyw / den;
    float d_lead = INFINITY;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const float dxo = ox[k] - x, dyo = oy[k] - y;
      const float d_long = dxo * ux + dyo * uy;
      const float d_lat = -dxo * uy + dyo * ux;
      if (ovalid[k] && d_long > 0.f && fabsf(d_lat) < 2.f) d_lead = fminf(d_lead, d_long);
    }
    float v_cap = fmaxf((d_lead - F[F_STANDOFF]) / F[F_HEADWAY], 0.f);
    if (L > 0) {
      // red-light cap: nearest red stop line ahead in the same corridor
      const float t_abs = t_cycle + t_rel;
      float d_stop = INFINITY;
      for (int l = 0; l < L; ++l) {
        const float per = tl[2 * L + l];
        const float phase = floored_mod(t_abs + tl[3 * L + l], fmaxf(per, 1e-3f));
        const bool red = tl[5 * L + l] > 0.5f && !(phase < tl[4 * L + l] * per);
        const float dxl = tl[l] - x, dyl = tl[L + l] - y;
        const float dl_long = dxl * ux + dyl * uy;
        const float dl_lat = -dxl * uy + dyl * ux;
        if (red && dl_long > 0.f && fabsf(dl_lat) < F[F_STOP_LAT])
          d_stop = fminf(d_stop, dl_long);
      }
      v_cap = fminf(v_cap,
                    fmaxf((d_stop - F[F_STOP_STANDOFF]) / F[F_STOP_HEADWAY], 0.f));
    }
    const float tick_kmh = 3.6f * fminf(plan_speed, v_cap);

    // LQR: gain lerp, predicted-pose tracking error, feedforward
    const float vxs = vx < 0.f ? fminf(vx, -F[F_MIN_VX]) : fmaxf(vx, F[F_MIN_VX]);
    const float pos = clip((vxs - F[F_TAB_V0]) / F[F_TAB_DV], 0.f, (float)(a.n_tab - 1));
    const int ii = max(0, min((int)pos, a.n_tab - 2));
    const float wf = pos - (float)ii;
    float kg[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kg[j] = s_tab[ii * 4 + j] * (1.f - wf) + s_tab[(ii + 1) * 4 + j] * wf;
    const float ts = F[F_TS];
    const float xp = x + (vxs * cphi - vy * sphi) * ts;
    const float yp = y + (vy * cphi + vxs * sphi) * ts;
    const float php = phi + omega * ts;
    const int mi = match(tgx, tgy, NP, xp, yp);
    const float xm = tgx[mi], ym = tgy[mi], thm = tgt[mi], km = tgk[mi];
    const float tx_ = cosf(thm), ty_ = sinf(thm);
    const float ddx = xp - xm, ddy = yp - ym;
    const float e_d = -ty_ * ddx + tx_ * ddy;
    const float e_s = tx_ * ddx + ty_ * ddy;
    const float theta_r = thm + km * e_s;
    const float dph = php - theta_r;
    const float cd = cosf(dph), sd = sinf(dph);
    const float e_d_dot = vy * cd + vxs * sd;
    const float e_phi = sd;
    const float s_dot = (vxs * cd - vy * sd) / (1.f - km * e_d);
    const float e_phi_dot = omega - km * s_dot;
    const float ke = kg[0] * e_d + kg[1] * e_d_dot + kg[2] * e_phi + kg[3] * e_phi_dot;
    const float ff = km * (F[F_AB] - F[F_B] * kg[2] -
                           (F[F_BCF] + F[F_A] * kg[2] / F[F_CR] - F[F_ACR]) *
                               (F[F_M] * vxs * vxs) / F[F_AB]);
    const float delta_cmd = -ke + ff;
    const float steer_cmd =
        clip(delta_cmd / F[F_MAX_STEER], -F[F_STEER_LIMIT], F[F_STEER_LIMIT]);

    // PID with integral separation
    const float err = tick_kmh - 3.6f * hypot_j(vx, vy);
    buf[head] = err;
    head = head + 1 == NB ? 0 : head + 1;
    cnt = min(cnt + 1, NB);
    const bool have_two = cnt >= 2;
    float integral = 0.f, deriv = 0.f;
    if (have_two) {
      float sum = 0.f;
      for (int j = 0; j < NB; ++j) {
        int r = head + j;
        sum += buf[r >= NB ? r - NB : r];
      }
      integral = sum * F[F_PID_DT];
      deriv = (err - last) / F[F_PID_DT];
    }
    if (fabsf(err) > F[F_SEP]) {
      integral = 0.f;
      for (int j = 0; j < NB; ++j) buf[j] = 0.f;
      cnt = 0;
    }
    const float cmd = F[F_KP] * err + F[F_KI] * integral + F[F_KD] * deriv;
    last = err;
    const float throttle = clip(cmd, 0.f, 1.f);
    const float brake = clip(-cmd, 0.f, 1.f);

    // arrival (pre-step pose) and stop gating
    arrived = arrived || hypot_j(x - destx, y - desty) < F[F_ARRIVAL];
    const bool stop = arrived || !plan_ok;
    const float steer_g = stop ? 0.f : steer_cmd;
    const float thr_g = stop ? 0.f : throttle;
    const float brk_g = stop ? 1.f : brake;

    // kinematic bicycle with the steering actuator
    const float accel = thr_g * F[F_MAX_ACCEL] - brk_g * F[F_MAX_BRAKE];
    const float desired = (steer_g - steer_ap) * dt / F[F_TAU_DEN];
    const float change = clip(desired, -F[F_RATE_DT], F[F_RATE_DT]);
    steer_ap = clip(steer_ap + change, -1.f, 1.f);
    const float delta = clip(steer_ap, -1.f, 1.f) * F[F_MAX_STEER];
    const float v = fmaxf(vx + accel * dt, 0.f);
    omega = v * tanf(delta) / F[F_AB];
    phi = phi + omega * dt;
    const float cph = cosf(phi), sph = sinf(phi);
    x = x + v * cph * dt;
    y = y + v * sph * dt;
    ax = accel * cph;
    ay = accel * sph;
    vx = v;
    vy = 0.f;

    // obstacles advance; collision check
    bool collided = false;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      ox[k] = ox[k] + ovx[k] * dt;
      oy[k] = oy[k] + ovy[k] * dt;
      collided = collided || (ovalid[k] && hypot_j(ox[k] - x, oy[k] - y) < coll_r);
    }

    // lateral error at the new pose
    const int mj = match(tgx, tgy, NP, x, y);
    const float xm2 = tgx[mj], ym2 = tgy[mj], tm2 = tgt[mj], km2 = tgk[mj];
    const float ex = x - xm2, ey = y - ym2;
    const float ds2 = ex * cosf(tm2) + ey * sinf(tm2);
    const float tr2 = tm2 + km2 * ds2;
    const float lat = -ex * sinf(tr2) + ey * cosf(tr2);

    m_out[i] = x;
    m_out[plane + i] = y;
    m_out[2 * plane + i] = 3.6f * hypot_j(vx, vy);
    m_out[3 * plane + i] = lat;
    m_out[4 * plane + i] = phi;
    m_out[5 * plane + i] = collided ? 1.f : 0.f;
    m_out[6 * plane + i] = arrived ? 1.f : 0.f;
    m_out[7 * plane + i] = (feas && plan_ok) ? 1.f : 0.f;
  }

  float* eo = a.ego_out + (size_t)b * 9;
  eo[0] = x; eo[1] = y; eo[2] = phi; eo[3] = vx; eo[4] = vy; eo[5] = omega;
  eo[6] = ax; eo[7] = ay; eo[8] = steer_ap;
  for (int j = 0; j < NB; ++j) {
    int r = head + j;
    a.pbuf_out[(size_t)b * NB + j] = buf[r >= NB ? r - NB : r];
  }
  a.pcnt_out[b] = cnt;
  a.plast_out[b] = last;
  for (int k = 0; k < K; ++k) {
    a.obsxy_out[(size_t)b * 2 * K + k] = ox[k];
    a.obsxy_out[(size_t)b * 2 * K + K + k] = oy[k];
  }
  a.arrived_out[b] = arrived;
}

}  // namespace

extern "C" int tick_lqr(void* const* ptrs, const float* fparams, const int* iparams,
                        void* stream) {
  TickArgs a;
  a.ego = (const float*)ptrs[0];
  a.pbuf = (const float*)ptrs[1];
  a.pcnt = (const int*)ptrs[2];
  a.plast = (const float*)ptrs[3];
  a.obs = (const float*)ptrs[4];
  a.tspeed = (const float*)ptrs[5];
  a.ttime = (const float*)ptrs[6];
  a.target = (const float*)ptrs[7];
  a.feas = (const bool*)ptrs[8];
  a.plan_ok = (const bool*)ptrs[9];
  a.arrived0 = (const bool*)ptrs[10];
  a.dest_x = (const float*)ptrs[11];
  a.dest_y = (const float*)ptrs[12];
  a.ktab = (const float*)ptrs[13];
  a.ego_out = (float*)ptrs[14];
  a.pbuf_out = (float*)ptrs[15];
  a.pcnt_out = (int*)ptrs[16];
  a.plast_out = (float*)ptrs[17];
  a.obsxy_out = (float*)ptrs[18];
  a.arrived_out = (bool*)ptrs[19];
  a.metrics = (float*)ptrs[20];
  a.lights = (const float*)ptrs[21];
  a.t0 = (const float*)ptrs[22];
  a.B = iparams[0];
  a.K = iparams[1];
  a.NP = iparams[2];
  a.ND = iparams[3];
  a.NB = iparams[4];
  a.n_ticks = iparams[5];
  a.n_tab = iparams[6];
  a.L = iparams[7];
  for (int j = 0; j < F_COUNT; ++j) a.f[j] = fparams[j];
  if (a.K > KMAX || a.NB > NBMAX || a.n_tab > TABMAX || a.ND < 2 || a.NP < 1 ||
      a.L < 0 || (a.L > 0 && (a.lights == nullptr || a.t0 == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0) return 0;
  const int blocks = (a.B + THREADS - 1) / THREADS;
  tick_lqr_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
