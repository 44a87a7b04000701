// One plan cycle's control/plant tick loop, all ticks in one kernel: LQR or
// the condensed MPC lateral controller, the kinematic or the dynamic bicycle,
// with or without traffic lights, with constant-velocity obstacles or with
// NPC agents.
//
// Replaces: emplanner_carla_tpu/ops/tick_pallas.py run_ticks_batched: its LQR /
// kinematic branch (K3) with its red-light branch (lights=, :211-217,
// :286-308, :393-401), its MPC branch (K5, tables :142-173, in-kernel
// :436-503), its dynamic-plant branch (K6, plant_mod.step at :543-548,
// i.e. sim/plant.py:77-111) (dispatched at sim/closed_loop.py:706-746) and
// its agent-traffic branch (K7, traffic=, :191-210, :555-799, :920-930,
// dispatched at sim/closed_loop.py:875-931).
// Semantics: sim/closed_loop._full_ticks_base and _traffic_ticks_base.
// Per tick and lane: hat lookup of the planned speed; time-headway ACC cap on
// the nearest lead in the ego's corridor (heading fallback below 0.5 m/s);
// with lights, the red stop line's time-headway cap in the same corridor
// (phase = floored mod of t0 + t_rel + offset by max(period, 1e-3));
// predicted-pose first-minimum match on the target path; the lateral
// controller (below); PID with the 60-deep error buffer and integral
// separation; arrival / bad-plan brake; `substeps` plant steps at dt /
// substeps with the lagged, rate-limited steering actuator; constant-velocity
// obstacle advance; collision check; lateral error at the new pose; 8 metric
// channels written as (channel, B, ticks).
//
// NPC agents (traffic branch, sim/npc.py, see npc_advance): after the ego's
// plant step every slot's lane offset slews toward its target; each live
// agent slot then finds its own-lane and target-lane leads among the other
// slots and the ego at its new pose, the red stop line (with lights), three
// corridor checks and the lane decision, the 32-row forward first-minimum
// match and the look-ahead row, pure pursuit (atan2f, as the plain version's
// torch.atan2, not the TPU kernel's polynomial), IDM and the kinematic
// bicycle; the other slots move at constant velocity. Every slot reads the
// others as they stood at the start of the tick: the new states go to
// temporaries and are written back after the last slot.
//
// Lateral controllers. LQR: gain-table lerp + curvature feedforward. MPC
// (control/lateral.mpc_steer_table): one lerp of the Vx-grid tables, the
// unconstrained optimum u* = W1 e + kappa w2 (the JAX scan's form, not the
// TPU kernel's -Hinv2 f); where some |u*_i| > 1 (or is NaN), f = 2 (G1 e +
// kappa g2), the lerped Minv and `mpc_iters` warm box-ADMM steps from the
// (z, u_d) carried across the cycle's ticks (zeros at cycle start); else
// the state becomes (u*, 0). The ADMM branch is taken per lane: a warp only
// pays for it in time.
//
// What bounds it on the H100: latency of the serial tick chain. The work is
// small (about 3.8 KB in and out per lane, the speed profile counted only
// where the ticks look it up; ~9e4 flops per lane and cycle for LQR, plus
// ~3.8e3 per MPC tick that runs the ADMM), but the ticks of a lane are
// strictly sequential and there is one lane per scenario: 4096 lanes are 128
// warps for 132 SMs, so each SM runs about one warp and cannot hide the
// latency of its dependent arithmetic and loads. With agents, each live
// agent adds ~6e2 operations a tick (the 32-row match, ~18 transcendentals,
// IDM and the bicycle) and ~60 for each actor its five corridor scans visit
// (the valid other slots and the ego) to the same serial chain.
//
// What the design does about it: one thread per lane keeps the whole ego,
// PID and obstacle state in registers (the PID buffer in a per-thread ring
// in local memory) across all ticks, so nothing goes back to device memory
// until the cycle ends; 32-thread blocks spread the warps over every SM; the
// LQR gain table sits in static shared memory, the MPC tables (64 x 264
// floats at nu = 12, 67.6 KB) and each lane's MPC vectors and lerped Minv
// (lane-minor, conflict-free) in dynamic shared memory; the lane's target
// path and speed profile are re-read from the L1-resident rows. The LQR +
// kinematic entry point `tick_lqr` keeps one plant step and the sin heading
// error as compile-time constants, the code of K3; `tick_variant` takes
// substeps and the raw heading error as runtime parameters; `tick_traffic`
// runs every controller and plant with the agents (K7), whose per-slot state
// (the tick-start copy, the new states, lane offsets and targets, match
// indices: 24.6 KB a block) sits lane-minor in static shared memory, since a
// slot's loop reads the other slots by a run-time index; the lane's global
// path is read in place (32 match rows and two look-up rows a live agent and
// tick, L1/L2-resident). The TPU kernel's 96-row block-shared path window,
// its containment gate, its skip of blocks without a live agent and its
// one-hot row selection are Mosaic scheduling choices with no counterpart
// here.
// The file builds with -fmad=false and uses jnp.hypot's formula, and every
// sum runs in the plain version's order, so the arithmetic matches the plain
// PyTorch loop term for term.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KMAX = 16;     // obstacle slots
constexpr int NBMAX = 64;    // PID buffer depth
constexpr int TABMAX = 256;  // LQR gain-table rows
constexpr int NUMAX = 16;    // MPC decision variables
constexpr int THREADS = 32;

enum {
  F_DT, F_STANDOFF, F_HEADWAY, F_MIN_VX, F_TS, F_TAB_V0, F_TAB_DV, F_A, F_B, F_AB,
  F_BCF, F_ACR, F_CR, F_M, F_MAX_STEER, F_STEER_LIMIT, F_KP, F_KI, F_KD, F_PID_DT,
  F_SEP, F_ARRIVAL, F_MAX_ACCEL, F_MAX_BRAKE, F_TAU_DEN, F_RATE_DT, F_COLL_R,
  F_STOP_STANDOFF, F_STOP_HEADWAY, F_STOP_LAT, F_DT_SUB, F_CF, F_IZ, F_FZF, F_FZR,
  // NPC agents (traffic branch): behaviour preset, lane width, lane slew a
  // tick, twice the wheelbase
  F_P_MAXSPD, F_P_SAFET, F_P_MIND, F_P_ACC, F_P_DEC, F_LANE_W, F_LANE_STEP, F_TWO_L,
  F_COUNT
};

// per-slot NPC state of the traffic branch, lane-minor in shared memory
// (element k of lane t at [k * THREADS + t]): the slots at the start of the
// tick (X .. SP), their new state (NX .. NVY) and the lane offsets / targets
enum { N_X, N_Y, N_VX, N_VY, N_SP, N_NX, N_NY, N_NVX, N_NVY, N_OFF, N_TGT, N_COUNT };

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
  const float* tab;       // LQR (n_tab, 4) gains, or MPC (n_tab, nu*nu + 10*nu)
  float* ego_out;         // (B, 9)
  float* pbuf_out;        // (B, NB)
  int* pcnt_out;          // (B,)
  float* plast_out;       // (B,)
  float* obsxy_out;       // (B, 2, K) x y; traffic: (B, 4, K) x y vx vy
  bool* arrived_out;      // (B,)
  float* metrics;         // (8, B, n_ticks)
  const float* lights;    // (B, 6, L) x y period offset green_frac valid, or null
  const float* t0;        // (B,) cycle start time, or null
  float* mpc_z_out;       // (B, nu) MPC only
  float* mpc_ud_out;      // (B, nu)
  int* admm_out;          // (B,) ticks that ran the box ADMM
  const float* gpx;       // traffic: (B, NG) global path x
  const float* gpy;       // (B, NG) y
  const float* gpth;      // (B, NG) theta
  const int* nidx;        // traffic: (B, K) NPC match indices
  const float* lane_off;  // (B, K) lane offsets
  const float* lane_tgt;  // (B, K) lane targets
  const bool* agent;      // (B, K) agent slots
  int* nidx_out;          // traffic: (B, K) NPC match indices
  float* off_out;         // (B, K) lane offsets
  float* tgt_out;         // (B, K) lane targets
  int B, K, NP, ND, NB, n_ticks, n_tab, L;
  int substeps, raw, nu, mpc_iters, NG;
  float f[F_COUNT];
};

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// jnp.maximum(v, lo) / torch.clamp(v, min=lo): a NaN v passes through
__device__ __forceinline__ float max_nan(float v, float lo) { return v < lo ? lo : v; }

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

// One MPC tick of lane `tid` (lateral.mpc_steer_table): rows r0 = table[i0],
// r1 = table[i0 + 1], weight wf; the lane's vectors live lane-minor in shared
// memory (element k of lane t at [k * THREADS + t]). Returns the unclipped
// steer; updates (z, u_d) and counts an ADMM tick.
__device__ float mpc_tick(const float* r0, const float* r1, float wf, float e0,
                          float e1, float e2, float e3, float km, int nu, int iters,
                          float* sM, float* sZ, float* sUd, float* sF, float* sV,
                          float* sU, int tid, int& admm_ticks) {
  const int oG1 = nu * nu, og2 = oG1 + 4 * nu, oW1 = og2 + nu, ow2 = oW1 + 4 * nu;
  const float om = 1.f - wf;
  bool interior = true;
  for (int i = 0; i < nu; ++i) {
    const float* p0 = r0 + oW1 + 4 * i;
    const float* p1 = r1 + oW1 + 4 * i;
    float u = (p0[0] * om + p1[0] * wf) * e0;
    u = u + (p0[1] * om + p1[1] * wf) * e1;
    u = u + (p0[2] * om + p1[2] * wf) * e2;
    u = u + (p0[3] * om + p1[3] * wf) * e3;
    u = u + km * (r0[ow2 + i] * om + r1[ow2 + i] * wf);
    sU[i * THREADS + tid] = u;
    interior = interior && fabsf(u) <= 1.f;
  }
  if (interior) {
    for (int i = 0; i < nu; ++i) {
      sZ[i * THREADS + tid] = sU[i * THREADS + tid];
      sUd[i * THREADS + tid] = 0.f;
    }
    return sU[tid];
  }
  ++admm_ticks;
  for (int i = 0; i < nu; ++i) {
    const float* p0 = r0 + oG1 + 4 * i;
    const float* p1 = r1 + oG1 + 4 * i;
    float g = (p0[0] * om + p1[0] * wf) * e0;
    g = g + (p0[1] * om + p1[1] * wf) * e1;
    g = g + (p0[2] * om + p1[2] * wf) * e2;
    g = g + (p0[3] * om + p1[3] * wf) * e3;
    g = g + km * (r0[og2 + i] * om + r1[og2 + i] * wf);
    sF[i * THREADS + tid] = 2.f * g;
  }
  for (int k = 0; k < nu * nu; ++k) sM[k * THREADS + tid] = r0[k] * om + r1[k] * wf;
  for (int it = 0; it < iters; ++it) {
    // v = rho (z - u_d) - f with rho = 1
    for (int j = 0; j < nu; ++j) {
      const int o = j * THREADS + tid;
      sV[o] = (sZ[o] - sUd[o]) - sF[o];
    }
    for (int i = 0; i < nu; ++i) {
      const float* Mi = sM + i * nu * THREADS + tid;
      float x = Mi[0] * sV[tid];
      for (int j = 1; j < nu; ++j) x = x + Mi[j * THREADS] * sV[j * THREADS + tid];
      const int o = i * THREADS + tid;
      const float zn = clip(x + sUd[o], -1.f, 1.f);
      sUd[o] = (sUd[o] + x) - zn;
      sZ[o] = zn;
    }
  }
  return sZ[tid];
}

// ---- NPC agents (traffic branch, sim/npc.py) ----

// One corridor of slot k: the others' offsets in the NPC's heading frame
// (ck, sk) about its position shifted by `shift` along the normal (-sk, ck):
// others - (npc + shift * n), the JAX form of npc.lead_info / corridor_free.
struct Corridor {
  float cx, cy, ck, sk;
  __device__ Corridor(float xk, float yk, float ck_, float sk_, float shift)
      : cx(xk + shift * -sk_), cy(yk + shift * ck_), ck(ck_), sk(sk_) {}
  __device__ __forceinline__ void frame(float ox, float oy, float& dl, float& dlat) const {
    const float dx = ox - cx, dy = oy - cy;
    dl = dx * ck + dy * sk;
    dlat = -dx * sk + dy * ck;
  }
};

// npc.lead_info: the nearest actor ahead within |lateral| < 2 among the
// other valid slots (as they stood at the start of the tick) and the ego;
// the first minimum wins, so a slot beats the ego on an exact tie. Nothing
// ahead: gap 1e4, speed 100.
__device__ void npc_lead(const Corridor& c, int k, int K, unsigned vmask, const float* sX,
                         const float* sY, const float* sSP, float ex, float ey, float espd,
                         int tid, float& gap, float& v) {
  gap = INFINITY;
  v = 0.f;
  for (int j = 0; j < K; ++j) {
    if (j == k || !((vmask >> j) & 1u)) continue;
    float dl, dlat;
    c.frame(sX[j * THREADS + tid], sY[j * THREADS + tid], dl, dlat);
    if (dl > 0.5f && fabsf(dlat) < 2.0f && dl < gap) {
      gap = dl;
      v = sSP[j * THREADS + tid];
    }
  }
  float dl, dlat;
  c.frame(ex, ey, dl, dlat);
  if (dl > 0.5f && fabsf(dlat) < 2.0f && dl < gap) {
    gap = dl;
    v = espd;
  }
  if (!(gap < INFINITY)) {
    gap = 1e4f;
    v = 100.f;
  }
}

// npc.corridor_free: no other valid slot nor the ego within [-8, 20) m
// along and |lateral| < 1.8 m of the corridor
__device__ bool npc_corridor_free(const Corridor& c, int k, int K, unsigned vmask,
                                  const float* sX, const float* sY, float ex, float ey,
                                  int tid) {
  bool occ = false;
  for (int j = 0; j < K; ++j) {
    if (j == k || !((vmask >> j) & 1u)) continue;
    float dl, dlat;
    c.frame(sX[j * THREADS + tid], sY[j * THREADS + tid], dl, dlat);
    occ = occ || (dl > -8.f && dl < 20.f && fabsf(dlat) < 1.8f);
  }
  float dl, dlat;
  c.frame(ex, ey, dl, dlat);
  occ = occ || (dl > -8.f && dl < 20.f && fabsf(dlat) < 1.8f);
  return !occ;
}

// traffic_light.stop_distance of an NPC (vx = its speed, vy = 0): the
// nearest red stop line ahead in its corridor, +inf when none
__device__ float npc_stop_distance(const float* F, const float* tl, int L, float t_abs,
                                   float xk, float yk, float phik, float ck, float sk,
                                   float spk) {
  const float vxw = spk * ck - 0.f * sk;
  const float vyw = 0.f * ck + spk * sk;
  const float spd = max_nan(hypot_j(vxw, vyw), 1e-3f);
  const bool slow = spd < 0.5f;
  const float den = slow ? 1.f : spd;
  const float ux = slow ? cosf(phik) : vxw / den;
  const float uy = slow ? sinf(phik) : vyw / den;
  float d = INFINITY;
  for (int l = 0; l < L; ++l) {
    const float per = tl[2 * L + l];
    const float phase = floored_mod(t_abs + tl[3 * L + l], fmaxf(per, 1e-3f));
    const bool red = tl[5 * L + l] > 0.5f && !(phase < tl[4 * L + l] * per);
    const float dxl = tl[l] - xk, dyl = tl[L + l] - yk;
    const float dl = dxl * ux + dyl * uy;
    const float dlat = -dxl * uy + dyl * ux;
    if (red && dl > 0.f && fabsf(dlat) < F[F_STOP_LAT]) d = fminf(d, dl);
  }
  return d;
}

// One NPC tick of every slot of lane `tid` (closed_loop._advance_npcs):
// slew every lane offset; each live agent slot then reads the other slots
// from the tick-start copy (sn[N_X .. N_SP]) and the ego at its new pose,
// and writes its new state to sn[N_NX .. N_NVY] (a simultaneous update);
// walker, static and invalid slots move at constant velocity. The agent:
// own-lane and target-lane leads, the red stop line as a stationary lead,
// three corridor checks, the lane decision, the 32-row forward first-minimum
// match, the speed-scaled look-ahead row, pure pursuit, IDM and the
// kinematic bicycle.
__device__ void npc_advance(const float* F, int K, int NG, const float* gx, const float* gy,
                            const float* gth, unsigned vmask, unsigned amask, float ex,
                            float ey, float espd, const float* tl, int L, float t_abs,
                            float* sn, int* sIdx, int tid) {
  const int P = KMAX * THREADS;  // one per-slot array
  float *sX = sn + N_X * P, *sY = sn + N_Y * P, *sVX = sn + N_VX * P, *sVY = sn + N_VY * P;
  float *sSP = sn + N_SP * P, *sOff = sn + N_OFF * P, *sTgt = sn + N_TGT * P;
  const float dt = F[F_DT];
  const float step = F[F_LANE_STEP];
  for (int k = 0; k < K; ++k) {
    const int o = k * THREADS + tid;
    sOff[o] = sOff[o] + clip(sTgt[o] - sOff[o], -step, step);
  }
  const float lane_w = F[F_LANE_W];
  for (int k = 0; k < K; ++k) {
    const int o = k * THREADS + tid;
    const float xk = sX[o], yk = sY[o], vxk = sVX[o], vyk = sVY[o];
    if (!((amask >> k) & 1u)) {
      sn[N_NX * P + o] = xk + vxk * dt;
      sn[N_NY * P + o] = yk + vyk * dt;
      sn[N_NVX * P + o] = vxk;
      sn[N_NVY * P + o] = vyk;
      continue;
    }
    const float spk = sSP[o];
    const float phik = spk > 0.1f ? atan2f(vyk, vxk) : 0.f;
    const float ck = cosf(phik), sk = sinf(phik);
    // the lateral offset from the path at the carried index (clamped into
    // the path for memory safety; the carried index is always inside it)
    const int idx_k = sIdx[o];
    const int ic = min(max(idx_k, 0), NG - 1);
    const float th_i = gth[ic];
    const float l_now = -(xk - gx[ic]) * sinf(th_i) + (yk - gy[ic]) * cosf(th_i);
    const float tgt_k = sTgt[o];

    float gap_own, v_own, gap_tgt, v_tgt;
    npc_lead(Corridor(xk, yk, ck, sk, -l_now), k, K, vmask, sX, sY, sSP, ex, ey, espd, tid,
             gap_own, v_own);
    npc_lead(Corridor(xk, yk, ck, sk, tgt_k - l_now), k, K, vmask, sX, sY, sSP, ex, ey,
             espd, tid, gap_tgt, v_tgt);
    if (L > 0) {
      const float d_light = npc_stop_distance(F, tl, L, t_abs, xk, yk, phik, ck, sk, spk);
      v_tgt = d_light < gap_tgt ? 0.f : v_tgt;
      gap_tgt = fminf(gap_tgt, d_light);
    }
    const bool left_free = npc_corridor_free(Corridor(xk, yk, ck, sk, lane_w - l_now), k, K,
                                             vmask, sX, sY, ex, ey, tid);
    const bool right_free = npc_corridor_free(Corridor(xk, yk, ck, sk, -lane_w - l_now), k,
                                              K, vmask, sX, sY, ex, ey, tid);
    const bool own_free = npc_corridor_free(Corridor(xk, yk, ck, sk, -l_now), k, K, vmask,
                                            sX, sY, ex, ey, tid);

    // npc.lane_change_decision
    const float press = F[F_P_MIND] + spk * F[F_P_SAFET];
    const bool blocked = gap_own < 1.5f * press && v_own < 0.8f * F[F_P_MAXSPD];
    const bool in_lane = fabsf(tgt_k) < 0.1f;
    const bool go_left = blocked && in_lane && left_free;
    const bool go_right = blocked && in_lane && !left_free && right_free;
    float tgt_new = go_left ? lane_w : (go_right ? -lane_w : tgt_k);
    if (!in_lane && own_free && !blocked) tgt_new = 0.f;

    // npc.npc_step: forward-windowed first-minimum match
    const int lo = min(max(idx_k, 0), max(NG - 32, 0));
    const int hi = min(lo + 32, NG);
    float best = INFINITY;
    int idx2 = 0;
    for (int r = lo; r < hi; ++r) {
      const float dx = gx[r] - xk, dy = gy[r] - yk;
      const float d = dx * dx + dy * dy;
      if (d < best) {
        best = d;
        idx2 = r;
      }
    }
    const int look = min(max(idx2 + 2 + (int)(spk * 0.25f), 0), NG - 1);
    const float th_l = gth[look];
    const float off = sOff[o];
    const float dxp = (gx[look] - off * sinf(th_l)) - xk;
    const float dyp = (gy[look] + off * cosf(th_l)) - yk;
    float alpha = atan2f(dyp, dxp) - phik;
    alpha = atan2f(sinf(alpha), cosf(alpha));
    const float ld = max_nan(hypot_j(dxp, dyp), 1.f);
    const float delta = atan2f(F[F_TWO_L] * sinf(alpha), ld);
    const float steer = clip(delta / F[F_MAX_STEER], -1.f, 1.f);
    // npc.idm_accel
    const float den = 2.f * sqrtf(F[F_P_ACC] * F[F_P_DEC]);
    const float s_star =
        F[F_P_MIND] + max_nan(spk * F[F_P_SAFET] + spk * (spk - v_tgt) / den, 0.f);
    const float r = spk / max_nan(F[F_P_MAXSPD], 0.1f);
    const float q = s_star / max_nan(gap_tgt, 0.5f);
    const float acc = clip(F[F_P_ACC] * ((1.f - (r * r) * (r * r)) - q * q), -F[F_P_DEC],
                           F[F_P_ACC]);
    // kinematic bicycle, no actuator lag
    const float v2 = max_nan(spk + acc * dt, 0.f);
    const float om2 = v2 * tanf(steer * F[F_MAX_STEER]) / F[F_AB];
    const float phi2 = phik + om2 * dt;
    const float c2 = cosf(phi2), s2 = sinf(phi2);
    sn[N_NX * P + o] = xk + v2 * c2 * dt;
    sn[N_NY * P + o] = yk + v2 * s2 * dt;
    sn[N_NVX * P + o] = v2 * c2;
    sn[N_NVY * P + o] = v2 * s2;
    sIdx[o] = idx2;
    sTgt[o] = tgt_new;
  }
}

template <bool MPC, bool DYN, bool GENERAL, bool TRAFFIC = false>
__global__ void __launch_bounds__(THREADS) tick_kernel(TickArgs a) {
  __shared__ float s_tab[MPC ? 1 : TABMAX * 4];
  __shared__ float s_npc[TRAFFIC ? N_COUNT * KMAX * THREADS : 1];
  __shared__ int s_nidx[TRAFFIC ? KMAX * THREADS : 1];
  extern __shared__ float4 dsm4[];
  float* dsm = reinterpret_cast<float*>(dsm4);
  const int nu = MPC ? a.nu : 0;
  const int R = nu * nu + 10 * nu;  // floats per MPC table row
  if constexpr (MPC) {
    for (int e = threadIdx.x; e < a.n_tab * R; e += blockDim.x) dsm[e] = a.tab[e];
  } else {
    for (int e = threadIdx.x; e < a.n_tab * 4; e += blockDim.x) s_tab[e] = a.tab[e];
  }
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int tid = threadIdx.x;
  const float* F = a.f;
  const int K = a.K, NP = a.NP, ND = a.ND, NB = a.NB;
  const int substeps = GENERAL ? a.substeps : 1;
  const bool raw = GENERAL ? (a.raw != 0) : false;
  const float dts = GENERAL ? F[F_DT_SUB] : F[F_DT];

  // per-lane MPC vectors after the tables, lane-minor
  float* sM = dsm + a.n_tab * R;          // [nu*nu][THREADS] lerped Minv
  float* sZ = sM + nu * nu * THREADS;     // [nu][THREADS]
  float* sUd = sZ + nu * THREADS;
  float* sF = sUd + nu * THREADS;
  float* sV = sF + nu * THREADS;
  float* sU = sV + nu * THREADS;
  int admm_ticks = 0;
  if constexpr (MPC) {
    for (int i = 0; i < nu; ++i) {
      sZ[i * THREADS + tid] = 0.f;
      sUd[i * THREADS + tid] = 0.f;
    }
  }

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

  // traffic: the lane's global path, its NPC lane state and match indices in
  // shared memory, the valid and live-agent slots as bit masks
  const int NG = TRAFFIC ? a.NG : 0;
  const size_t gb = (size_t)b * NG, nb = (size_t)b * K;
  const float* gx = TRAFFIC ? a.gpx + gb : nullptr;
  const float* gy = TRAFFIC ? a.gpy + gb : nullptr;
  const float* gth = TRAFFIC ? a.gpth + gb : nullptr;
  unsigned vmask = 0u, amask = 0u;
  if constexpr (TRAFFIC) {
    for (int k = 0; k < K; ++k) {
      const int o = k * THREADS + tid;
      s_nidx[o] = a.nidx[nb + k];
      s_npc[N_OFF * KMAX * THREADS + o] = a.lane_off[nb + k];
      s_npc[N_TGT * KMAX * THREADS + o] = a.lane_tgt[nb + k];
      const bool valid = ob[4 * K + k] > 0.5f;
      vmask |= valid ? 1u << k : 0u;
      amask |= (valid && a.agent[nb + k]) ? 1u << k : 0u;
    }
  }

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

    // lateral control: table lerp weights, predicted-pose tracking error
    const float vxs = vx < 0.f ? fminf(vx, -F[F_MIN_VX]) : fmaxf(vx, F[F_MIN_VX]);
    const float pos = clip((vxs - F[F_TAB_V0]) / F[F_TAB_DV], 0.f, (float)(a.n_tab - 1));
    const int ii = max(0, min((int)pos, a.n_tab - 2));
    const float wf = pos - (float)ii;
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
    const float e_phi = raw ? dph : sd;
    const float s_dot = (vxs * cd - vy * sd) / (1.f - km * e_d);
    const float e_phi_dot = omega - km * s_dot;
    float steer_cmd;
    if constexpr (MPC) {
      // the MPC's u is the normalized steer: no rescale
      const float* r0 = dsm + ii * R;
      steer_cmd = clip(mpc_tick(r0, r0 + R, wf, e_d, e_d_dot, e_phi, e_phi_dot, km, nu,
                                a.mpc_iters, sM, sZ, sUd, sF, sV, sU, tid, admm_ticks),
                       -F[F_STEER_LIMIT], F[F_STEER_LIMIT]);
    } else {
      float kg[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kg[j] = s_tab[ii * 4 + j] * (1.f - wf) + s_tab[(ii + 1) * 4 + j] * wf;
      const float ke = kg[0] * e_d + kg[1] * e_d_dot + kg[2] * e_phi + kg[3] * e_phi_dot;
      const float ff = km * (F[F_AB] - F[F_B] * kg[2] -
                             (F[F_BCF] + F[F_A] * kg[2] / F[F_CR] - F[F_ACR]) *
                                 (F[F_M] * vxs * vxs) / F[F_AB]);
      const float delta_cmd = -ke + ff;
      steer_cmd = clip(delta_cmd / F[F_MAX_STEER], -F[F_STEER_LIMIT], F[F_STEER_LIMIT]);
    }

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

    // plant: `substeps` steps at dts with the steering actuator
    const float accel = thr_g * F[F_MAX_ACCEL] - brk_g * F[F_MAX_BRAKE];
    for (int ss = 0; ss < substeps; ++ss) {
      const float desired = (steer_g - steer_ap) * dts / F[F_TAU_DEN];
      const float change = clip(desired, -F[F_RATE_DT], F[F_RATE_DT]);
      steer_ap = clip(steer_ap + change, -1.f, 1.f);
      const float delta = clip(steer_ap, -1.f, 1.f) * F[F_MAX_STEER];
      if constexpr (DYN) {
        // friction-limited dynamic bicycle (sim/plant.dynamic_step)
        const float vx_safe = max_nan(vx, 0.5f);
        const float alpha_f = (vy + F[F_A] * omega) / vx_safe - delta;
        const float alpha_r = (vy - F[F_B] * omega) / vx_safe;
        const float fyf = clip(F[F_CF] * alpha_f, -F[F_FZF], F[F_FZF]);
        const float fyr = clip(F[F_CR] * alpha_r, -F[F_FZR], F[F_FZR]);
        const float vy_dot = (fyf + fyr) / F[F_M] - vx * omega;
        const float omega_dot = (F[F_A] * fyf - F[F_B] * fyr) / F[F_IZ];
        const float vxn = max_nan(vx + accel * dts, 0.f);
        const bool moving = vxn > 0.1f;
        vy = moving ? vy + vy_dot * dts : 0.f;
        omega = moving ? omega + omega_dot * dts : 0.f;
        phi = phi + omega * dts;
        const float c = cosf(phi), sn = sinf(phi);
        x = x + (vxn * c - vy * sn) * dts;
        y = y + (vy * c + vxn * sn) * dts;
        ax = accel * c;
        ay = accel * sn;
        vx = vxn;
      } else {
        const float v = fmaxf(vx + accel * dts, 0.f);
        omega = v * tanf(delta) / F[F_AB];
        phi = phi + omega * dts;
        const float cph = cosf(phi), sph = sinf(phi);
        x = x + v * cph * dts;
        y = y + v * sph * dts;
        ax = accel * cph;
        ay = accel * sph;
        vx = v;
        vy = 0.f;
      }
    }

    // obstacles advance (traffic: the NPC agents' tick); collision check
    if constexpr (TRAFFIC) {
      const int P = KMAX * THREADS;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K) {
          const int o = k * THREADS + tid;
          s_npc[N_X * P + o] = ox[k];
          s_npc[N_Y * P + o] = oy[k];
          s_npc[N_VX * P + o] = ovx[k];
          s_npc[N_VY * P + o] = ovy[k];
          s_npc[N_SP * P + o] = hypot_j(ovx[k], ovy[k]);
        }
      }
      npc_advance(F, K, NG, gx, gy, gth, vmask, amask, x, y, hypot_j(vx, vy),
                  tl, L, t_cycle + t_rel, s_npc, s_nidx, tid);
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K) {
          const int o = k * THREADS + tid;
          ox[k] = s_npc[N_NX * P + o];
          oy[k] = s_npc[N_NY * P + o];
          ovx[k] = s_npc[N_NVX * P + o];
          ovy[k] = s_npc[N_NVY * P + o];
        }
      }
    }
    bool collided = false;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if constexpr (!TRAFFIC) {
        ox[k] = ox[k] + ovx[k] * dt;
        oy[k] = oy[k] + ovy[k] * dt;
      }
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
  if constexpr (TRAFFIC) {
    float* oo = a.obsxy_out + (size_t)b * 4 * K;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        oo[k] = ox[k];
        oo[K + k] = oy[k];
        oo[2 * K + k] = ovx[k];
        oo[3 * K + k] = ovy[k];
      }
    }
    for (int k = 0; k < K; ++k) {
      const int o = k * THREADS + tid;
      a.nidx_out[nb + k] = s_nidx[o];
      a.off_out[nb + k] = s_npc[N_OFF * KMAX * THREADS + o];
      a.tgt_out[nb + k] = s_npc[N_TGT * KMAX * THREADS + o];
    }
  } else {
    for (int k = 0; k < K; ++k) {
      a.obsxy_out[(size_t)b * 2 * K + k] = ox[k];
      a.obsxy_out[(size_t)b * 2 * K + K + k] = oy[k];
    }
  }
  a.arrived_out[b] = arrived;
  if constexpr (MPC) {
    for (int i = 0; i < nu; ++i) {
      a.mpc_z_out[(size_t)b * nu + i] = sZ[i * THREADS + tid];
      a.mpc_ud_out[(size_t)b * nu + i] = sUd[i * THREADS + tid];
    }
    a.admm_out[b] = admm_ticks;
  }
}

TickArgs unpack(void* const* ptrs, const float* fparams, const int* iparams,
                bool general) {
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
  a.tab = (const float*)ptrs[13];
  a.ego_out = (float*)ptrs[14];
  a.pbuf_out = (float*)ptrs[15];
  a.pcnt_out = (int*)ptrs[16];
  a.plast_out = (float*)ptrs[17];
  a.obsxy_out = (float*)ptrs[18];
  a.arrived_out = (bool*)ptrs[19];
  a.metrics = (float*)ptrs[20];
  a.lights = (const float*)ptrs[21];
  a.t0 = (const float*)ptrs[22];
  a.mpc_z_out = general ? (float*)ptrs[23] : nullptr;
  a.mpc_ud_out = general ? (float*)ptrs[24] : nullptr;
  a.admm_out = general ? (int*)ptrs[25] : nullptr;
  a.B = iparams[0];
  a.K = iparams[1];
  a.NP = iparams[2];
  a.ND = iparams[3];
  a.NB = iparams[4];
  a.n_ticks = iparams[5];
  a.n_tab = iparams[6];
  a.L = iparams[7];
  a.substeps = general ? iparams[10] : 1;
  a.raw = general ? iparams[11] : 0;
  a.nu = general ? iparams[12] : 0;
  a.mpc_iters = general ? iparams[13] : 0;
  a.gpx = a.gpy = a.gpth = nullptr;
  a.nidx = nullptr;
  a.lane_off = a.lane_tgt = nullptr;
  a.agent = nullptr;
  a.nidx_out = nullptr;
  a.off_out = a.tgt_out = nullptr;
  a.NG = 0;
  for (int j = 0; j < F_COUNT; ++j) a.f[j] = fparams[j];
  return a;
}

bool valid_args(const TickArgs& a) {
  return a.K <= KMAX && a.NB <= NBMAX && a.ND >= 2 && a.NP >= 1 && a.n_tab >= 2 &&
         a.L >= 0 && (a.L == 0 || (a.lights != nullptr && a.t0 != nullptr)) &&
         a.substeps >= 1;
}

template <bool MPC, bool DYN, bool TRAFFIC>
int launch_variant(const TickArgs& a, cudaStream_t stream) {
  size_t smem = 0;
  if (MPC) {
    if (a.nu < 1 || a.nu > NUMAX) return (int)cudaErrorInvalidValue;
    smem = sizeof(float) * ((size_t)a.n_tab * (a.nu * a.nu + 10 * a.nu) +
                            (size_t)(a.nu * a.nu + 5 * a.nu) * THREADS);
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&tick_kernel<MPC, DYN, true, TRAFFIC>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  } else if (a.n_tab > TABMAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (a.B + THREADS - 1) / THREADS;
  tick_kernel<MPC, DYN, true, TRAFFIC><<<blocks, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// LQR + kinematic bicycle, one plant step a tick, sin heading error (K3,
// K3-L with lights): iparams (B, K, NP, ND, NB, n_ticks, n_tab, L).
extern "C" int tick_lqr(void* const* ptrs, const float* fparams, const int* iparams,
                        void* stream) {
  TickArgs a = unpack(ptrs, fparams, iparams, false);
  if (!valid_args(a) || a.n_tab > TABMAX) return (int)cudaErrorInvalidValue;
  if (a.B <= 0) return 0;
  const int blocks = (a.B + THREADS - 1) / THREADS;
  tick_kernel<false, false, false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Every controller / plant pair with runtime substeps and heading-error
// convention (K5: MPC, K6: dynamic plant): iparams as tick_lqr's, then
// (mpc, dynamic, substeps, raw_heading_error, nu, mpc_iters); ptrs as
// tick_lqr's, then (mpc_z_out, mpc_ud_out, admm_out).
extern "C" int tick_variant(void* const* ptrs, const float* fparams, const int* iparams,
                            void* stream) {
  TickArgs a = unpack(ptrs, fparams, iparams, true);
  if (!valid_args(a)) return (int)cudaErrorInvalidValue;
  if (a.B <= 0) return 0;
  const bool mpc = iparams[8] != 0, dyn = iparams[9] != 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (mpc) {
    return dyn ? launch_variant<true, true, false>(a, s) : launch_variant<true, false, false>(a, s);
  }
  return dyn ? launch_variant<false, true, false>(a, s) : launch_variant<false, false, false>(a, s);
}

// The agent-traffic branch (K7), every controller / plant pair, with or
// without lights: ptrs and iparams as tick_variant's, then ptrs (global path
// x, y, theta; NPC indices, lane offsets, lane targets, agent flags; their
// three outputs) and iparams (NG); obsxy_out is (B, 4, K).
extern "C" int tick_traffic(void* const* ptrs, const float* fparams, const int* iparams,
                            void* stream) {
  TickArgs a = unpack(ptrs, fparams, iparams, true);
  a.gpx = (const float*)ptrs[26];
  a.gpy = (const float*)ptrs[27];
  a.gpth = (const float*)ptrs[28];
  a.nidx = (const int*)ptrs[29];
  a.lane_off = (const float*)ptrs[30];
  a.lane_tgt = (const float*)ptrs[31];
  a.agent = (const bool*)ptrs[32];
  a.nidx_out = (int*)ptrs[33];
  a.off_out = (float*)ptrs[34];
  a.tgt_out = (float*)ptrs[35];
  a.NG = iparams[14];
  bool null = false;
  for (int j = 26; j < 36; ++j) null |= ptrs[j] == nullptr;
  if (!valid_args(a) || a.NG < 1 || null) return (int)cudaErrorInvalidValue;
  if (a.B <= 0) return 0;
  const bool mpc = iparams[8] != 0, dyn = iparams[9] != 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (mpc) {
    return dyn ? launch_variant<true, true, true>(a, s) : launch_variant<true, false, true>(a, s);
  }
  return dyn ? launch_variant<false, true, true>(a, s) : launch_variant<false, false, true>(a, s);
}
