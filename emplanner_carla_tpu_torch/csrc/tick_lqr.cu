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
// NPC agents (traffic branch, sim/npc.py, see agent_step): after the ego's
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
// the state becomes (u*, 0). The ADMM branch is taken per lane.
//
// What bounds it on the H100: the chain of one tick. The work is small
// (about 3.8 KB in and out per lane, ~9e4 flops per lane and cycle for LQR,
// plus ~3.8e3 per MPC tick that runs the ADMM, ~6e2 a live agent and tick),
// but the ticks of a lane are strictly sequential, so a launch takes at least
// 100 times the latency of one tick's dependent chain: the predicted-pose
// match, the controller, the PID, the plant step and, with agents, each live
// agent's step (its transcendentals, scans and match). One block of 32 lanes
// alone takes about as long as the whole batch: the launch is the chain of
// its slowest lane. Lanes that drive straight along an axis carry subnormal
// heading and steer terms, and a division with a subnormal numerator takes
// the hardware's slow path, several times the fast one; those lanes set
// the launch's time.
//
// What the design does about it: a group of G = 8 adjacent threads of one
// warp serves one lane (a block holds 32 lanes, 256 threads; 4096 lanes are
// 128 blocks of eight warps). Every thread of the group runs the lane's
// scalar chain (ACC, controller, PID, plant) on the same values, so the chain
// needs no broadcast; the loops on it are split across the group and
// combined with __shfl_xor_sync inside the group: the predicted-pose match
// (the lanes' target paths staged in shared memory), the ACC scan and the
// collision check over the obstacle slots (slot k lives in the registers of
// thread k % G), each live agent's five corridor scans (over the owners'
// slots; the owner hands the agent's tick-start state to the group) and its
// 32-row match, and under MPC the rows of u*, of the table lerps and of
// Minv v (each row's dot product stays serial in j, in the plain version's
// order; the group meets at __syncwarp around the shared v). An argmin
// combines (distance, index) pairs, the smaller distance winning and an
// exact tie going to the smaller index, which keeps the first minimum of the
// serial loop; fminf, any and all combine in any order; no float sum changes
// its order. What the next tick does not read leaves the chain: thread g
// keeps tick i's pose when i % G == g, and every G ticks the group computes
// those ticks' lateral errors (one full match each, in parallel) and speeds
// and stores the 8 metric channels, thread g its tick. With the default ki =
// kd = 0 the PID sums no window and takes no derivative quotient (the plain
// version makes the same choice); its error ring lives in shared memory,
// written once a tick, and a separation clears it by forgetting the live
// entries. hypot_j returns max where min/max cannot change it, which keeps
// the kinematic vy = 0 and the straight lanes' subnormal terms out of its
// division; each sine and cosine of one angle come from one sincosf (bit for
// bit the pair sinf, cosf: tests/test_torch_cuda.py). Shared arrays that a
// group reads at consecutive indices start G banks apart from lane to lane.
// The LQR gain table sits in static shared memory, the MPC tables (64 x 264
// floats at nu = 12, 67.6 KB) and each lane's lerped Minv and v in dynamic
// shared memory; the agents' global path is read in place (32 match rows and
// two look-up rows a live agent and tick, L1/L2-resident). The LQR +
// kinematic entry points with one plant step (`tick_lqr`, and `tick_traffic`
// when that is its configuration) keep the step count and the sin heading
// error as compile-time constants. The TPU kernel's 96-row block-shared path
// window, its containment gate, its skip of blocks without a live agent and
// its one-hot row selection are Mosaic scheduling choices with no
// counterpart here.
// The file builds with -fmad=false and uses jnp.hypot's formula, and every
// sum runs in the plain version's order, so the arithmetic matches the plain
// PyTorch loop term for term.
//
// NaN and inf follow the plain version too, so that a poisoned lane (a NaN
// ego, a NaN obstacle, an infinite speed) comes out as it does there. CUDA's
// fmaxf / fminf return the operand that is not NaN, where torch.maximum,
// torch.minimum and torch.clamp (and jnp's) return NaN: wherever a NaN can
// reach a max or a min, the kernel uses max_nan; the fminf / fmaxf
// that remain only ever see operands that passed an ordered comparison (a
// lead's d_long > 0, a stop line's dl > 0, the finite results of those) and
// say so. hypot_j returns NaN for a NaN operand that is not beside an inf, as
// types.hypot does. The first-minimum matches keep torch.argmin's rule: a NaN
// distance is the minimum, the first NaN wins; a distance can be NaN only
// where the query (the ego's predicted pose, an agent) is not finite, so the
// NaN-aware scan runs only then. A float turns into an index only where it
// is a number; a NaN table position takes row 0, as the plain version's
// integer cast, clamped, does on both devices. None of this changes a result
// on finite inputs.
//
// The plan a launch follows must be finite: the target path, the speed
// profile and its time grid. Every caller passes the sanitised plan
// (closed_loop.py's replan: _sanitize of the target, nan_to_num of the speed
// and the times), so the kernel does not scan them; on a non-finite plan it
// need not give the plain version's NaN.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KMAX = 16;     // obstacle slots
constexpr int NBMAX = 64;    // PID buffer depth
constexpr int TABMAX = 256;  // LQR gain-table rows
constexpr int NUMAX = 16;    // MPC decision variables
constexpr int G = 8;         // threads a lane
constexpr int LANES = 32;    // lanes a block
constexpr int THREADS = LANES * G;
constexpr int QS = KMAX / G;   // obstacle slots a thread
constexpr int QU = NUMAX / G;  // MPC rows a thread
constexpr int AGENT_ROWS = 32;

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

// jnp.maximum(v, lo) / torch.clamp(v, min=lo) for a constant lo: a NaN v
// passes through
__device__ __forceinline__ float max_nan(float v, float lo) { return v < lo ? lo : v; }

// jnp.hypot: max * sqrt(1 + (min/max)^2). Where min <= max * 2^-13 the
// square of min/max is below half an ulp of 1, so the result is max itself:
// returning it skips a division that for a zero or subnormal min (the
// kinematic vy = 0, a lane that drives straight along an axis) would take
// the hardware's slow path, several times the fast one. An inf operand
// gives +inf, else a NaN operand NaN (types.hypot; fmaxf / fminf below would
// drop it).
__device__ __forceinline__ float hypot_j(float a, float b) {
  a = fabsf(a);
  b = fabsf(b);
  if (isinf(a) || isinf(b)) return INFINITY;
  if (a != a || b != b) return a + b;
  float hi = fmaxf(a, b), lo = fminf(a, b);
  if (hi == 0.f) return hi;
  if (lo <= hi * 0x1p-13f) return hi;
  float r = lo / hi;
  return hi * sqrtf(1.0f + r * r);
}

// torch.remainder / jnp.mod: the floored modulo
__device__ __forceinline__ float floored_mod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.f && ((r < 0.f) != (b < 0.f))) r += b;
  return r;
}

// ---- the lane group: G adjacent threads of a warp, mask `gm` ----

// (its operands are the leads' d_long > 0 and +inf: never NaN)
__device__ __forceinline__ float group_fmin(float v, unsigned gm) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(gm, v, o, G));
  return v;
}

__device__ __forceinline__ bool group_any(bool p, unsigned gm) {
  return (__ballot_sync(gm, p) & gm) != 0u;
}

// torch.argmin's order of (distance, index): NaN below every number, then
// the smaller distance, an exact tie (or two NaNs) to the smaller index
__device__ __forceinline__ bool argmin_before(float od, int oi, float d, int i) {
  return od != od ? (d == d || oi < i) : (od < d || (od == d && oi < i));
}

// (d, i) -> the group's first (d, i) in argmin_before's order: with each
// thread's own first minimum, the first minimum of the whole loop
__device__ __forceinline__ void group_argmin(float& d, int& i, unsigned gm) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(gm, d, o, G);
    const int oi = __shfl_xor_sync(gm, i, o, G);
    if (argmin_before(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

// group_argmin carrying the winner's value v
__device__ __forceinline__ void group_argmin_v(float& d, int& i, float& v, unsigned gm) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(gm, d, o, G);
    const int oi = __shfl_xor_sync(gm, i, o, G);
    const float ov = __shfl_xor_sync(gm, v, o, G);
    if (argmin_before(od, oi, d, i)) {
      d = od;
      i = oi;
      v = ov;
    }
  }
}

// One step of a serial first minimum in torch.argmin's order: d replaces
// best where it is smaller or NaN; returns true at a NaN, which nothing after
// it replaces (the scan may stop there)
__device__ __forceinline__ bool first_min_step(float d, int j, float& best, int& bi) {
  if (!(d >= best)) {
    best = d;
    bi = j;
    return d != d;
  }
  return false;
}

// first-minimum node of (px, py) among nodes j0, j0 + step, ... < NP of the
// lane's target path (node j at sx[j], sy[j]); (inf, 0) when every distance
// is +inf, as torch.argmin gives index 0 there. The path is finite, so a
// distance is NaN only for a NaN query: the NaN-aware scan runs only then,
// the plain strict scan otherwise.
__device__ __forceinline__ void match_part(const float* sx, const float* sy, int NP, int j0,
                                           int step, float px, float py, float& best,
                                           int& bi) {
  best = INFINITY;
  bi = 0;
  if (px != px || py != py) {
    for (int j = j0; j < NP; j += step) {
      const float dx = sx[j] - px, dy = sy[j] - py;
      if (first_min_step(dx * dx + dy * dy, j, best, bi)) break;
    }
    return;
  }
  for (int j = j0; j < NP; j += step) {
    const float dx = sx[j] - px, dy = sy[j] - py;
    const float d = dx * dx + dy * dy;
    if (d < best) {
      best = d;
      bi = j;
    }
  }
}

// element q of a thread's per-slot registers, q known only at run time
template <int N, class T>
__device__ __forceinline__ T pick(const T (&a)[N], int q) {
  T v = a[0];
#pragma unroll
  for (int j = 1; j < N; ++j) v = q == j ? a[j] : v;
  return v;
}

// One MPC tick of a lane (lateral.mpc_steer_table): rows r0 = table[i0],
// r1 = table[i0 + 1], weight wf. Thread g of the group owns rows g, g + G, ..
// of u*, f, Minv and (z, u_d) (z, ud: its rows' carried state); sM points at
// the lane's lerped Minv, column-major (Minv[i][j] at sM[j * nu + i], so the
// owners of consecutive rows read consecutive banks), sV at its v. Returns
// the unclipped steer on every thread; counts an ADMM tick.
__device__ __forceinline__ float mpc_tick(const float* r0, const float* r1, float wf,
                                          float e0, float e1, float e2, float e3, float km,
                                          int nu, int iters, float (&z)[QU], float (&ud)[QU],
                                          float* sM, float* sV, int g, unsigned gm,
                                          int& admm_ticks) {
  const int oG1 = nu * nu, og2 = oG1 + 4 * nu, oW1 = og2 + nu, ow2 = oW1 + 4 * nu;
  const float om = 1.f - wf;
  float u[QU];
  bool out = false;
#pragma unroll
  for (int m = 0; m < QU; ++m) {
    const int i = g + G * m;
    u[m] = 0.f;
    if (i < nu) {
      const float* p0 = r0 + oW1 + 4 * i;
      const float* p1 = r1 + oW1 + 4 * i;
      float v = (p0[0] * om + p1[0] * wf) * e0;
      v = v + (p0[1] * om + p1[1] * wf) * e1;
      v = v + (p0[2] * om + p1[2] * wf) * e2;
      v = v + (p0[3] * om + p1[3] * wf) * e3;
      v = v + km * (r0[ow2 + i] * om + r1[ow2 + i] * wf);
      u[m] = v;
      out = out || !(fabsf(v) <= 1.f);
    }
  }
  if (!group_any(out, gm)) {
#pragma unroll
    for (int m = 0; m < QU; ++m) {
      z[m] = u[m];
      ud[m] = 0.f;
    }
    return __shfl_sync(gm, u[0], 0, G);
  }
  ++admm_ticks;
  float f[QU];
#pragma unroll
  for (int m = 0; m < QU; ++m) {
    const int i = g + G * m;
    f[m] = 0.f;
    if (i < nu) {
      const float* p0 = r0 + oG1 + 4 * i;
      const float* p1 = r1 + oG1 + 4 * i;
      float v = (p0[0] * om + p1[0] * wf) * e0;
      v = v + (p0[1] * om + p1[1] * wf) * e1;
      v = v + (p0[2] * om + p1[2] * wf) * e2;
      v = v + (p0[3] * om + p1[3] * wf) * e3;
      v = v + km * (r0[og2 + i] * om + r1[og2 + i] * wf);
      f[m] = 2.f * v;
      for (int j = 0; j < nu; ++j) {
        const int k = i * nu + j;
        sM[j * nu + i] = r0[k] * om + r1[k] * wf;
      }
    }
  }
  for (int it = 0; it < iters; ++it) {
    // v = rho (z - u_d) - f with rho = 1
#pragma unroll
    for (int m = 0; m < QU; ++m) {
      const int i = g + G * m;
      if (i < nu) sV[i] = (z[m] - ud[m]) - f[m];
    }
    __syncwarp(gm);
#pragma unroll
    for (int m = 0; m < QU; ++m) {
      const int i = g + G * m;
      if (i < nu) {
        float x = sM[i] * sV[0];
        for (int j = 1; j < nu; ++j) x = x + sM[j * nu + i] * sV[j];
        const float zn = clip(x + ud[m], -1.f, 1.f);
        ud[m] = (ud[m] + x) - zn;
        z[m] = zn;
      }
    }
    __syncwarp(gm);
  }
  return __shfl_sync(gm, z[0], 0, G);
}

// ---- NPC agents (traffic branch, sim/npc.py) ----

// One corridor of an NPC: the others' offsets in the NPC's heading frame
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

// npc.lead_info, one actor (index j, speed v) into a running first minimum:
// ahead of 0.5 m within |lateral| < 2
__device__ __forceinline__ void lead_visit(const Corridor& c, float ox, float oy, float v,
                                           int j, float& gap, int& gi, float& gv) {
  float dl, dlat;
  c.frame(ox, oy, dl, dlat);
  if (dl > 0.5f && fabsf(dlat) < 2.0f && dl < gap) {
    gap = dl;
    gi = j;
    gv = v;
  }
}

// npc.corridor_free, one actor: within [-8, 20) m along, |lateral| < 1.8 m
__device__ __forceinline__ bool occupies(const Corridor& c, float ox, float oy) {
  float dl, dlat;
  c.frame(ox, oy, dl, dlat);
  return dl > -8.f && dl < 20.f && fabsf(dlat) < 1.8f;
}

// traffic_light.stop_distance of an NPC (vx = its speed, vy = 0, heading
// cosine ck and sine sk): the nearest red stop line ahead in its corridor,
// +inf when none
__device__ float npc_stop_distance(const float* F, const float* tl, int L, float t_abs,
                                   float xk, float yk, float ck, float sk, float spk) {
  const float vxw = spk * ck - 0.f * sk;
  const float vyw = 0.f * ck + spk * sk;
  const float spd = max_nan(hypot_j(vxw, vyw), 1e-3f);
  const bool slow = spd < 0.5f;
  const float den = slow ? 1.f : spd;
  const float ux = slow ? ck : vxw / den;
  const float uy = slow ? sk : vyw / den;
  float d = INFINITY;
  for (int l = 0; l < L; ++l) {
    const float per = tl[2 * L + l];
    const float phase = floored_mod(t_abs + tl[3 * L + l], max_nan(per, 1e-3f));
    const bool red = tl[5 * L + l] > 0.5f && !(phase < tl[4 * L + l] * per);
    const float dxl = tl[l] - xk, dyl = tl[L + l] - yk;
    const float dl = dxl * ux + dyl * uy;
    const float dlat = -dxl * uy + dyl * ux;
    // dl > 0: no NaN reaches the min
    if (red && dl > 0.f && fabsf(dlat) < F[F_STOP_LAT]) d = fminf(d, dl);
  }
  return d;
}

// A thread's obstacle slots k = g + G * q, q < QS (x, y, vx, vy, validity)
// and, with agents, their lane offsets, lane targets and match indices.
struct Slots {
  float x[QS], y[QS], vx[QS], vy[QS];
  bool valid[QS];
  float off[QS], tgt[QS];
  int idx[QS];
};

// One NPC tick of a lane's slots (closed_loop._advance_npcs), by the whole
// group: every slot's lane offset slews; the owner of each live agent slot
// hands its tick-start state to the group, which runs the agent: its five
// corridor scans over the owners' slots (as they stood at the start of the
// tick) and the ego at its new pose (ex, ey, espd), its 32-row match split
// over the rows, the rest on every thread; the owner keeps the new state.
// Walker, static and invalid slots move at constant velocity.
__device__ __forceinline__ void agent_step(const float* F, int K, int NG, const float* gx,
                                           const float* gy, const float* gth, unsigned amask,
                                           float ex, float ey, float espd, const float* tl,
                                           int L, float t_abs, Slots& s, int g, unsigned gm) {
  const float dt = F[F_DT];
  const float step = F[F_LANE_STEP];
  const float lane_w = F[F_LANE_W];
  float sp[QS], nx[QS], ny[QS], nvx[QS], nvy[QS];
#pragma unroll
  for (int q = 0; q < QS; ++q) {
    sp[q] = hypot_j(s.vx[q], s.vy[q]);
    s.off[q] = s.off[q] + clip(s.tgt[q] - s.off[q], -step, step);
    nx[q] = s.x[q] + s.vx[q] * dt;
    ny[q] = s.y[q] + s.vy[q] * dt;
    nvx[q] = s.vx[q];
    nvy[q] = s.vy[q];
  }
  for (unsigned am = amask; am != 0u; am &= am - 1u) {
    const int k = __ffs((int)am) - 1;
    const int owner = k % G, qk = k / G;
    const float xk = __shfl_sync(gm, pick(s.x, qk), owner, G);
    const float yk = __shfl_sync(gm, pick(s.y, qk), owner, G);
    const float vxk = __shfl_sync(gm, pick(s.vx, qk), owner, G);
    const float vyk = __shfl_sync(gm, pick(s.vy, qk), owner, G);
    const float spk = __shfl_sync(gm, pick(sp, qk), owner, G);
    const float tgt_k = __shfl_sync(gm, pick(s.tgt, qk), owner, G);
    const float off = __shfl_sync(gm, pick(s.off, qk), owner, G);
    const int idx_k = __shfl_sync(gm, pick(s.idx, qk), owner, G);

    const float phik = spk > 0.1f ? atan2f(vyk, vxk) : 0.f;
    float ck, sk;
    sincosf(phik, &sk, &ck);
    // the lateral offset from the path at the carried index (clamped into
    // the path for memory safety; the carried index is always inside it)
    const int ic = min(max(idx_k, 0), NG - 1);
    float s_i, c_i;
    sincosf(gth[ic], &s_i, &c_i);
    const float l_now = -(xk - gx[ic]) * s_i + (yk - gy[ic]) * c_i;

    // own-lane and target-lane leads, the three corridors: each thread over
    // its slots, then the ego (after every slot, as in the serial scan)
    const Corridor c_own(xk, yk, ck, sk, -l_now), c_tgt(xk, yk, ck, sk, tgt_k - l_now);
    const Corridor c_left(xk, yk, ck, sk, lane_w - l_now);
    const Corridor c_right(xk, yk, ck, sk, -lane_w - l_now);
    float gap_own = INFINITY, v_own = 0.f, gap_tgt = INFINITY, v_tgt = 0.f;
    int i_own = KMAX, i_tgt = KMAX;
    bool occ_l = false, occ_r = false, occ_o = false;
#pragma unroll
    for (int q = 0; q < QS; ++q) {
      const int j = g + G * q;
      if (j < K && j != k && s.valid[q]) {
        lead_visit(c_own, s.x[q], s.y[q], sp[q], j, gap_own, i_own, v_own);
        lead_visit(c_tgt, s.x[q], s.y[q], sp[q], j, gap_tgt, i_tgt, v_tgt);
        occ_l = occ_l || occupies(c_left, s.x[q], s.y[q]);
        occ_r = occ_r || occupies(c_right, s.x[q], s.y[q]);
        occ_o = occ_o || occupies(c_own, s.x[q], s.y[q]);
      }
    }
    lead_visit(c_own, ex, ey, espd, KMAX, gap_own, i_own, v_own);
    lead_visit(c_tgt, ex, ey, espd, KMAX, gap_tgt, i_tgt, v_tgt);
    occ_l = occ_l || occupies(c_left, ex, ey);
    occ_r = occ_r || occupies(c_right, ex, ey);
    occ_o = occ_o || occupies(c_own, ex, ey);
    group_argmin_v(gap_own, i_own, v_own, gm);
    group_argmin_v(gap_tgt, i_tgt, v_tgt, gm);
    // nothing ahead: gap 1e4, speed 100
    if (!(gap_own < INFINITY)) {
      gap_own = 1e4f;
      v_own = 100.f;
    }
    if (!(gap_tgt < INFINITY)) {
      gap_tgt = 1e4f;
      v_tgt = 100.f;
    }
    const bool left_free = !group_any(occ_l, gm);
    const bool right_free = !group_any(occ_r, gm);
    const bool own_free = !group_any(occ_o, gm);
    if (L > 0) {
      const float d_light = npc_stop_distance(F, tl, L, t_abs, xk, yk, ck, sk, spk);
      // both a number or +inf (gaps and stop lines passed ordered tests)
      v_tgt = d_light < gap_tgt ? 0.f : v_tgt;
      gap_tgt = fminf(gap_tgt, d_light);
    }

    // npc.lane_change_decision
    const float press = F[F_P_MIND] + spk * F[F_P_SAFET];
    const bool blocked = gap_own < 1.5f * press && v_own < 0.8f * F[F_P_MAXSPD];
    const bool in_lane = fabsf(tgt_k) < 0.1f;
    const bool go_left = blocked && in_lane && left_free;
    const bool go_right = blocked && in_lane && !left_free && right_free;
    float tgt_new = go_left ? lane_w : (go_right ? -lane_w : tgt_k);
    if (!in_lane && own_free && !blocked) tgt_new = 0.f;

    // npc.npc_step: forward-windowed first-minimum match, rows split
    const int lo = min(max(idx_k, 0), max(NG - AGENT_ROWS, 0));
    const int hi = min(lo + AGENT_ROWS, NG);
    float best = INFINITY;
    int idx2 = 0;
    bool any_nan = false;
    for (int r = lo + g; r < hi; r += G) {
      const float dx = gx[r] - xk, dy = gy[r] - yk;
      const float d = dx * dx + dy * dy;
      any_nan = any_nan || d != d;
      if (d < best) {
        best = d;
        idx2 = r;
      }
    }
    if (any_nan) {  // torch.argmin's first NaN, which nothing after it replaces
      for (int r = lo + g; r < hi; r += G) {
        const float dx = gx[r] - xk, dy = gy[r] - yk;
        if (first_min_step(dx * dx + dy * dy, r, best, idx2)) break;
      }
    }
    group_argmin(best, idx2, gm);
    // a NaN speed looks 2 rows ahead (the conversion of NaN on the card gives
    // 0); it reaches no output, whose position is NaN then
    const int look = min(max(idx2 + 2 + (spk == spk ? (int)(spk * 0.25f) : 0), 0), NG - 1);
    float s_l, c_l;
    sincosf(gth[look], &s_l, &c_l);
    const float dxp = (gx[look] - off * s_l) - xk;
    const float dyp = (gy[look] + off * c_l) - yk;
    float alpha = atan2f(dyp, dxp) - phik;
    float s_a, c_a;
    sincosf(alpha, &s_a, &c_a);
    alpha = atan2f(s_a, c_a);
    const float ld = max_nan(hypot_j(dxp, dyp), 1.f);
    const float delta = atan2f(F[F_TWO_L] * sinf(alpha), ld);
    const float steer = clip(delta / F[F_MAX_STEER], -1.f, 1.f);
    // npc.idm_accel
    const float den = 2.f * sqrtf(F[F_P_ACC] * F[F_P_DEC]);
    const float s_star =
        F[F_P_MIND] + max_nan(spk * F[F_P_SAFET] + spk * (spk - v_tgt) / den, 0.f);
    const float r = spk / max_nan(F[F_P_MAXSPD], 0.1f);
    const float qq = s_star / max_nan(gap_tgt, 0.5f);
    const float acc = clip(F[F_P_ACC] * ((1.f - (r * r) * (r * r)) - qq * qq), -F[F_P_DEC],
                           F[F_P_ACC]);
    // kinematic bicycle, no actuator lag
    const float v2 = max_nan(spk + acc * dt, 0.f);
    const float om2 = v2 * tanf(steer * F[F_MAX_STEER]) / F[F_AB];
    const float phi2 = phik + om2 * dt;
    float c2, s2;
    sincosf(phi2, &s2, &c2);
    if (g == owner) {
#pragma unroll
      for (int q = 0; q < QS; ++q) {
        if (q == qk) {
          nx[q] = xk + v2 * c2 * dt;
          ny[q] = yk + v2 * s2 * dt;
          nvx[q] = v2 * c2;
          nvy[q] = v2 * s2;
          s.idx[q] = idx2;
          s.tgt[q] = tgt_new;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < QS; ++q) {
    s.x[q] = nx[q];
    s.y[q] = ny[q];
    s.vx[q] = nvx[q];
    s.vy[q] = nvy[q];
  }
}

// The 8 metric channels of ticks i0 .. i0 + n - 1: thread g, g < n, holds
// tick i0 + g's pose (x, y, phi, vx, vy) and flags, matches it on the whole
// target path (the lateral error at the new pose) and stores its tick.
__device__ __forceinline__ void store_metrics(float* m_out, size_t plane, int i0, int n,
                                              int g, const float* sx, const float* sy,
                                              const float* tgt, const float* tgk, int NP,
                                              float x, float y, float phi, float vx, float vy,
                                              bool collided, bool arrived, bool ok) {
  if (g >= n) return;
  float best;
  int mj;
  match_part(sx, sy, NP, 0, 1, x, y, best, mj);
  const float xm2 = sx[mj], ym2 = sy[mj], tm2 = tgt[mj], km2 = tgk[mj];
  const float ex = x - xm2, ey = y - ym2;
  float s2, c2;
  sincosf(tm2, &s2, &c2);
  const float ds2 = ex * c2 + ey * s2;
  const float tr2 = tm2 + km2 * ds2;
  sincosf(tr2, &s2, &c2);
  const float lat = -ex * s2 + ey * c2;
  const int i = i0 + g;
  m_out[i] = x;
  m_out[plane + i] = y;
  m_out[2 * plane + i] = 3.6f * hypot_j(vx, vy);
  m_out[3 * plane + i] = lat;
  m_out[4 * plane + i] = phi;
  m_out[5 * plane + i] = collided ? 1.f : 0.f;
  m_out[6 * plane + i] = arrived ? 1.f : 0.f;
  m_out[7 * plane + i] = ok ? 1.f : 0.f;
}

// Per-lane strides of the shared arrays that a group reads at consecutive
// indices: a multiple of 32 floats plus G, so that the lanes of a warp start
// G banks apart and the group's reads fall in distinct banks. The target
// path: x of node j of lane l at [l * path_stride + j], y in a second such
// array; the MPC: the lerped Minv and then v.
__host__ __device__ __forceinline__ int path_stride(int NP) { return (NP + 31) / 32 * 32 + G; }
__host__ __device__ __forceinline__ int mpc_stride(int nu) {
  return (nu * nu + nu + 31) / 32 * 32 + G;
}

// Dynamic shared memory of a block, in floats: the MPC tables, the lanes'
// target path x and y, the MPC lanes' lerped Minv and v.
__host__ __device__ __forceinline__ size_t dyn_floats(int n_tab, int nu, int NP) {
  const size_t tab = nu ? (size_t)n_tab * (nu * nu + 10 * nu) : 0;
  return tab + (size_t)2 * LANES * path_stride(NP) + (nu ? (size_t)LANES * mpc_stride(nu) : 0);
}

template <bool MPC, bool DYN, bool GENERAL, bool TRAFFIC = false>
__global__ void __launch_bounds__(THREADS, 1) tick_kernel(TickArgs a) {
  __shared__ float s_tab[MPC ? 1 : TABMAX * 4];
  __shared__ float s_ring[NBMAX * LANES];  // the lanes' PID error rings, lane-minor
  extern __shared__ float4 dsm4[];
  float* dsm = reinterpret_cast<float*>(dsm4);
  const int nu = MPC ? a.nu : 0;
  const int R = nu * nu + 10 * nu;  // floats per MPC table row
  const int NP = a.NP;
  if constexpr (MPC) {
    for (int e = threadIdx.x; e < a.n_tab * R; e += blockDim.x) dsm[e] = a.tab[e];
  } else {
    for (int e = threadIdx.x; e < a.n_tab * 4; e += blockDim.x) s_tab[e] = a.tab[e];
  }
  const int lane = threadIdx.x / G, g = threadIdx.x % G;
  const int b = blockIdx.x * LANES + lane;
  // the lanes' target path x and y
  const int PS = path_stride(NP);
  float* s_path = dsm + (MPC ? (size_t)a.n_tab * R : 0);
  for (int e = threadIdx.x; e < LANES * 2 * NP; e += blockDim.x) {
    const int l = e / (2 * NP), r = e % (2 * NP);  // r: c * NP + j of the lane's (2, NP) x, y
    const int bl = blockIdx.x * LANES + l;
    if (bl < a.B)
      s_path[(r / NP) * LANES * PS + l * PS + r % NP] = a.target[(size_t)bl * 4 * NP + r];
  }
  __syncthreads();
  if (b >= a.B) return;
  const unsigned gm = ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  const float* F = a.f;
  const int K = a.K, ND = a.ND, NB = a.NB;
  const int substeps = GENERAL ? a.substeps : 1;
  const bool raw = GENERAL ? (a.raw != 0) : false;
  const float dts = GENERAL ? F[F_DT_SUB] : F[F_DT];
  const float* sx = s_path + lane * PS;
  const float* sy = s_path + (size_t)LANES * PS + lane * PS;

  // MPC: the lane's lerped Minv and v after the target paths; this thread's
  // rows of (z, u_d), zeros at cycle start
  float* sM = s_path + (size_t)2 * LANES * PS + (MPC ? lane * mpc_stride(nu) : 0);
  float* sV = sM + nu * nu;
  float mz[QU], mud[QU];
#pragma unroll
  for (int m = 0; m < QU; ++m) mz[m] = mud[m] = 0.f;
  int admm_ticks = 0;

  const float* e0 = a.ego + (size_t)b * 9;
  float x = e0[0], y = e0[1], phi = e0[2], vx = e0[3], vy = e0[4], omega = e0[5];
  float ax = e0[6], ay = e0[7], steer_ap = e0[8];

  // PID error ring: thread 0 of the group writes each tick's error at
  // `head`; the newest `live` entries are the buffer's, older ones read as
  // the zeros a separation left
  float* ring = s_ring + lane;
  for (int j = g; j < NB; j += G) ring[j * LANES] = a.pbuf[(size_t)b * NB + j];
  __syncwarp(gm);
  int head = 0;  // ring index of the oldest entry
  int live = NB;
  int cnt = a.pcnt[b];
  float last = a.plast[b];
  const bool use_sum = F[F_KI] != 0.f, use_deriv = F[F_KD] != 0.f;

  Slots s;
  const float* ob = a.obs + (size_t)b * 5 * K;
  const size_t nb = (size_t)b * K;
#pragma unroll
  for (int q = 0; q < QS; ++q) {
    const int k = g + G * q;
    const bool in = k < K;
    s.x[q] = in ? ob[k] : 0.f;
    s.y[q] = in ? ob[K + k] : 0.f;
    s.vx[q] = in ? ob[2 * K + k] : 0.f;
    s.vy[q] = in ? ob[3 * K + k] : 0.f;
    s.valid[q] = in && ob[4 * K + k] > 0.5f;
    s.off[q] = (TRAFFIC && in) ? a.lane_off[nb + k] : 0.f;
    s.tgt[q] = (TRAFFIC && in) ? a.lane_tgt[nb + k] : 0.f;
    s.idx[q] = (TRAFFIC && in) ? a.nidx[nb + k] : 0;
  }
  const float* spd = a.tspeed + (size_t)b * ND;
  const float* tgt = a.target + (size_t)b * 4 * NP + 2 * NP;
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

  // traffic: the lane's global path and its live-agent slots as a bit mask
  const int NG = TRAFFIC ? a.NG : 0;
  const size_t gb = (size_t)b * NG;
  const float* gx = TRAFFIC ? a.gpx + gb : nullptr;
  const float* gy = TRAFFIC ? a.gpy + gb : nullptr;
  const float* gth = TRAFFIC ? a.gpth + gb : nullptr;
  unsigned amask = 0u;
  if constexpr (TRAFFIC) {
    for (int k = 0; k < K; ++k)
      amask |= (ob[4 * K + k] > 0.5f && a.agent[nb + k]) ? 1u << k : 0u;
  }

  // the tick this thread keeps for the metrics (i % G == g)
  float kx = 0.f, ky = 0.f, kphi = 0.f, kvx = 0.f, kvy = 0.f;
  bool kcoll = false, karr = false;

  for (int i = 0; i < a.n_ticks; ++i) {
    // planned speed at t_rel: uniform hat, two nonzero weights
    const float t_rel = (float)(i + 1) * dt;
    const float u = clip((t_rel - t0) / t_dx, 0.f, (float)(ND - 1));
    const int k0 = min((int)floorf(u), ND - 2);
    const float w0 = fmaxf(0.f, 1.f - fabsf(u - (float)k0));
    const float w1 = fmaxf(0.f, 1.f - fabsf(u - (float)(k0 + 1)));
    float plan_speed = w0 * spd[k0] + w1 * spd[k0 + 1];
    plan_speed = plan_ok ? plan_speed : 0.f;

    // time-headway ACC guard along the motion direction: each thread over
    // its slots, the nearest lead over the group
    float cphi, sphi;
    sincosf(phi, &sphi, &cphi);
    const float vxw = vx * cphi - vy * sphi;
    const float vyw = vy * cphi + vx * sphi;
    const float spd_w = hypot_j(vxw, vyw);
    const bool slow = spd_w < 0.5f;
    const float den = slow ? 1.f : max_nan(spd_w, 1e-3f);
    const float ux = slow ? cphi : vxw / den;
    const float uy = slow ? sphi : vyw / den;
    float d_lead = INFINITY;
#pragma unroll
    for (int q = 0; q < QS; ++q) {
      const float dxo = s.x[q] - x, dyo = s.y[q] - y;
      const float d_long = dxo * ux + dyo * uy;
      const float d_lat = -dxo * uy + dyo * ux;
      if (s.valid[q] && d_long > 0.f && fabsf(d_lat) < 2.f) d_lead = fminf(d_lead, d_long);
    }
    d_lead = group_fmin(d_lead, gm);
    // d_lead is a number or +inf, and so is v_cap
    float v_cap = fmaxf((d_lead - F[F_STANDOFF]) / F[F_HEADWAY], 0.f);
    if (L > 0) {
      // red-light cap: nearest red stop line ahead in the same corridor
      const float t_abs = t_cycle + t_rel;
      float d_stop = INFINITY;
      for (int l = 0; l < L; ++l) {
        const float per = tl[2 * L + l];
        const float phase = floored_mod(t_abs + tl[3 * L + l], max_nan(per, 1e-3f));
        const bool red = tl[5 * L + l] > 0.5f && !(phase < tl[4 * L + l] * per);
        const float dxl = tl[l] - x, dyl = tl[L + l] - y;
        const float dl_long = dxl * ux + dyl * uy;
        const float dl_lat = -dxl * uy + dyl * ux;
        if (red && dl_long > 0.f && fabsf(dl_lat) < F[F_STOP_LAT])
          d_stop = fminf(d_stop, dl_long);
      }
      // d_stop and both caps are numbers or +inf
      v_cap = fminf(v_cap,
                    fmaxf((d_stop - F[F_STOP_STANDOFF]) / F[F_STOP_HEADWAY], 0.f));
    }
    // plan_speed is finite (a finite plan) and v_cap a number or +inf
    const float tick_kmh = 3.6f * fminf(plan_speed, v_cap);

    // lateral control: table lerp weights, predicted-pose tracking error
    const float vxs = vx < 0.f ? fminf(vx, -F[F_MIN_VX]) : max_nan(vx, F[F_MIN_VX]);
    const float pos = clip((vxs - F[F_TAB_V0]) / F[F_TAB_DV], 0.f, (float)(a.n_tab - 1));
    const int ii = pos == pos ? max(0, min((int)pos, a.n_tab - 2)) : 0;
    const float wf = pos - (float)ii;
    const float ts = F[F_TS];
    const float xp = x + (vxs * cphi - vy * sphi) * ts;
    const float yp = y + (vy * cphi + vxs * sphi) * ts;
    const float php = phi + omega * ts;
    float best;
    int mi;
    match_part(sx, sy, NP, g, G, xp, yp, best, mi);
    group_argmin(best, mi, gm);
    const float xm = sx[mi], ym = sy[mi], thm = tgt[mi], km = tgk[mi];
    float tx_, ty_;
    sincosf(thm, &ty_, &tx_);
    const float ddx = xp - xm, ddy = yp - ym;
    const float e_d = -ty_ * ddx + tx_ * ddy;
    const float e_s = tx_ * ddx + ty_ * ddy;
    const float theta_r = thm + km * e_s;
    const float dph = php - theta_r;
    float cd, sd;
    sincosf(dph, &sd, &cd);
    const float e_d_dot = vy * cd + vxs * sd;
    const float e_phi = raw ? dph : sd;
    const float s_dot = (vxs * cd - vy * sd) / (1.f - km * e_d);
    const float e_phi_dot = omega - km * s_dot;
    float steer_cmd;
    if constexpr (MPC) {
      // the MPC's u is the normalized steer: no rescale
      const float* r0 = dsm + ii * R;
      steer_cmd = clip(mpc_tick(r0, r0 + R, wf, e_d, e_d_dot, e_phi, e_phi_dot, km, nu,
                                a.mpc_iters, mz, mud, sM, sV, g, gm, admm_ticks),
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

    // PID with integral separation; the window sum only where ki != 0, the
    // derivative only where kd != 0 (control/pid.py makes the same choice)
    const float err = tick_kmh - 3.6f * hypot_j(vx, vy);
    if (g == 0) ring[head * LANES] = err;
    head = head + 1 == NB ? 0 : head + 1;
    live = min(live + 1, NB);
    cnt = min(cnt + 1, NB);
    const bool have_two = cnt >= 2;
    float integral = 0.f, deriv = 0.f;
    if (have_two && use_sum) {
      __syncwarp(gm);
      float sum = 0.f;
      for (int j = NB - live; j < NB; ++j) {
        const int r = head + j;
        sum += ring[(r >= NB ? r - NB : r) * LANES];
      }
      integral = sum * F[F_PID_DT];
      __syncwarp(gm);  // every read done before thread 0 writes the next tick's
    }
    if (have_two && use_deriv) deriv = (err - last) / F[F_PID_DT];
    if (fabsf(err) > F[F_SEP]) {
      integral = 0.f;
      live = 0;
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
        float c, sn;
        sincosf(phi, &sn, &c);
        x = x + (vxn * c - vy * sn) * dts;
        y = y + (vy * c + vxn * sn) * dts;
        ax = accel * c;
        ay = accel * sn;
        vx = vxn;
      } else {
        const float v = max_nan(vx + accel * dts, 0.f);
        omega = v * tanf(delta) / F[F_AB];
        phi = phi + omega * dts;
        float cph, sph;
        sincosf(phi, &sph, &cph);
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
      agent_step(F, K, NG, gx, gy, gth, amask, x, y, hypot_j(vx, vy), tl, L,
                 t_cycle + t_rel, s, g, gm);
    } else {
#pragma unroll
      for (int q = 0; q < QS; ++q) {
        s.x[q] = s.x[q] + s.vx[q] * dt;
        s.y[q] = s.y[q] + s.vy[q] * dt;
      }
    }
    bool hit = false;
#pragma unroll
    for (int q = 0; q < QS; ++q)
      hit = hit || (s.valid[q] && hypot_j(s.x[q] - x, s.y[q] - y) < coll_r);
    const bool collided = group_any(hit, gm);

    // the metrics, G ticks at a time
    const int slot = i % G;
    if (slot == g) {
      kx = x;
      ky = y;
      kphi = phi;
      kvx = vx;
      kvy = vy;
      kcoll = collided;
      karr = arrived;
    }
    if (slot == G - 1 || i == a.n_ticks - 1)
      store_metrics(m_out, plane, i - slot, slot + 1, g, sx, sy, tgt, tgk, NP, kx, ky, kphi,
                    kvx, kvy, kcoll, karr, feas && plan_ok);
  }

  __syncwarp(gm);
  if (g == 0) {
    float* eo = a.ego_out + (size_t)b * 9;
    eo[0] = x; eo[1] = y; eo[2] = phi; eo[3] = vx; eo[4] = vy; eo[5] = omega;
    eo[6] = ax; eo[7] = ay; eo[8] = steer_ap;
    a.pcnt_out[b] = cnt;
    a.plast_out[b] = last;
    a.arrived_out[b] = arrived;
    if constexpr (MPC) a.admm_out[b] = admm_ticks;
  }
  for (int j = g; j < NB; j += G) {
    const int r = head + j;
    a.pbuf_out[(size_t)b * NB + j] = j >= NB - live ? ring[(r >= NB ? r - NB : r) * LANES] : 0.f;
  }
#pragma unroll
  for (int q = 0; q < QS; ++q) {
    const int k = g + G * q;
    if (k < K) {
      if constexpr (TRAFFIC) {
        float* oo = a.obsxy_out + (size_t)b * 4 * K;
        oo[k] = s.x[q];
        oo[K + k] = s.y[q];
        oo[2 * K + k] = s.vx[q];
        oo[3 * K + k] = s.vy[q];
        a.nidx_out[nb + k] = s.idx[q];
        a.off_out[nb + k] = s.off[q];
        a.tgt_out[nb + k] = s.tgt[q];
      } else {
        a.obsxy_out[(size_t)b * 2 * K + k] = s.x[q];
        a.obsxy_out[(size_t)b * 2 * K + K + k] = s.y[q];
      }
    }
  }
  if constexpr (MPC) {
#pragma unroll
    for (int m = 0; m < QU; ++m) {
      const int i = g + G * m;
      if (i < nu) {
        a.mpc_z_out[(size_t)b * nu + i] = mz[m];
        a.mpc_ud_out[(size_t)b * nu + i] = mud[m];
      }
    }
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
  return a.K <= KMAX && a.NB >= 1 && a.NB <= NBMAX && a.ND >= 2 && a.NP >= 1 &&
         a.n_tab >= 2 && a.L >= 0 && (a.L == 0 || (a.lights != nullptr && a.t0 != nullptr)) &&
         a.substeps >= 1;
}

template <bool MPC, bool DYN, bool GENERAL, bool TRAFFIC>
int launch(const TickArgs& a, cudaStream_t stream) {
  if (MPC && (a.nu < 1 || a.nu > NUMAX)) return (int)cudaErrorInvalidValue;
  if (!MPC && a.n_tab > TABMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * dyn_floats(a.n_tab, MPC ? a.nu : 0, a.NP);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&tick_kernel<MPC, DYN, GENERAL, TRAFFIC>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (a.B + LANES - 1) / LANES;
  tick_kernel<MPC, DYN, GENERAL, TRAFFIC><<<blocks, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool TRAFFIC>
int launch_any(const TickArgs& a, const int* iparams, cudaStream_t s) {
  const bool mpc = iparams[8] != 0, dyn = iparams[9] != 0;
  if (mpc) {
    return dyn ? launch<true, true, true, TRAFFIC>(a, s) : launch<true, false, true, TRAFFIC>(a, s);
  }
  return dyn ? launch<false, true, true, TRAFFIC>(a, s) : launch<false, false, true, TRAFFIC>(a, s);
}

}  // namespace

// LQR + kinematic bicycle, one plant step a tick, sin heading error (K3,
// K3-L with lights): iparams (B, K, NP, ND, NB, n_ticks, n_tab, L).
extern "C" int tick_lqr(void* const* ptrs, const float* fparams, const int* iparams,
                        void* stream) {
  TickArgs a = unpack(ptrs, fparams, iparams, false);
  if (!valid_args(a)) return (int)cudaErrorInvalidValue;
  if (a.B <= 0) return 0;
  return launch<false, false, false, false>(a, (cudaStream_t)stream);
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
  return launch_any<false>(a, iparams, (cudaStream_t)stream);
}

// The agent-traffic branch (K7), every controller / plant pair, with or
// without lights: ptrs and iparams as tick_variant's, then ptrs (global path
// x, y, theta; NPC indices, lane offsets, lane targets, agent flags; their
// three outputs) and iparams (NG); obsxy_out is (B, 4, K). LQR + kinematic
// with one plant step and the sin heading error runs the instantiation with
// those as compile-time constants.
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
  cudaStream_t s = (cudaStream_t)stream;
  if (iparams[8] == 0 && iparams[9] == 0 && a.substeps == 1 && a.raw == 0)
    return launch<false, false, false, true>(a, s);
  return launch_any<true>(a, iparams, s);
}
