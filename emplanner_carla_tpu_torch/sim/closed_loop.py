"""The closed plan-control-step loops on batch-first tensors (counterpart of
``simulate``, ``simulate_full``, ``simulate_traffic``, ``summarize`` and the
tick loops of ``emplanner_carla_tpu/sim/closed_loop.py``).

Each of ``cfg.loop.n_plans`` cycles runs a planning cycle, the path cycle
(``planner/em_planner.plan_path_cycle``, :func:`simulate`) or the full EM
cycle with the S-T speed plan (``plan_full_cycle``, :func:`simulate_full`),
and then ``cfg.loop.plan_every`` control + plant ticks. The tick loop
dispatches on the device: CUDA tensors run the hand-written kernel
``csrc/tick_lqr.cu`` (the port of ``ops/tick_pallas.py run_ticks_batched``),
CPU tensors run :func:`_full_ticks_base`, its plain PyTorch version. Both
loops take optional traffic lights, whose red-light cap the kernel computes
in its lights branch.

Every control and plant variant runs in the kernel: LQR or the condensed
MPC (whose box-ADMM warm state the kernel carries across the cycle's
ticks), the kinematic or the dynamic bicycle, ``substeps`` plant steps a
tick and the raw heading error of the feedforward MPC variant.

:func:`simulate_traffic` drives the NPC slots with the ``sim/npc.py`` agents
(pure pursuit, IDM, lane changes) instead of constant velocity, in either
planning cycle; its tick loop is the kernel's agent-traffic branch (K7) on
the card and :func:`_traffic_ticks_base` on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from emplanner_carla_tpu_torch import cuda
from emplanner_carla_tpu_torch.config import EMConfig
from emplanner_carla_tpu_torch.control import lateral, pid, vehicle
from emplanner_carla_tpu_torch.ops import frenet, interp
from emplanner_carla_tpu_torch.planner import em_planner
from emplanner_carla_tpu_torch.sim import npc, plant, traffic_light
from emplanner_carla_tpu_torch.sim.loop_constants import (
    ACC_HEADWAY, ACC_STANDOFF, COLLISION_RADIUS,
)
from emplanner_carla_tpu_torch.types import (
    EgoState, Obstacles, Path, Tensor, hypot, tdiv, tree_to,
)

# launches of the tick kernel by controller and plant: "tick_lqr" and
# "tick_lqr_lights" count the LQR + kinematic entry point without and with
# traffic lights (K3, K3-L), "tick_{lqr,mpc}_{kinematic,dynamic}" the other
# instantiations (K5: MPC, K6: dynamic plant) and LQR + kinematic with
# substeps > 1 or the raw heading error
launches = {"tick_lqr": 0, "tick_lqr_lights": 0, "tick_lqr_kinematic": 0,
            "tick_lqr_dynamic": 0, "tick_mpc_kinematic": 0, "tick_mpc_dynamic": 0}
# the agent-traffic entry point (K7), by the same scheme
launches.update({"tick_traffic": 0, "tick_traffic_lights": 0,
                 **{f"tick_traffic_{c}_{p}": 0 for c in ("lqr", "mpc")
                    for p in ("kinematic", "dynamic")}})
# the tick kernel's limits (csrc/tick_lqr.cu)
NU_MAX = 16     # MPC decision variables
KMAX = 16       # obstacle slots, every entry point
NB_MAX = 64     # PID buffer depth
TAB_MAX = 256   # LQR gain-table rows
SMEM_BYTES_MAX = 232_448  # shared memory of a block
# the kernel's block: 32 lanes, a lane group of TICK_G threads; its shared
# arrays a lane group reads at consecutive indices start TICK_G banks apart
TICK_LANES, TICK_G = 32, 8


def tick_kernel_smem(n_tab: int, nu: int, NP: int) -> int:
    """Bytes of shared memory a block of the tick kernel takes: the PID
    error rings and the LQR gain table (static), the MPC tables, the lanes'
    target path x and y and the MPC lanes' lerped Minv and v (dynamic)."""
    def stride(n):
        return (n + 31) // 32 * 32 + TICK_G
    floats = NB_MAX * TICK_LANES + (1 if nu else TAB_MAX * 4) \
        + 2 * TICK_LANES * stride(NP)
    if nu:
        floats += n_tab * (nu * nu + 10 * nu) + TICK_LANES * stride(nu * nu + nu)
    return 4 * floats


def check_tick_kernel_limits(K: int, NB: int, n_tab: int, nu: int = 0,
                             NP: int = 0) -> None:
    """Raise ``ValueError`` naming the tick kernel's limit that a launch
    with K obstacle slots, a PID buffer of NB, an n_tab-row LQR or MPC table,
    nu MPC variables (0: LQR) and an NP-node target path is past."""
    if not 0 <= K <= KMAX:
        raise ValueError(f"the tick kernel (csrc/tick_lqr.cu) holds at most {KMAX} "
                         f"obstacle slots, got {K}")
    if not 1 <= NB <= NB_MAX:
        raise ValueError(f"the tick kernel holds a PID buffer of 1..{NB_MAX}, got {NB}")
    if not nu and not 2 <= n_tab <= TAB_MAX:
        raise ValueError(f"the tick kernel holds an LQR gain table of 2..{TAB_MAX} "
                         f"rows, got {n_tab}")
    if nu > NU_MAX:
        raise ValueError(f"the tick kernel holds at most {NU_MAX} MPC variables, got "
                         f"mpc_n * mpc_p = {nu}")
    smem = tick_kernel_smem(n_tab, nu, NP)
    if smem > SMEM_BYTES_MAX:
        raise ValueError(f"the tick kernel's tables and target paths need {smem} bytes "
                         f"of shared memory, more than the {SMEM_BYTES_MAX} a block has "
                         f"({n_tab} table rows, {nu} MPC variables, {NP} path nodes)")


class TickMetrics(NamedTuple):
    """Per-control-tick observability; each field (B, ticks) or, from
    :func:`simulate`, (B, n_plans, plan_every)."""

    x: Tensor
    y: Tensor
    speed_kmh: Tensor
    lateral_err: Tensor   # signed distance to the current target path
    heading: Tensor
    collided: Tensor      # within COLLISION_RADIUS of any valid obstacle
    arrived: Tensor
    feasible: Tensor      # this cycle's plan: DP feasible and finite
    segments_dropped: Tensor  # st_top_m + dp_top_m drops of this tick's cycle


class LoopCarry(NamedTuple):
    ego: EgoState
    ctrl: vehicle.ControllerState
    match_index: Tensor
    obstacles: Obstacles
    arrived: Tensor
    # (path_qp_state, speed_qp_state or None): the planner QPs' ADMM state
    # carried across cycles (the speed QP's in simulate_full only)
    qp_warm: tuple


def _advance_obstacles(obs: Obstacles, dt: float) -> Obstacles:
    """Constant-velocity obstacle motion."""
    return obs._replace(x=obs.x + obs.vx * dt, y=obs.y + obs.vy * dt)


def _all_finite(tree) -> Tensor:
    """(B,) bool: every tensor of the NamedTuple is finite in that row."""
    oks = [torch.isfinite(a).reshape(a.shape[0], -1).all(1) for a in tree]
    return torch.stack(oks, 1).all(1)


def _sanitize(tree):
    """Replace non-finite values so downstream metrics stay finite."""
    items = [torch.nan_to_num(a) for a in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def _motion_dir(ego: EgoState):
    """Unit direction of travel: world velocity, heading below 0.5 m/s."""
    vxw, vyw = ego.v_world
    spd = hypot(vxw, vyw)
    slow = spd < 0.5
    den = torch.where(slow, torch.ones_like(spd), torch.clamp(spd, min=1e-3))
    ux = torch.where(slow, torch.cos(ego.phi), vxw / den)
    uy = torch.where(slow, torch.sin(ego.phi), vyw / den)
    return ux, uy


def _lateral_error(ego: EgoState, target: Path) -> Tensor:
    """Signed distance to the target path at the current pose (B,)."""
    dx = target.x - ego.x[:, None]
    dy = target.y - ego.y[:, None]
    idx = torch.argmin(dx * dx + dy * dy, dim=1, keepdim=True)
    xm = torch.gather(target.x, 1, idx)[:, 0]
    ym = torch.gather(target.y, 1, idx)[:, 0]
    tm = torch.gather(target.theta, 1, idx)[:, 0]
    km = torch.gather(target.kappa, 1, idx)[:, 0]
    ex, ey = ego.x - xm, ego.y - ym
    ds = ex * torch.cos(tm) + ey * torch.sin(tm)
    tr = tm + km * ds
    return -ex * torch.sin(tr) + ey * torch.cos(tr)


class MPCTicks(NamedTuple):
    """The MPC's state after a cycle's ticks, each (B, nu), and (B,) int32
    the number of ticks in which the lane's u* left the box and ran the box
    ADMM (the work the kernel's bound counts)."""

    z: Tensor
    u_d: Tensor
    admm_ticks: Tensor


def _full_ticks_base(ego, pid_buf, pid_cnt, pid_last, obs, tspeed, ttime,
                     target, arrived, feas, plan_ok, dest_x, dest_y,
                     cfg: EMConfig, lights=None, t0=None):
    """One plan cycle's tick loop, plain PyTorch: the semantic definition
    behind the tick kernel. tspeed (B, nd) on the time grid ttime (nd,).
    ``lights`` (a TrafficLights of (B, L), or None) caps each tick's speed
    at the nearest red stop line ahead at absolute time t0 (B,) + t_rel;
    with no valid light the cap is +inf and the loop is the lights-free one.
    Under MPC the box-ADMM warm state starts the cycle at zeros (the
    controller rebind) and is carried from tick to tick.
    Returns (ego', pid_buffer', pid_count', pid_last', obs', arrived',
    TickMetrics of (B, plan_every) without segments_dropped, MPCTicks or
    None under LQR)."""
    dt = cfg.plant.dt
    return _tick_loop(ego, pid_buf, pid_cnt, pid_last, obs, tspeed, ttime,
                      target, arrived, feas, plan_ok, dest_x, dest_y, cfg,
                      lights, t0, lambda ego_n, o, t_abs: _advance_obstacles(o, dt))


def _tick_loop(ego, pid_buf, pid_cnt, pid_last, obs, tspeed, ttime, target,
               arrived, feas, plan_ok, dest_x, dest_y, cfg: EMConfig, lights,
               t0, advance):
    """The tick loop of :func:`_full_ticks_base` with the world's motion
    ``advance(ego', obs, t_abs) -> obs'`` (t_abs None without lights),
    called after the ego's plant step of each tick."""
    lp = cfg.loop
    dt = cfg.plant.dt
    nd = tspeed.shape[-1]
    t_dx = ttime[1] - ttime[0]
    B = ego.x.shape[0]
    mpc = cfg.control.kind == "MPC"
    cs = vehicle.ControllerState(
        pid.PIDState(pid_buf, pid_cnt, pid_last),
        vehicle.mpc_zero_state(cfg.control, B, ego.x.device) if mpc else None,
    )
    admm_ticks = torch.zeros(B, dtype=torch.int32, device=ego.x.device)
    chans = [[] for _ in range(8)]
    for i in range(lp.plan_every):
        t_rel = torch.tensor(float(i + 1), dtype=torch.float32,
                             device=tspeed.device) * dt
        t_abs = None if lights is None else t0 + t_rel
        w = interp.uniform_hat(t_rel[None], ttime[0], t_dx, nd)    # (1, nd)
        plan_speed = (w * tspeed).sum(-1)
        plan_speed = torch.where(plan_ok, plan_speed, 0.0)

        ux, uy = _motion_dir(ego)
        dxo = obs.x - ego.x[:, None]
        dyo = obs.y - ego.y[:, None]
        d_long = dxo * ux[:, None] + dyo * uy[:, None]
        d_lat = -dxo * uy[:, None] + dyo * ux[:, None]
        lead = obs.valid & (d_long > 0.0) & (d_lat.abs() < 2.0)
        d_lead = torch.where(lead, d_long, float("inf")).min(1).values
        v_cap = torch.clamp(tdiv(d_lead - ACC_STANDOFF, ACC_HEADWAY), min=0.0)
        if lights is not None:
            v_cap = torch.minimum(
                v_cap, traffic_light.red_light_cap(ego, lights, t_abs)
            )
        tick_target_kmh = 3.6 * torch.minimum(plan_speed, v_cap)

        steer, throttle, brake, cs, ran = vehicle.control_step(
            ego, target, cs, tick_target_kmh, cfg.vehicle, cfg.control
        )
        if ran is not None:
            admm_ticks += ran.to(torch.int32)
        arrived = arrived | (hypot(ego.x - dest_x, ego.y - dest_y) < lp.arrival_dist)
        stop = arrived | ~plan_ok
        steer = torch.where(stop, 0.0, steer)
        throttle = torch.where(stop, 0.0, throttle)
        brake = torch.where(stop, 1.0, brake)
        ego = plant.step(ego, steer, throttle, brake, cfg.vehicle, cfg.plant)
        obs = advance(ego, obs, t_abs)

        d_obs = hypot(obs.x - ego.x[:, None], obs.y - ego.y[:, None])
        collided = (obs.valid & (d_obs < COLLISION_RADIUS)).any(1)
        for ch, v in zip(chans, (
            ego.x, ego.y, 3.6 * ego.speed, _lateral_error(ego, target),
            ego.phi, collided, arrived, feas & plan_ok,
        )):
            ch.append(v)
    metrics = [torch.stack(ch, 1) for ch in chans]
    p = cs.pid
    mpc_out = MPCTicks(*cs.mpc, admm_ticks) if mpc else None
    return ego, p.buffer, p.count, p.last_error, obs, arrived, metrics, mpc_out


def _need(t: Tensor, shape, dtype, name: str) -> None:
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need a contiguous {dtype} CUDA tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def tick_kernel_name(cfg: EMConfig, lights=None, traffic: bool = False) -> str:
    """The launch counter of the tick kernel instantiation ``cfg`` runs:
    the LQR + kinematic entry point (one plant step a tick, sin heading
    error) counts as "tick_lqr" or, with lights, "tick_lqr_lights"; every
    other configuration as "tick_{lqr,mpc}_{kinematic,dynamic}". With
    ``traffic`` (K7) the names are "tick_traffic", "tick_traffic_lights" and
    "tick_traffic_{lqr,mpc}_{kinematic,dynamic}"."""
    ctrl = "mpc" if cfg.control.kind == "MPC" else "lqr"
    plant_kind = "kinematic" if cfg.plant.kind == "kinematic" else "dynamic"
    if (ctrl, plant_kind) == ("lqr", "kinematic") and cfg.plant.substeps == 1 \
            and not cfg.control.raw_heading_error:
        base = "tick_traffic" if traffic else "tick_lqr"
        return base + "_lights" if lights is not None else base
    return f"{'tick_traffic' if traffic else 'tick'}_{ctrl}_{plant_kind}"


def _kernel_fparams(cfg: EMConfig, v0: float, dv: float,
                    behavior: str = "normal") -> list:
    """The tick kernel's float parameters, in the order of ``csrc/tick_lqr.cu``'s
    F_ enum: host products in float64, rounded to float32 once by ctypes, as
    the JAX package's Python constants are. The last eight are the NPC
    agents' (``behavior``'s preset, lane width, lane slew a tick, twice the
    wheelbase)."""
    vp, cc, pc = cfg.vehicle, cfg.control, cfg.plant
    a, b = vp.a, vp.b
    dt_sub = pc.dt / pc.substeps
    fzf, fzr = plant.axle_force_caps(vp)
    return [
        pc.dt, ACC_STANDOFF, ACC_HEADWAY, cc.min_vx, cc.ts_predict,
        v0, dv, a, b, a + b, b / vp.cf, a / vp.cr, vp.cr, vp.mass,
        vp.max_steer_rad, cc.steer_limit, cc.kp, cc.ki, cc.kd, cc.pid_dt,
        cc.integral_sep_threshold, cfg.loop.arrival_dist, vp.max_accel,
        vp.max_brake_decel, max(vp.steer_tau, dt_sub), vp.steer_rate * dt_sub,
        COLLISION_RADIUS, traffic_light.STOP_STANDOFF, traffic_light.STOP_HEADWAY,
        traffic_light.STOP_LAT_GATE, dt_sub, vp.cf, vp.iz, fzf, fzr,
        *npc.preset_floats(behavior), npc.LANE_WIDTH,
        npc.LANE_CHANGE_RATE * pc.dt, 2.0 * (a + b),
    ]


def run_ticks_kernel(ego, pid_buf, pid_cnt, pid_last, obs, tspeed, ttime,
                     target, arrived, feas, plan_ok, dest_x, dest_y,
                     cfg: EMConfig, lights=None, t0=None):
    """Launch ``csrc/tick_lqr.cu`` for one plan cycle; same contract as
    :func:`_full_ticks_base`. LQR + kinematic with one plant step a tick
    and the sin heading error goes to the kernel's ``tick_lqr`` entry point
    (K3, K3-L), every other configuration to ``tick_variant`` (K5, K6).
    Without lights the kernel skips its lights branch."""
    return _launch_ticks(ego, pid_buf, pid_cnt, pid_last, obs, tspeed, ttime,
                         target, arrived, feas, plan_ok, dest_x, dest_y, cfg,
                         lights, t0, None)


def run_traffic_ticks_kernel(ego, pid_buf, pid_cnt, pid_last, obs, tspeed,
                             ttime, target, arrived, feas, plan_ok, dest_x,
                             dest_y, cfg: EMConfig, traffic: "TrafficInputs",
                             lights=None, t0=None):
    """Launch the tick kernel's agent-traffic entry point ``tick_traffic``
    (K7) for one plan cycle, every controller and plant; same contract as
    :func:`_traffic_ticks_base`."""
    return _launch_ticks(ego, pid_buf, pid_cnt, pid_last, obs, tspeed, ttime,
                         target, arrived, feas, plan_ok, dest_x, dest_y, cfg,
                         lights, t0, traffic)


def _launch_ticks(ego, pid_buf, pid_cnt, pid_last, obs, tspeed, ttime, target,
                  arrived, feas, plan_ok, dest_x, dest_y, cfg: EMConfig, lights,
                  t0, traffic):
    dev = ego.x.device
    B = ego.x.shape[0]
    K = obs.x.shape[1]
    NP = target.x.shape[1]
    ND = tspeed.shape[1]
    NB = pid_buf.shape[1]
    T = cfg.loop.plan_every
    vp, cc = cfg.vehicle, cfg.control
    mpc = cc.kind == "MPC"
    nu = cc.mpc_n * cc.mpc_p if mpc else 0
    check_tick_kernel_limits(K, NB, 2, nu)
    ego_in = torch.stack(list(ego), 1).contiguous()                 # (B, 9)
    obs_in = torch.stack(
        [obs.x, obs.y, obs.vx, obs.vy, obs.valid.to(torch.float32)], 1
    ).contiguous()                                                  # (B, 5, K)
    tgt_in = torch.stack(list(target), 1).contiguous()              # (B, 4, NP)
    dest_x, dest_y = dest_x.contiguous(), dest_y.contiguous()
    if lights is not None:
        L = lights.x.shape[1]
        tl_in = torch.stack(
            [lights.x, lights.y, lights.period, lights.offset,
             lights.green_frac, lights.valid.to(torch.float32)], 1
        ).contiguous()                                              # (B, 6, L)
        t0 = t0.contiguous()
        _need(tl_in, (B, 6, L), torch.float32, "lights")
        _need(t0, (B,), torch.float32, "t0")
        tl_ptrs = [tl_in.data_ptr(), t0.data_ptr()]
    else:
        L, tl_ptrs = 0, [0, 0]
    if mpc:
        v0, dv, tabs = lateral.mpc_tables_on(vp, cc, str(dev))
        table = tabs["packed"]
    else:
        v0, dv, table = lateral.gain_table_on(vp, cc, str(dev))
    check_tick_kernel_limits(K, NB, table.shape[0], nu, NP)
    for t, shp, dt_, nm in (
        (ego_in, (B, 9), torch.float32, "ego"),
        (pid_buf, (B, NB), torch.float32, "pid_buffer"),
        (pid_cnt, (B,), torch.int32, "pid_count"),
        (pid_last, (B,), torch.float32, "pid_last"),
        (tspeed, (B, ND), torch.float32, "traj_speed"),
        (ttime, (ND,), torch.float32, "traj_time"),
        (feas, (B,), torch.bool, "feasible"),
        (plan_ok, (B,), torch.bool, "plan_ok"),
        (arrived, (B,), torch.bool, "arrived"),
        (dest_x, (B,), torch.float32, "dest_x"),
        (dest_y, (B,), torch.float32, "dest_y"),
    ):
        _need(t, shp, dt_, nm)
    f32 = dict(dtype=torch.float32, device=dev)
    ego_out = torch.empty((B, 9), **f32)
    pbuf_out = torch.empty((B, NB), **f32)
    pcnt_out = torch.empty((B,), dtype=torch.int32, device=dev)
    plast_out = torch.empty((B,), **f32)
    # obstacles out: x, y; with traffic also vx, vy
    obs_out = torch.empty((B, 2 if traffic is None else 4, K), **f32)
    arr_out = torch.empty((B,), dtype=torch.bool, device=dev)
    metrics = torch.empty((8, B, T), **f32)
    z_out = torch.empty((B, max(nu, 1)), **f32)
    ud_out = torch.empty_like(z_out)
    admm_out = torch.empty((B,), dtype=torch.int32, device=dev)
    tr_ptrs, tr_ints, behavior = [], [], "normal"
    if traffic is not None:
        gp = traffic.global_path
        NG = gp.x.shape[1]
        # read in place (simulate_traffic hands over contiguous tensors)
        tr_in = [t.contiguous() for t in (
            gp.x, gp.y, gp.theta, traffic.npc_idx, traffic.lane_off,
            traffic.lane_tgt, traffic.agent_slot.expand(B, K))]
        for t, nm, dt_ in zip(tr_in, (
                "global_path.x", "global_path.y", "global_path.theta", "npc_idx",
                "lane_off", "lane_tgt", "agent_slot"), (
                torch.float32, torch.float32, torch.float32, torch.int32,
                torch.float32, torch.float32, torch.bool)):
            _need(t, (B, NG) if nm.startswith("global") else (B, K), dt_, nm)
        idx_out = torch.empty((B, K), dtype=torch.int32, device=dev)
        off_out = torch.empty((B, K), **f32)
        tgt_out = torch.empty((B, K), **f32)
        tr_ptrs = [*tr_in, idx_out, off_out, tgt_out]
        tr_ints = [NG]
        behavior = traffic.behavior

    ptrs = [ego_in, pid_buf, pid_cnt, pid_last, obs_in, tspeed, ttime, tgt_in,
            feas, plan_ok, arrived, dest_x, dest_y, table, ego_out, pbuf_out,
            pcnt_out, plast_out, obs_out, arr_out, metrics]
    p_arr = (ctypes.c_void_p * (len(ptrs) + 5 + len(tr_ptrs)))(
        *[t.data_ptr() for t in ptrs], *tl_ptrs, z_out.data_ptr(),
        ud_out.data_ptr(), admm_out.data_ptr(), *[t.data_ptr() for t in tr_ptrs])
    fparams = _kernel_fparams(cfg, v0, dv, behavior)
    f_arr = (ctypes.c_float * len(fparams))(*fparams)
    name = tick_kernel_name(cfg, lights, traffic is not None)
    i_arr = (ctypes.c_int * (14 + len(tr_ints)))(
        B, K, NP, ND, NB, T, table.shape[0], L, int(mpc),
        int(cfg.plant.kind != "kinematic"), cfg.plant.substeps,
        int(cc.raw_heading_error), nu, cc.mpc_warm_admm_iters, *tr_ints)
    if traffic is not None:
        symbol = "tick_traffic"
    else:
        symbol = "tick_lqr" if name in ("tick_lqr", "tick_lqr_lights") else "tick_variant"
    fn = cuda.function("tick_lqr", symbol, (ctypes.c_void_p,) * 4)
    err = fn(p_arr, f_arr, i_arr, cuda.stream_of(ego_in))
    cuda.check(err, symbol)
    launches[name] += 1

    ego_n = EgoState(*ego_out.unbind(1))
    m = list(metrics.unbind(0))
    for j in (5, 6, 7):
        m[j] = m[j] > 0.5
    mpc_out = MPCTicks(z_out, ud_out, admm_out) if mpc else None
    if traffic is None:
        obs_n = obs._replace(x=obs_out[:, 0], y=obs_out[:, 1])
        return ego_n, pbuf_out, pcnt_out, plast_out, obs_n, arr_out, m, mpc_out
    obs_n = obs._replace(x=obs_out[:, 0], y=obs_out[:, 1], vx=obs_out[:, 2],
                         vy=obs_out[:, 3])
    return (ego_n, pbuf_out, pcnt_out, plast_out, obs_n, arr_out, m, mpc_out,
            idx_out, off_out, tgt_out)


def run_ticks(*args, **kw):
    """The tick loop: the kernel for CUDA tensors, the plain loop on CPU."""
    ego = args[0]
    if ego.x.is_cuda:
        return run_ticks_kernel(*args, **kw)
    return _full_ticks_base(*args, **kw)


def run_traffic_ticks(*args, **kw):
    """The agent-traffic tick loop (K7): the kernel for CUDA tensors, the
    plain loop on CPU."""
    ego = args[0]
    if ego.x.is_cuda:
        return run_traffic_ticks_kernel(*args, **kw)
    return _traffic_ticks_base(*args, **kw)


def _controller_after(buf, cnt, last, mpc) -> vehicle.ControllerState:
    """The controller state a tick loop hands back: PID buffer and, under
    MPC, the last tick's box-ADMM state (z, u_d)."""
    return vehicle.ControllerState(pid.PIDState(buf, cnt, last),
                                   None if mpc is None else (mpc.z, mpc.u_d))


def _cycle_t0(cfg: EMConfig, cycle: int, batch: int, device) -> Tensor:
    """(B,) absolute start time of plan cycle ``cycle``, formed in float32
    as the JAX loop forms it: cycle * plan_every * dt."""
    t = torch.tensor(float(cycle), dtype=torch.float32) * cfg.loop.plan_every \
        * cfg.plant.dt
    return torch.full((batch,), float(t), dtype=torch.float32, device=device)


def _constant_profile(cfg: EMConfig):
    """The path-only loop's constant speed profile on the speed planner's
    time grid: (tspeed value, ttime (nd,)) as float32 NumPy. 3.6*min(v, cap)
    == min(3.6 v, 3.6 cap) exactly, so the tick loop of the full EM cycle
    covers the path-only loop with this profile."""
    nd = cfg.speed.n_dense
    tq = np.arange(nd, dtype=np.float32) * np.float32(
        cfg.speed.n_t * cfg.speed.t_step / (nd - 1)
    )
    v = np.float32(cfg.loop.target_speed_kmh) / np.float32(3.6)
    return v, tq


def simulate(global_path: Path, ego0: EgoState, obstacles0: Obstacles,
             cfg: EMConfig, lights=None, device="cuda"):
    """Run ``cfg.loop.n_plans`` replan cycles of ``cfg.loop.plan_every``
    control ticks for a batch of scenarios. Inputs are batch-first and are
    moved to ``device`` (the card unless the caller asks for the CPU).
    ``lights``: optional ``traffic_light.TrafficLights`` of (B, L); a red
    light ahead caps the target speed to stop at the line. Returns the
    final LoopCarry and TickMetrics of (B, n_plans, plan_every)."""
    global_path = tree_to(global_path, device)
    ego0 = tree_to(ego0, device)
    obstacles0 = tree_to(obstacles0, device)
    lights = tree_to(lights, device)
    lp = cfg.loop
    B = ego0.x.shape[0]
    dest_x = global_path.x[:, -1].contiguous()
    dest_y = global_path.y[:, -1].contiguous()
    v, tq = _constant_profile(cfg)
    ttime = torch.as_tensor(tq, device=device)
    tspeed = torch.full((B, tq.shape[0]), float(v), dtype=torch.float32,
                        device=device)

    carry = LoopCarry(
        ego0,
        vehicle.ControllerState.init(cfg.control, B, device),
        frenet.nearest_index(ego0.x, ego0.y, global_path),
        obstacles0,
        torch.zeros(B, dtype=torch.bool, device=device),
        em_planner.warm_init(cfg, B, device),
    )
    per_cycle = []
    for i in range(lp.n_plans):
        t0 = _cycle_t0(cfg, i, B, device) if lights is not None else None
        carry, metrics = plan_cycle(global_path, carry, cfg, tspeed, ttime,
                                    dest_x, dest_y, lights, t0)
        per_cycle.append(metrics)
    metrics = TickMetrics(*[torch.stack(ch, 1) for ch in zip(*per_cycle)])
    return carry, metrics


class Replan(NamedTuple):
    """What one replan hands the tick loop and the next cycle: the target
    path (sanitized), the speed profile tspeed (B, nd) on the time grid
    ttime (nd,), the DP's feasibility and plan_ok (B,), the cycle's planner
    drops (B,), the match index and the sanitized QP warm states."""

    target: Path
    tspeed: Tensor
    ttime: Tensor
    feasible: Tensor
    plan_ok: Tensor
    dropped: Tensor
    match_index: Tensor
    qp_warm: tuple


def replan(global_path: Path, carry: LoopCarry, cfg: EMConfig, full: bool,
           tspeed: Tensor = None, ttime: Tensor = None) -> Replan:
    """One replan from ``carry``: the path cycle on the constant profile
    (tspeed, ttime), or with ``full`` the full EM cycle on its trajectory's
    speed profile, whose ``plan_ok`` also covers the trajectory's speed and
    time. The carried ADMM states are sanitized: one NaN solve must not
    poison every later cycle's warm start."""
    if not full:
        res = em_planner.plan_path_cycle(
            global_path, carry.ego, carry.obstacles, carry.match_index, cfg,
            qp_warm=carry.qp_warm[0],
        )
        qp_state = tuple(torch.nan_to_num(a).contiguous() for a in res.qp_state)
        return Replan(_sanitize(res.target), tspeed, ttime, res.feasible,
                      _all_finite(res.target), res.obs_dropped, res.match_index,
                      (qp_state, None))
    res = em_planner.plan_full_cycle(
        global_path, carry.ego, carry.obstacles, carry.match_index, cfg,
        qp_warm=carry.qp_warm,
    )
    traj = res.trajectory
    plan_ok = _all_finite(res.path.target) & _all_finite((traj.speed, traj.time))
    qp_warm = tuple(
        tuple(torch.nan_to_num(a).contiguous() for a in st)
        for st in (res.path.qp_state, res.speed_qp_state)
    )
    # densify's time grid is the same for every lane: the tick loop takes it
    # once, (nd,)
    return Replan(_sanitize(res.path.target),
                  torch.nan_to_num(traj.speed).contiguous(),
                  torch.nan_to_num(traj.time[0]).contiguous(), res.path.feasible,
                  plan_ok, res.segments_dropped, res.path.match_index, qp_warm)


def _cycle(global_path: Path, carry: LoopCarry, cfg: EMConfig, full: bool,
           dest_x: Tensor, dest_y: Tensor, lights, t0, tspeed=None, ttime=None,
           traffic=None):
    """A replan and its ticks: (carry', TickMetrics of (B, plan_every), and
    with ``traffic`` (a TrafficInputs) the NPC state after the ticks)."""
    p = replan(global_path, carry, cfg, full, tspeed, ttime)
    cs = carry.ctrl.rebind()  # controller re-instantiation, test_9.py:415
    args = (carry.ego, cs.pid.buffer, cs.pid.count, cs.pid.last_error,
            carry.obstacles, p.tspeed, p.ttime, p.target, carry.arrived,
            p.feasible, p.plan_ok, dest_x, dest_y, cfg)
    if traffic is None:
        out = run_ticks(*args, lights=lights, t0=t0)
    else:
        out = run_traffic_ticks(*args, traffic=traffic, lights=lights, t0=t0)
    ego, buf_n, cnt_n, last_n, obs, arrived, m, mpc = out[:8]
    metrics = TickMetrics(*m, p.dropped[:, None].expand(-1, m[0].shape[1]))
    cs = _controller_after(buf_n, cnt_n, last_n, mpc)
    return LoopCarry(ego, cs, p.match_index, obs, arrived, p.qp_warm), metrics, out[8:]


def plan_cycle(global_path: Path, carry: LoopCarry, cfg: EMConfig,
               tspeed: Tensor, ttime: Tensor, dest_x: Tensor, dest_y: Tensor,
               lights=None, t0=None):
    """One path replan + ``plan_every`` ticks. Returns (carry', TickMetrics
    of (B, plan_every))."""
    return _cycle(global_path, carry, cfg, False, dest_x, dest_y, lights, t0,
                  tspeed, ttime)[:2]


def simulate_full(global_path: Path, ego0: EgoState, obstacles0: Obstacles,
                  cfg: EMConfig, lights=None, record_cycle_states: bool = False,
                  device="cuda"):
    """The full EM closed loop: path + S-T speed planning every replan, the
    controller tracking the trajectory's speed profile at each tick's
    relative time, under the same time-headway guard (and optional traffic
    lights, (B, L)) as :func:`simulate`. Inputs are batch-first and are
    moved to ``device`` (the card unless the caller asks for the CPU).

    Returns (final LoopCarry, TickMetrics of (B, n_plans, plan_every)); with
    ``record_cycle_states`` also the ego state at the start of every plan
    cycle, an EgoState of (B, n_plans)."""
    global_path = tree_to(global_path, device)
    ego0 = tree_to(ego0, device)
    obstacles0 = tree_to(obstacles0, device)
    lights = tree_to(lights, device)
    B = ego0.x.shape[0]
    dest_x = global_path.x[:, -1].contiguous()
    dest_y = global_path.y[:, -1].contiguous()
    carry = LoopCarry(
        ego0,
        vehicle.ControllerState.init(cfg.control, B, device),
        frenet.nearest_index(ego0.x, ego0.y, global_path),
        obstacles0,
        torch.zeros(B, dtype=torch.bool, device=device),
        em_planner.warm_init(cfg, B, device, full=True),
    )
    per_cycle, egos = [], []
    for i in range(cfg.loop.n_plans):
        egos.append(carry.ego)
        t0 = _cycle_t0(cfg, i, B, device) if lights is not None else None
        carry, metrics = full_plan_cycle(global_path, carry, cfg, dest_x,
                                         dest_y, lights, t0)
        per_cycle.append(metrics)
    metrics = TickMetrics(*[torch.stack(ch, 1) for ch in zip(*per_cycle)])
    if record_cycle_states:
        return carry, metrics, EgoState(*[torch.stack(f, 1) for f in zip(*egos)])
    return carry, metrics


def full_plan_cycle(global_path: Path, carry: LoopCarry, cfg: EMConfig,
                    dest_x: Tensor, dest_y: Tensor, lights=None, t0=None):
    """One full EM replan + ``plan_every`` ticks on the trajectory's speed
    profile (see :func:`replan`). Returns (carry', TickMetrics of
    (B, plan_every))."""
    return _cycle(global_path, carry, cfg, True, dest_x, dest_y, lights, t0)[:2]


# ---------------------------------------------------------------------------
# agent traffic: NPC slots driven by the sim/npc.py agents (K7)


class TrafficCarry(NamedTuple):
    loop: LoopCarry
    npc_path_index: Tensor  # (B, K) int32 per-slot NPC match indices
    npc_lane: npc.LaneState  # (B, K)


class TrafficInputs(NamedTuple):
    """The agent-traffic tick loop's world inputs (the TPU kernel's
    ``traffic=`` argument): the global path the NPCs follow, (B, NG); their
    carried match indices (int32), lane offsets and lane targets, (B, K);
    which slots are agents, (B, K) bool; the behaviour preset's name."""

    global_path: Path
    npc_idx: Tensor
    lane_off: Tensor
    lane_tgt: Tensor
    agent_slot: Tensor
    behavior: str


def NPCStateAt(obs: Obstacles, npc_idx: Tensor) -> npc.NPCState:
    """Every obstacle slot as an NPCState, fields (B, K): speed hypot(vx, vy)
    and heading atan2(vy, vx) where the speed is above 0.1 m/s, else 0 (a
    stopped NPC too)."""
    speed = hypot(obs.vx, obs.vy)
    phi = torch.where(speed > 0.1, torch.atan2(obs.vy, obs.vx), 0.0)
    z = torch.zeros_like(speed)
    return npc.NPCState(EgoState(obs.x, obs.y, phi, speed, z, z, z, z, z),
                        npc_idx, obs.valid)


def _npc_stop_distance(npc_ego: EgoState, lights, t_abs: Tensor) -> Tensor:
    """(B, K) distance of each NPC to the nearest red stop line ahead in its
    corridor (``traffic_light.stop_distance`` per slot)."""
    B, K = npc_ego.x.shape
    flat = EgoState(*[f.reshape(B * K) for f in npc_ego])
    rep = type(lights)(*[f.repeat_interleave(K, 0) for f in lights])
    d = traffic_light.stop_distance(flat, rep, t_abs.repeat_interleave(K))
    return d.reshape(B, K)


def _advance_npcs(ego: EgoState, obs: Obstacles, npc_idx: Tensor,
                  lane: npc.LaneState, dt: float, global_path: Path,
                  agent_slot: Tensor, preset: npc.BehaviorPreset, vp,
                  lights=None, t_abs=None):
    """One NPC tick for every obstacle slot. Agent slots run the sim/npc.py
    agent (pure pursuit + IDM + lane changes) against the ego at its new
    pose and against every other slot as it stood at the start of the tick
    (a simultaneous update); walker and static slots advance at constant
    velocity. The "others" of slot k are the K slots and the ego, (B, K,
    K + 1), with slot k itself masked out. Returns (obstacles', npc_idx',
    lane')."""
    B, K = obs.x.shape
    is_agent = obs.valid & agent_slot
    lane = npc.slew_lane(lane, dt)
    st = NPCStateAt(obs, npc_idx)
    others_x = torch.cat([obs.x, ego.x[:, None]], 1)[:, None, :]      # (B, 1, K+1)
    others_y = torch.cat([obs.y, ego.y[:, None]], 1)[:, None, :]
    others_v = torch.cat([st.ego.vx, ego.speed[:, None]], 1)[:, None, :]
    not_self = (torch.arange(K, device=obs.x.device)[:, None]
                != torch.arange(K + 1, device=obs.x.device)[None, :])
    others_valid = torch.cat(
        [obs.valid, torch.ones_like(obs.valid[:, :1])], 1
    )[:, None, :] & not_self                                           # (B, K, K+1)
    l_now = npc.lateral_offset_on_path(st.ego, global_path, st.path_index)
    # own-lane lead (pressure) vs intended-lane lead (IDM target)
    gap_own, v_lead_own = npc.lead_info(st.ego, others_x, others_y, others_v,
                                        others_valid, -l_now)
    gap_tgt, v_lead_tgt = npc.lead_info(st.ego, others_x, others_y, others_v,
                                        others_valid, lane.target - l_now)
    if lights is not None:
        # a red stop line is a stationary lead for the IDM
        d_light = _npc_stop_distance(st.ego, lights, t_abs)
        v_lead_tgt = torch.where(d_light < gap_tgt, 0.0, v_lead_tgt)
        gap_tgt = torch.minimum(gap_tgt, d_light)
    free = [npc.corridor_free(st.ego, shift, others_x, others_y, others_valid)
            for shift in (npc.LANE_WIDTH - l_now, -npc.LANE_WIDTH - l_now, -l_now)]
    lane_n = npc.lane_change_decision(lane, gap_own, v_lead_own, st.ego.vx,
                                      *free, preset)
    st2 = npc.npc_step(st, global_path, gap_tgt, v_lead_tgt, preset, vp, dt,
                       lane_n.offset)
    e2 = st2.ego
    obs_n = obs._replace(
        x=torch.where(is_agent, e2.x, obs.x + obs.vx * dt),
        y=torch.where(is_agent, e2.y, obs.y + obs.vy * dt),
        vx=torch.where(is_agent, e2.vx * torch.cos(e2.phi), obs.vx),
        vy=torch.where(is_agent, e2.vx * torch.sin(e2.phi), obs.vy),
    )
    return (obs_n, torch.where(is_agent, st2.path_index, npc_idx),
            npc.LaneState(lane_n.offset, torch.where(is_agent, lane_n.target,
                                                     lane.target)))


def _traffic_ticks_base(ego, pid_buf, pid_cnt, pid_last, obs, tspeed, ttime,
                        target, arrived, feas, plan_ok, dest_x, dest_y,
                        cfg: EMConfig, traffic: TrafficInputs, lights=None,
                        t0=None):
    """One agent-traffic plan cycle's tick loop, plain PyTorch: the semantic
    definition behind the tick kernel's traffic branch (K7). The ego's tick
    is :func:`_full_ticks_base`'s; :func:`_advance_npcs` takes the place of
    constant-velocity motion, and with ``lights`` the NPCs stop at red lines
    too. Returns :func:`_full_ticks_base`'s tuple, then the NPC indices,
    lane offsets and lane targets after the ticks, each (B, K)."""
    dt = cfg.plant.dt
    preset = npc.preset(traffic.behavior, ego.x.device)
    state = [traffic.npc_idx, npc.LaneState(traffic.lane_off, traffic.lane_tgt)]

    def advance(ego_n, o, t_abs):
        o, state[0], state[1] = _advance_npcs(
            ego_n, o, state[0], state[1], dt, traffic.global_path,
            traffic.agent_slot, preset, cfg.vehicle, lights, t_abs)
        return o

    out = _tick_loop(ego, pid_buf, pid_cnt, pid_last, obs, tspeed, ttime,
                     target, arrived, feas, plan_ok, dest_x, dest_y, cfg,
                     lights, t0, advance)
    return (*out, state[0], state[1].offset, state[1].target)


def simulate_traffic(global_path: Path, ego0: EgoState, obstacles0: Obstacles,
                     cfg: EMConfig, behavior: str = "normal", full: bool = False,
                     lights=None, npc_init=None, device="cuda"):
    """The closed loop with agent-driven NPCs: each dynamic slot moving
    faster than 2.5 m/s at the start (decided once) runs the sim/npc.py
    agent on the global path against the ego and the other NPCs; slower
    dynamic slots are walkers and, with the static slots, move at constant
    velocity. ``full`` runs the full EM cycle (path + S-T speed planning)
    each replan, else the path cycle on the constant target speed.
    ``lights`` (B, L): the ego's red-light cap, and every NPC treats a red
    stop line as a stationary IDM lead. ``npc_init``: (npc_path_index (B, K),
    npc.LaneState) to resume the NPCs' carried state, else the indices are
    matched from the initial positions and the lanes start centred. Inputs
    are batch-first and are moved to ``device`` (the card unless the caller
    asks for the CPU). Returns (TrafficCarry, TickMetrics of (B, n_plans,
    plan_every))."""
    # contiguous once, so that the kernel reads the path in place each cycle
    global_path = type(global_path)(*[f.contiguous() for f in tree_to(global_path, device)])
    ego0 = tree_to(ego0, device)
    obstacles0 = tree_to(obstacles0, device)
    lights = tree_to(lights, device)
    B, K = obstacles0.x.shape
    dest_x = global_path.x[:, -1].contiguous()
    dest_y = global_path.y[:, -1].contiguous()
    speed0 = hypot(obstacles0.vx, obstacles0.vy)
    slot = torch.arange(K, device=speed0.device)
    agent_slot = (slot >= cfg.n_static_obs) & (speed0 > 2.5)
    if npc_init is None:
        npc_idx0 = frenet.nearest_index(obstacles0.x, obstacles0.y, global_path)
        lane0 = npc.LaneState.init(B, K, device)
    else:
        npc_idx0 = npc_init[0].to(device=device, dtype=torch.int32).contiguous()
        lane0 = npc.LaneState(*[f.to(device).contiguous() for f in npc_init[1]])
    carry = TrafficCarry(
        LoopCarry(
            ego0,
            vehicle.ControllerState.init(cfg.control, B, device),
            frenet.nearest_index(ego0.x, ego0.y, global_path),
            obstacles0,
            torch.zeros(B, dtype=torch.bool, device=device),
            em_planner.warm_init(cfg, B, device, full=full),
        ),
        npc_idx0, lane0,
    )
    tspeed = ttime = None
    if not full:
        v, tq = _constant_profile(cfg)
        ttime = torch.as_tensor(tq, device=device)
        tspeed = torch.full((B, tq.shape[0]), float(v), dtype=torch.float32,
                            device=device)
    per_cycle = []
    for i in range(cfg.loop.n_plans):
        t0 = _cycle_t0(cfg, i, B, device) if lights is not None else None
        carry, metrics = traffic_plan_cycle(
            global_path, carry, cfg, behavior, full, agent_slot, dest_x, dest_y,
            lights, t0, tspeed, ttime)
        per_cycle.append(metrics)
    metrics = TickMetrics(*[torch.stack(ch, 1) for ch in zip(*per_cycle)])
    return carry, metrics


def traffic_plan_cycle(global_path: Path, carry: TrafficCarry, cfg: EMConfig,
                       behavior: str, full: bool, agent_slot: Tensor,
                       dest_x: Tensor, dest_y: Tensor, lights=None, t0=None,
                       tspeed=None, ttime=None):
    """One replan (the path cycle on the constant profile (tspeed, ttime), or
    with ``full`` the full EM cycle) and its agent-traffic ticks. Returns
    (TrafficCarry', TickMetrics of (B, plan_every))."""
    traffic = TrafficInputs(global_path, carry.npc_path_index,
                            carry.npc_lane.offset, carry.npc_lane.target,
                            agent_slot, behavior)
    loop, metrics, (idx, off, tgt) = _cycle(
        global_path, carry.loop, cfg, full, dest_x, dest_y, lights, t0, tspeed,
        ttime, traffic)
    return TrafficCarry(loop, idx, npc.LaneState(off, tgt)), metrics


def summarize(metrics: TickMetrics) -> dict:
    """Roll-ups over every scenario and tick: RMS and max lateral error, mean
    speed, any collision / arrival, infeasible share, total planner drops
    (st_top_m segments and dp_top_m slots, one count per plan cycle)."""
    lat = metrics.lateral_err
    return {
        "lateral_rmse": torch.sqrt((lat * lat).mean()),
        "lateral_max": lat.abs().max(),
        "mean_speed_kmh": metrics.speed_kmh.mean(),
        "collided": metrics.collided.any(),
        "arrived": metrics.arrived.any(),
        "infeasible_frac": (1.0 - metrics.feasible.to(torch.float32)).mean(),
        "segments_dropped": metrics.segments_dropped[..., 0].sum(),
    }
