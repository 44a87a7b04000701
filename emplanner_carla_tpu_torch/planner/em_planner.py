"""The EM planning cycles on batch-first tensors (counterpart of
``plan_path_cycle``, ``plan_full_cycle`` and ``warm_init`` in
``emplanner_carla_tpu/planner/em_planner.py``).

Per cycle (citations into the reference's ``test_9.py``): plan-start
prediction (:361), reference-line refresh (:99-110), obstacles to S-L with
perception gates (:116-124), nearest dynamic obstacle to virtual statics
(:137-169), plan-start Frenet state (:172-177), S-L DP + densify + ::2
downsample (:180-188), corridor + piecewise-jerk QP (:189-201), and back to
Cartesian with a final smoothing pass (:204-218).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from emplanner_carla_tpu_torch.config import EMConfig
from emplanner_carla_tpu_torch.ops import frenet
from emplanner_carla_tpu_torch.planner import (
    path_dp, path_qp, reference_line, speed_planner, trajectory,
)
from emplanner_carla_tpu_torch.sim import perception, plant
from emplanner_carla_tpu_torch.types import (
    EgoState, Obstacles, Path, Tensor, Trajectory, hypot,
)


class PathPlanResult(NamedTuple):
    target: Path        # new local path for the controller, (B, n_stations)
    match_index: Tensor  # (B,) updated global-path match index
    feasible: Tensor    # (B,) DP found a collision-free homotopy
    path_s: Tensor      # (B, n) stations of the target in local-line s
    path_l: Tensor      # (B, n) lateral offsets
    qp_state: tuple     # path-QP ADMM warm state (x_s, z, y), None if cold
    obs_dropped: Tensor  # (B,) int32 in-window slots dropped by dp_top_m


def n_target(cfg: EMConfig) -> int:
    """``PathPlanConfig.n_qp``, the JAX package's target-path length; the
    planned target has :func:`n_stations` points."""
    return cfg.path.n_qp


def n_stations(cfg: EMConfig) -> int:
    """Number of QP stations after the ::qp_downsample of the enriched DP."""
    L = path_dp.enriched_length(cfg.path)
    k = cfg.path.qp_downsample
    return (L + k - 1) // k


def warm_init(cfg: EMConfig, batch: int, device="cpu", full: bool = False):
    """Zero QP warm states for the closed loops: (path_qp_state,
    speed_qp_state), the second None unless ``full``."""
    path_state = path_qp.warm_state_init(n_stations(cfg), batch, device)
    speed_state = (speed_planner.warm_state_init(cfg.speed, batch, device)
                   if full else None)
    return (path_state, speed_state)


def plan_path_cycle(global_path: Path, ego: EgoState, obstacles: Obstacles,
                    prev_match_index: Tensor, cfg: EMConfig, qp_warm=None,
                    first_run: bool = False) -> PathPlanResult:
    """One path replan. ``qp_warm`` is the path QP's carried ADMM state
    (x_s, z, y); None solves the QP cold, the open-loop plan of BASELINE
    config 2, and leaves ``qp_state`` None."""
    rl, pp = cfg.refline, cfg.path

    # 1. plan-start prediction
    pred_x, pred_y, _ = plant.predict_forward(ego, cfg.loop.pred_ts)

    # 2. reference line refresh; s_map re-origined at the current position
    local, s_map, match_index = reference_line.build_reference_line(
        global_path, pred_x, pred_y, prev_match_index, rl, first_run=first_run
    )
    s_map = frenet.s_map_from_origin(local, ego.x, ego.y)

    # 3-5. obstacles -> S-L with the perception gates
    static_mask, dyn_mask, dist = perception.perceive(ego, obstacles, cfg.loop)
    obs_s, obs_l = frenet.cartesian_to_sl(obstacles.x, obstacles.y, local, s_map)
    lat_ok = obs_l.abs() < cfg.loop.lateral_gate
    static_mask = perception.static_gate(static_mask & lat_ok, dist)
    dyn_mask = dyn_mask & lat_ok

    # 6. plan-start Frenet state from world-frame velocity/acceleration
    vx_w, vy_w = ego.v_world
    s0, l0, _, _, _, _, dl0, ddl0 = frenet.cartesian_to_frenet_full(
        pred_x, pred_y, vx_w, vy_w, ego.ax, ego.ay, local, s_map
    )

    virt_s, virt_l, virt_valid = perception.virtual_obstacles(
        ego.speed, s0, dyn_mask, dist, hypot(obstacles.vx, obstacles.vy)
    )
    all_s = torch.cat([obs_s, virt_s], 1)
    all_l = torch.cat([obs_l, virt_l], 1)
    all_valid = torch.cat([static_mask, virt_valid], 1)

    # 7. DP over the nearest dp_top_m in-window slots (slots outside the DP's
    # s window cost exactly zero); drops are counted in obs_dropped
    B = all_s.shape[0]
    obs_dropped = torch.zeros(B, dtype=torch.int32, device=all_s.device)
    dp_obs = (all_s, all_l, all_valid)
    if pp.dp_top_m < all_s.shape[1]:
        horizon = pp.cols * pp.sample_s + pp.safe_dist
        in_win = (
            all_valid
            & (all_s > (s0 - pp.safe_dist)[:, None])
            & (all_s < (s0 + horizon)[:, None])
        )
        key = torch.where(in_win, (all_s - s0[:, None]).abs(), float("inf"))
        # jnp.argsort is stable: ties and the inf padding keep slot order
        keep = torch.argsort(key, dim=1, stable=True)[:, : pp.dp_top_m]
        dp_obs = (
            torch.gather(all_s, 1, keep),
            torch.gather(all_l, 1, keep),
            torch.gather(in_win, 1, keep),
        )
        obs_dropped = (
            in_win.to(torch.int32).sum(1) - dp_obs[2].to(torch.int32).sum(1)
        ).to(torch.int32)
    dp_s, dp_l, feasible = path_dp.path_dp(
        dp_obs[0].contiguous(), dp_obs[1].contiguous(), dp_obs[2].contiguous(),
        s0.contiguous(), l0, dl0, ddl0, pp,
    )
    es, el = path_dp.enrich_dp(dp_s, dp_l, s0, l0, dl0, ddl0, pp)
    st_s = es[:, :: pp.qp_downsample]
    st_l = el[:, :: pp.qp_downsample]

    # 8. corridor + QP (warm from the carried state, or cold)
    l_min, l_max = path_qp.corridor(st_s, st_l, all_s, all_l, all_valid, pp)
    spacing = float(pp.sampling_res * pp.qp_downsample)
    qp_l, qp_dl, qp_ddl, qp_state = path_qp.path_qp(
        l_min, l_max, l0, dl0, ddl0, pp, spacing, warm_state=qp_warm
    )

    # 9. back to Cartesian + final smoothing
    raw = frenet.frenet_to_cartesian(st_s, qp_l, qp_dl, qp_ddl, local, s_map)
    target = reference_line.smooth_local_path(raw.x, raw.y, rl)
    return PathPlanResult(
        target, match_index, feasible, st_s, qp_l, qp_state, obs_dropped
    )


class FullPlanResult(NamedTuple):
    path: PathPlanResult
    trajectory: Trajectory
    speed_qp_state: tuple       # speed-QP ADMM warm state (x_s, z, y), None if cold
    # (B,) int32: valid ST segments dropped by st_top_m plus the path DP's
    # dp_top_m drops, this cycle
    segments_dropped: Tensor


def plan_full_cycle(global_path: Path, ego: EgoState, obstacles: Obstacles,
                    prev_match_index: Tensor, cfg: EMConfig, qp_warm=None,
                    first_run: bool = False) -> FullPlanResult:
    """Path planning + S-T speed planning, the full EM cycle. ``qp_warm`` is
    (path_qp_state, speed_qp_state), either of them None for a cold solve,
    or None for both. After the path stage: the speed-plan start on the new
    path, the dynamic obstacles against it, the ST graph compressed to the
    st_top_m segments (valid first, earliest time-in), the speed DP, the
    convex space, the speed QP, densify and merge."""
    path_warm, speed_warm = qp_warm if qp_warm is not None else (None, None)
    res = plan_path_cycle(global_path, ego, obstacles, prev_match_index, cfg,
                          qp_warm=path_warm, first_run=first_run)
    target = res.target
    sp = cfg.speed

    # 1. start condition on the new path
    vx_w, vy_w = ego.v_world
    s_dot0, s_ddot0 = speed_planner.speed_plan_start(
        vx_w, vy_w, ego.ax, ego.ay, target.theta[:, 0]
    )
    s_dot0 = torch.clamp(s_dot0, min=0.0)

    # 2. the dynamic slots against the new path (static slots cannot pass
    # the ST graph's |l_dot| gate)
    path_arc = trajectory.path_arc_length(target)
    _, dyn_mask, _ = perception.perceive(ego, obstacles, cfg.loop)
    d0 = cfg.n_static_obs
    d_s, d_l, d_sdot, d_ldot = frenet.dynamic_obs_frenet(
        obstacles.x[:, d0:], obstacles.y[:, d0:], obstacles.vx[:, d0:],
        obstacles.vy[:, d0:], target, path_arc,
    )

    # 3. ST graph -> top-M -> DP -> convex space -> QP
    seg = speed_planner.st_graph(d_s, d_l, d_sdot, d_ldot, dyn_mask[:, d0:], sp)
    seg, st_dropped = speed_planner.top_m_segments(seg, sp.st_top_m)
    segments_dropped = (st_dropped + res.obs_dropped).to(torch.int32)
    dp = speed_planner.speed_dp(seg, s_dot0, sp)
    s_lb, s_ub, sd_lb, sd_ub = speed_planner.convex_space(
        dp, seg, path_arc, target.kappa, sp
    )
    qs, qv, qa, qt, speed_state = speed_planner.speed_qp(
        s_dot0, s_ddot0, s_lb, s_ub, sd_lb, sd_ub, sp, warm_state=speed_warm
    )

    # 4. densify + merge
    s_d, v_d, a_d, t_d = speed_planner.densify_speed(qs, qv, qa, qt, sp)
    traj = trajectory.merge(target, s_d, v_d, a_d, t_d)
    return FullPlanResult(res, traj, speed_state, segments_dropped)
