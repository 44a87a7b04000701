"""The closed loop driven by pixels on batch-first tensors (counterpart of
``emplanner_carla_tpu/sim/pixel_loop.py``): camera -> detector -> tracker
-> planner.

Every replan cycle renders each ego's camera (``sim/camera.py``, the
analytic column view by default), detects objects (``sim/detector.py``),
tracks them across cycles with a constant-velocity nearest-neighbour
tracker and hands the estimated obstacle set to the EM planner. Ground
truth only steps the world and scores collisions: the planner, its corridor
and the ACC guard see what the camera saw. The cycle reuses the closed
loop's pieces: ``closed_loop.replan`` (the path cycle or the full EM cycle
with the carried QP warm state) and ``closed_loop.run_ticks`` on the
estimates with no lights, the tick kernel ``csrc/tick_lqr.cu`` for CUDA
tensors. The true collision channel is recomputed after the ticks from the
recorded ego poses against constant-velocity truth.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from emplanner_carla_tpu_torch.config import EMConfig
from emplanner_carla_tpu_torch.control import vehicle
from emplanner_carla_tpu_torch.ops import frenet
from emplanner_carla_tpu_torch.planner import em_planner
from emplanner_carla_tpu_torch.sim import camera as camera_mod
from emplanner_carla_tpu_torch.sim import closed_loop, detector
from emplanner_carla_tpu_torch.sim.loop_constants import COLLISION_RADIUS
from emplanner_carla_tpu_torch.types import (
    EgoState, Obstacles, Path, Tensor, hypot, sdiv, tree_to,
)


class Tracks(NamedTuple):
    """Constant-velocity tracks over the detector's fixed slots, (B, D)."""

    x: Tensor
    y: Tensor
    vx: Tensor
    vy: Tensor
    valid: Tensor
    misses: Tensor       # int32: consecutive cycles without a matching detection
    static_conf: Tensor  # int32: consecutive matches with near-zero velocity
    prec: Tensor         # accumulated position precision (1/sigma^2 proxy)

    @classmethod
    def init(cls, batch: int, d: int, device="cpu"):
        z = torch.zeros((batch, d), dtype=torch.float32, device=device)
        zi = torch.zeros((batch, d), dtype=torch.int32, device=device)
        return cls(z, z, z, z, torch.zeros((batch, d), dtype=torch.bool, device=device),
                   zi, zi, z)


ASSOC_GATE = 12.0    # m: association radius around the CV-predicted track
VEL_EMA = 0.5        # velocity estimate smoothing
VEL_MAX = 25.0       # m/s sanity clamp: faster implied motion = new object
MAX_MISSES = 2       # cycles an unmatched track coasts before it dies
STATIC_V = 0.5       # m/s: below this a matched track counts as static
STATIC_CONF = 2      # matches needed before a track is confirmed static
STATIC_MAX_MISSES = 4   # coast budget of confirmed-static tracks
PREC_DECAY = 0.7     # geometric forgetting of accumulated position evidence


def _pick(a: Tensor, idx: Tensor, take: Tensor):
    """a (B, n) at idx (B, m) where ``take``, else 0 of a's dtype."""
    return torch.where(take, torch.gather(a, 1, idx), torch.zeros_like(a[:, :1]))


def _rank_select(mask: Tensor, n_slots: int):
    """Compaction of the True entries of ``mask`` (B, T) into ``n_slots``
    slots in order: (take (B, n_slots), the source index of each slot)."""
    rank = torch.cumsum(mask.to(torch.int32), 1) - 1
    hit = (rank[:, None, :] == torch.arange(n_slots, device=mask.device)[None, :, None]) \
        & mask[:, None, :]                                        # (B, slots, T)
    return hit.any(-1), torch.argmax(hit.to(torch.int8), -1)


def update_tracks(det: detector.Detections, tracks: Tracks, plan_dt: float) -> Tracks:
    """Nearest-neighbour association, finite-difference velocities and
    miss-tolerant coasting (``pixel_loop.update_tracks``).

    Tracks are predicted over the plan period; each detection claims its
    nearest predicted track within ``ASSOC_GATE`` (an implied speed above
    ``VEL_MAX`` starts a fresh track at rest instead). Tracks confirmed
    static (``STATIC_CONF`` slow matches) are pinned and fuse their
    sightings inverse-variance weighted by range. A valid track no detection
    claimed coasts for ``MAX_MISSES`` cycles (``STATIC_MAX_MISSES`` if
    confirmed static), compacted into the detection slots left invalid."""
    D = tracks.x.shape[1]
    px = tracks.x + tracks.vx * plan_dt
    py = tracks.y + tracks.vy * plan_dt
    ex = det.x[:, :, None] - px[:, None, :]
    ey = det.y[:, :, None] - py[:, None, :]
    d2 = ex * ex + ey * ey                                        # (B, det, track)
    ok = det.valid[:, :, None] & tracks.valid[:, None, :]
    d2 = torch.where(ok, d2, torch.inf)
    j = torch.argmin(d2, 2)                                       # 0 if none is finite
    matched = d2.min(2).values < ASSOC_GATE ** 2

    def at_j(a):
        return torch.gather(a, 1, j)

    vx_fd = (det.x - at_j(tracks.x)) * (1.0 / plan_dt)
    vy_fd = (det.y - at_j(tracks.y)) * (1.0 / plan_dt)
    matched = matched & (hypot(vx_fd, vy_fd) < VEL_MAX)
    vx = torch.where(matched, VEL_EMA * vx_fd + (1 - VEL_EMA) * at_j(tracks.vx), 0.0)
    vy = torch.where(matched, VEL_EMA * vy_fd + (1 - VEL_EMA) * at_j(tracks.vy), 0.0)
    slow = matched & (hypot(vx, vy) < STATIC_V)
    conf = torch.where(slow, at_j(tracks.static_conf) + 1, 0).to(torch.int32)
    # a confirmed static is pinned: residual noise velocity would drift it
    confirmed = conf >= STATIC_CONF
    vx = torch.where(confirmed, 0.0, vx)
    vy = torch.where(confirmed, 0.0, vy)
    # static-position refinement: precision ~ 1 / depth^2 fuses the
    # sightings of a slow track, forgetting old evidence geometrically
    dm = torch.clamp(det.depth, min=1.0)
    p_det = sdiv(1.0, dm * dm)
    p_old = at_j(tracks.prec) * PREC_DECAY
    p_new = torch.where(slow, p_old + p_det, p_det)
    w = torch.where(slow, p_old / torch.clamp(p_old + p_det, min=1e-12), 0.0)
    x_upd = w * at_j(tracks.x) + (1.0 - w) * det.x
    y_upd = w * at_j(tracks.y) + (1.0 - w) * det.y

    # coast candidates: valid tracks no detection claimed, under their miss
    # budget, compacted in order into the invalid detection slots
    slots = torch.arange(D, device=j.device)
    claimed = ((j[:, :, None] == slots) & matched[:, :, None]).any(1)
    budget = torch.where(tracks.static_conf >= STATIC_CONF, STATIC_MAX_MISSES, MAX_MISSES)
    coast = tracks.valid & ~claimed & (tracks.misses < budget)
    free = ~det.valid
    coast_rank = torch.cumsum(coast.to(torch.int32), 1) - 1
    free_rank = torch.cumsum(free.to(torch.int32), 1) - 1
    sel = (coast_rank[:, None, :] == free_rank[:, :, None]) & coast[:, None, :] \
        & free[:, :, None]                                        # (B, free slot, coaster)
    take = free & sel.any(-1)
    src = torch.argmax(sel.to(torch.int8), -1)

    def at_src(a):
        return _pick(a, src, take)

    # coasting statics hold their position
    coast_static = at_src(tracks.static_conf) >= STATIC_CONF
    cx = torch.where(coast_static, at_src(tracks.x), at_src(px))
    cy = torch.where(coast_static, at_src(tracks.y), at_src(py))
    out_x = torch.where(det.valid, x_upd, torch.where(take, cx, 0.0))
    out_y = torch.where(det.valid, y_upd, torch.where(take, cy, 0.0))
    cvx = torch.where(coast_static, 0.0, at_src(tracks.vx))
    cvy = torch.where(coast_static, 0.0, at_src(tracks.vy))
    out_vx = torch.where(det.valid, vx, torch.where(take, cvx, 0.0))
    out_vy = torch.where(det.valid, vy, torch.where(take, cvy, 0.0))
    zero_i = torch.zeros_like(conf)
    out_miss = torch.where(det.valid, zero_i,
                           torch.where(take, at_src(tracks.misses) + 1, zero_i))
    # coasting keeps its static confidence and accumulated precision
    out_conf = torch.where(det.valid, conf, torch.where(take, at_src(tracks.static_conf),
                                                        zero_i))
    out_prec = torch.where(det.valid, p_new, torch.where(take, at_src(tracks.prec), 0.0))
    return Tracks(out_x, out_y, out_vx, out_vy, det.valid | take, out_miss.to(torch.int32),
                  out_conf.to(torch.int32), out_prec)


class PixelCarry(NamedTuple):
    loop: closed_loop.LoopCarry
    tracks: Tracks


class PixelMetrics(NamedTuple):
    ticks: closed_loop.TickMetrics  # each (B, n_plans, plan_every)
    n_tracked: Tensor               # (B, n_plans) int32 valid tracks per cycle
    perc_err: Tensor                # (B, n_plans) mean matched position error


def estimates(tracks: Tracks, cfg: EMConfig) -> Obstacles:
    """Tracks in the planner's slot layout: tracks moving faster than the
    dynamic gate compacted into the dynamic slots (the S-T stage reads only
    those), the rest (and dynamic overflow) into the static slots."""
    is_dyn = tracks.valid & (hypot(tracks.vx, tracks.vy) > cfg.loop.dynamic_speed_gate)
    rank_dyn = torch.cumsum(is_dyn.to(torch.int32), 1) - 1
    to_dyn = is_dyn & (rank_dyn < cfg.n_dynamic_obs)
    to_sta = tracks.valid & ~to_dyn
    take_s, src_s = _rank_select(to_sta, cfg.n_static_obs)
    take_d, src_d = _rank_select(to_dyn, cfg.n_dynamic_obs)

    def slot(a):
        return torch.cat([_pick(a, src_s, take_s), _pick(a, src_d, take_d)], 1)

    return Obstacles(slot(tracks.x), slot(tracks.y), slot(tracks.vx), slot(tracks.vy),
                     torch.cat([take_s, take_d], 1))


def perception_error(tracks: Tracks, truth: Obstacles) -> Tensor:
    """(B,) mean distance of the tracks within 2 m of a true obstacle."""
    ex = tracks.x[:, :, None] - truth.x[:, None, :]
    ey = tracks.y[:, :, None] - truth.y[:, None, :]
    d2 = torch.where(tracks.valid[:, :, None] & truth.valid[:, None, :], ex * ex + ey * ey,
                     torch.inf)
    dmin = torch.sqrt(d2.min(2).values)
    hit = tracks.valid & (dmin < 2.0)
    return torch.where(hit, dmin, 0.0).sum(1) / torch.clamp(hit.sum(1), min=1)


def simulate_pixels(global_path: Path, ego0: EgoState, obstacles0: Obstacles,
                    cfg: EMConfig, cam_cfg: camera_mod.CameraConfig = camera_mod.CameraConfig(),
                    is_walker=None, max_det: int = 4, full: bool = False,
                    columns: bool = True, device="cuda"):
    """``closed_loop.simulate`` (or, with ``full``, ``simulate_full``) with
    the planner's obstacles replaced by camera detections, for a batch of
    scenarios moved to ``device`` (the card unless the caller asks for the
    CPU). Per cycle: sense (the column view, or with ``columns=False`` the
    rendered frame), detect, track, plan on the estimates, and run the ticks
    on the estimates (ACC guard and their constant-velocity advance). True
    obstacles move at constant velocity and score collisions. ``is_walker``
    (K,) or (B, K) marks walker-sized slots. Returns (PixelCarry,
    PixelMetrics)."""
    global_path = tree_to(global_path, device)
    ego0 = tree_to(ego0, device)
    obstacles0 = tree_to(obstacles0, device)
    if is_walker is not None:
        is_walker = torch.as_tensor(is_walker, device=device)
    lp = cfg.loop
    B = ego0.x.shape[0]
    dest_x = global_path.x[:, -1].contiguous()
    dest_y = global_path.y[:, -1].contiguous()
    plan_dt = lp.plan_every * cfg.plant.dt
    tspeed = ttime = None
    if not full:
        v, tq = closed_loop._constant_profile(cfg)
        ttime = torch.as_tensor(tq, device=device)
        tspeed = torch.full((B, tq.shape[0]), float(v), dtype=torch.float32,
                            device=device)
    t_rel = (torch.arange(lp.plan_every, dtype=torch.float32, device=device) + 1.0) \
        * cfg.plant.dt
    carry = PixelCarry(
        closed_loop.LoopCarry(
            ego0, vehicle.ControllerState.init(cfg.control, B, device),
            frenet.nearest_index(ego0.x, ego0.y, global_path), obstacles0,
            torch.zeros(B, dtype=torch.bool, device=device),
            em_planner.warm_init(cfg, B, device, full=full)),
        Tracks.init(B, 2 * max_det, device),
    )
    per_cycle, n_tracked, perc = [], [], []
    for _ in range(lp.n_plans):
        lc = carry.loop
        # sense, detect, track
        if columns:
            cols = camera_mod.render_columns(lc.ego, lc.obstacles, cam_cfg, is_walker)
            det = detector.detect_from_columns(cols, lc.ego, cam_cfg, max_det)
        else:
            frame = camera_mod.render(lc.ego, global_path, lc.obstacles, cam_cfg,
                                      is_walker, road_classes=False)
            det = detector.detect(frame, lc.ego, cam_cfg, max_det)
        tracks = update_tracks(det, carry.tracks, plan_dt)
        est = estimates(tracks, cfg)
        perc.append(perception_error(tracks, lc.obstacles))
        n_tracked.append(tracks.valid.sum(1).to(torch.int32))

        # plan and tick on the estimates
        p = closed_loop.replan(global_path, lc._replace(obstacles=est), cfg, full,
                               tspeed, ttime)
        cs = lc.ctrl.rebind()
        ego, buf_n, cnt_n, last_n, _, arrived, m, mpc = closed_loop.run_ticks(
            lc.ego, cs.pid.buffer, cs.pid.count, cs.pid.last_error, est, p.tspeed,
            p.ttime, p.target, lc.arrived, p.feasible, p.plan_ok, dest_x, dest_y, cfg)
        # the true collision channel: recorded ego poses against
        # constant-velocity truth
        tx = lc.obstacles.x[:, None, :] + lc.obstacles.vx[:, None, :] * t_rel[:, None]
        ty = lc.obstacles.y[:, None, :] + lc.obstacles.vy[:, None, :] * t_rel[:, None]
        d_true = hypot(m[0][..., None] - tx, m[1][..., None] - ty)
        m[5] = (lc.obstacles.valid[:, None, :] & (d_true < COLLISION_RADIUS)).any(-1)
        per_cycle.append(closed_loop.TickMetrics(
            *m, p.dropped[:, None].expand(-1, m[0].shape[1])))
        carry = PixelCarry(
            closed_loop.LoopCarry(
                ego, closed_loop._controller_after(buf_n, cnt_n, last_n, mpc),
                p.match_index, closed_loop._advance_obstacles(lc.obstacles, plan_dt),
                arrived, p.qp_warm),
            tracks)
    ticks = closed_loop.TickMetrics(*[torch.stack(ch, 1) for ch in zip(*per_cycle)])
    return carry, PixelMetrics(ticks, torch.stack(n_tracked, 1), torch.stack(perc, 1))
