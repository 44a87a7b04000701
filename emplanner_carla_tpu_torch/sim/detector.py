"""Camera-space object detection on batch-first tensors (counterpart of
``emplanner_carla_tpu/sim/detector.py``, the replacement of the reference's
YOLOv3 OpenCV-DNN demo, ``simulation_2.py:159-233``).

Per class, fixed shapes: column presence, connected column runs labelled by
a cumulative sum of run starts (split where the near-face depth jumps by
more than ``SPLIT_DEPTH``: a partially occluding pair), padded to
``max_det`` slots; per run the pixel box, a sub-pixel centre bearing and
near-face range from a 3-point parabola through the run's first minimum
depth column and its neighbours (the box centre and the minimum where the
fit does not hold), and the world position of the object's centre one
class radius beyond the near face. ``detect`` reads a rendered frame,
``detect_from_columns`` the analytic column view (``camera.render_columns``),
which has no rows: its ``v_min`` / ``v_max`` are zeros.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from emplanner_carla_tpu_torch.sim import camera as camera_mod
from emplanner_carla_tpu_torch.types import EgoState, Tensor

# adjacent-column near-face depth step above which a run is split into two
# objects (within one cylinder the step is bounded by ~VEHICLE_RADIUS at the
# silhouette edge; between a partially occluding pair it is their range gap)
SPLIT_DEPTH = 1.6
_CLASSES = ((camera_mod.VEHICLE, camera_mod.VEHICLE_RADIUS),
            (camera_mod.WALKER, camera_mod.WALKER_RADIUS))


class Detections(NamedTuple):
    """Fixed-width detection slots, each (B, D)."""

    u_min: Tensor    # leftmost pixel column of the box
    u_max: Tensor    # rightmost pixel column
    v_min: Tensor    # top pixel row
    v_max: Tensor    # bottom pixel row
    depth: Tensor    # near-face range in the horizontal plane (m)
    bearing: Tensor  # camera-frame azimuth of the object centre (rad, left +)
    x: Tensor        # world-frame object centre estimate
    y: Tensor
    cls: Tensor      # semantic class id (camera.VEHICLE / camera.WALKER)
    valid: Tensor    # bool


def _runs_from_columns(col: Tensor, col_d: Tensor, max_det: int):
    """Column runs of one class: ``col`` (B, W) presence, ``col_d`` (B, W)
    near-face horizontal range (1e9 on empty columns). Returns per slot
    ``(u_min, u_max, d_face, u_sub, valid, sel)``, each (B, D), and ``sel``
    (B, D, W) the run's column membership."""
    B, W = col.shape
    dev = col.device
    BIGF = camera_mod.BIG
    prev = torch.cat([torch.zeros_like(col[:, :1]), col[:, :-1]], 1)
    prev_d = torch.cat([torch.full_like(col_d[:, :1], BIGF), col_d[:, :-1]], 1)
    jump = (col_d - prev_d).abs() > SPLIT_DEPTH
    start = col & (~prev | jump)
    run_id = torch.where(col, torch.cumsum(start.to(torch.int32), 1) - 1, -1)

    d = torch.arange(max_det, device=dev)
    sel = run_id[:, None, :] == d[None, :, None]                   # (B, D, W)
    u = torch.arange(W, dtype=torch.int32, device=dev)
    u_min = torch.where(sel, u, W).min(-1).values
    u_max = torch.where(sel, u, -1).max(-1).values
    valid = u_max >= u_min

    d_in = torch.where(sel, col_d[:, None, :], BIGF)
    d_m = d_in.min(-1).values                                      # (B, D)
    is_min = (d_in == d_m[..., None]) & sel
    has_min = is_min.any(-1)
    # the first minimum column, 0 where the slot has no run
    u_star = torch.where(has_min, torch.argmax(is_min.to(torch.int8), -1), 0)
    left, right = (u_star - 1) % W, (u_star + 1) % W               # rolled neighbours
    d_l = torch.where(has_min, torch.gather(col_d, 1, left), 0.0)
    d_r = torch.where(has_min, torch.gather(col_d, 1, right), 0.0)
    in_l = has_min & torch.gather(sel, 2, left[..., None])[..., 0]
    in_r = has_min & torch.gather(sel, 2, right[..., None])[..., 0]
    curv = d_l - 2.0 * d_m + d_r
    fit_ok = (valid & in_l & in_r & (u_star > 0) & (u_star < W - 1)
              & (d_l < BIGF) & (d_r < BIGF) & (curv > 1e-4))
    curv_s = torch.clamp(curv, min=1e-4)
    off = torch.clamp(0.5 * (d_l - d_r) / curv_s, -1.0, 1.0)
    u_sub = torch.where(fit_ok, u_star.to(torch.float32) + off, 0.5 * (u_min + u_max))
    # range at the clipped offset, never the raw vertex (with small
    # curvature the vertex dives below every measured depth)
    d_face = torch.where(
        fit_ok, d_m + 0.5 * (d_r - d_l) * off + 0.5 * curv_s * off * off, d_m)
    return u_min, u_max, d_face, u_sub, valid, sel


def _project(ego: EgoState, cfg, cls: int, radius: float, u_min, u_max, v_min,
             v_max, d_face, u_sub, valid) -> Detections:
    """World-frame projection of per-run detections: the object centre one
    class radius beyond the near face along the centre bearing."""
    f, cx, _ = camera_mod.focal(cfg)
    bearing = torch.atan((cx - u_sub) * (1.0 / f))
    rng = d_face + radius
    az = ego.phi[:, None] + bearing
    cphi, sphi, cam_x, cam_y = camera_mod._camera_pose(ego, cfg)
    x = cam_x[:, None] + rng * torch.cos(az)
    y = cam_y[:, None] + rng * torch.sin(az)
    return Detections(
        u_min, u_max, v_min, v_max, torch.where(valid, d_face, 0.0), bearing, x, y,
        torch.full_like(u_min, cls), valid)


def _cat(outs) -> Detections:
    return Detections(*(torch.cat(a, 1) for a in zip(*outs)))


def detect(frame: camera_mod.CameraFrame, ego: EgoState,
           cfg: camera_mod.CameraConfig = camera_mod.CameraConfig(),
           max_det: int = 4) -> Detections:
    """Vehicles and walkers in each lane's frame: ``2 * max_det`` slots,
    vehicles first."""
    f, cx, cy = camera_mod.focal(cfg)
    dev = frame.depth.device
    # along-ray depth -> horizontal-plane depth: d_h = t * |d_xy| for the
    # unit ray (1, a, b) / n, a = (cx - u) / f, b = (cy - v) / f
    a = (cx - torch.arange(cfg.width, dtype=torch.float32, device=dev)) * (1.0 / f)
    b = (cy - torch.arange(cfg.height, dtype=torch.float32, device=dev)) * (1.0 / f)
    hfrac = torch.sqrt(1.0 + a * a)[None, :] / torch.sqrt(
        1.0 + (a * a)[None, :] + (b * b)[:, None])                # (H, W)
    depth_h = frame.depth * hfrac
    H = cfg.height
    v = torch.arange(H, dtype=torch.int32, device=dev)
    outs = []
    for cls, radius in _CLASSES:
        mask = frame.semantic == cls                               # (B, H, W)
        col = mask.any(1)
        col_d = torch.where(mask, depth_h, camera_mod.BIG).min(1).values
        u_min, u_max, d_face, u_sub, valid, sel = _runs_from_columns(col, col_d, max_det)
        rows = (sel[:, :, None, :] & mask[:, None]).any(-1)        # (B, D, H)
        v_min = torch.where(rows, v, H).min(-1).values
        v_max = torch.where(rows, v, -1).max(-1).values
        outs.append(_project(ego, cfg, cls, radius, u_min, u_max, v_min, v_max,
                             d_face, u_sub, valid))
    return _cat(outs)


def detect_from_columns(cols: camera_mod.ColumnView, ego: EgoState,
                        cfg: camera_mod.CameraConfig = camera_mod.CameraConfig(),
                        max_det: int = 4) -> Detections:
    """``detect`` from the analytic column view (``camera.render_columns``):
    the same runs and sub-pixel fit without the frame's rows. ``v_min`` and
    ``v_max`` cannot be recovered from columns and are zeros (the tracker
    reads only x, y, depth and valid)."""
    outs = []
    for i, (cls, radius) in enumerate(_CLASSES):
        u_min, u_max, d_face, u_sub, valid, _ = _runs_from_columns(
            cols.col[:, i], cols.col_d[:, i], max_det)
        zi = torch.zeros_like(u_min)
        outs.append(_project(ego, cfg, cls, radius, u_min, u_max, zi, zi, d_face,
                             u_sub, valid))
    return _cat(outs)
