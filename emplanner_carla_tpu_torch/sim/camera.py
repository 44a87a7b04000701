"""Synthetic forward camera on batch-first tensors (counterpart of
``emplanner_carla_tpu/sim/camera.py``, the reference's ``Sensors_camera_lib``
replacement).

A pinhole raycast over an analytic scene: the ground plane z = 0 (ROAD
within ``road_halfwidth`` of the global-path centreline, TERRAIN
otherwise), obstacles as upright cylinders (vehicle- or walker-sized) and
SKY above the horizon. ``render`` gives each lane's frame (semantic class,
depth along the ray, analytic optical flow); ``render_columns`` gives the
per-column object view the detector reads, without the rows (W x K work a
lane instead of H x W x K); ``rgb_frame`` maps classes through the
CityScapes palette with a depth shade.

Every expression keeps the JAX package's association order: the visible
rows of a column are decided by rounding at integer row boundaries, where a
last-ulp difference flips a column. A division by a Python constant is a
product with the constant's float32 reciprocal, as XLA compiles it, on
every device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from emplanner_carla_tpu_torch.types import EgoState, Obstacles, Path, Tensor, sdiv

# Semantic class ids (CityScapes palette order, as the reference's semantic
# camera decodes them, Sensors_camera_lib.py:85).
SKY = 0
TERRAIN = 1
ROAD = 2
VEHICLE = 3
WALKER = 4

PALETTE = (
    (70, 130, 180),   # sky
    (152, 251, 152),  # terrain
    (128, 64, 128),   # road
    (0, 0, 142),      # vehicle
    (220, 20, 60),    # pedestrian
)

VEHICLE_RADIUS = 1.0
VEHICLE_HEIGHT = 1.6
WALKER_RADIUS = 0.35
WALKER_HEIGHT = 1.8

BIG = 1e9
# floats of the (lanes, H, W, path points) distance tensor of the road
# classes held at once: ``render`` splits the batch into chunks of this size
_ROAD_CHUNK_FLOATS = 1 << 26


class CameraConfig(NamedTuple):
    """Pinhole camera rigidly mounted on the ego (forward-facing)."""

    width: int = 96
    height: int = 64
    fov: float = math.radians(90.0)  # horizontal field of view
    mount_forward: float = 1.0       # m ahead of the ego origin
    mount_height: float = 1.6        # m above the ground
    max_depth: float = 80.0          # sky / no-hit depth clamp
    road_halfwidth: float = 5.25     # centerline band classified ROAD


class CameraFrame(NamedTuple):
    semantic: Tensor  # (B, H, W) int32 class ids
    depth: Tensor     # (B, H, W) f32 metres along the ray
    flow: Tensor      # (B, H, W, 2) f32 optical flow (du/dt, dv/dt) px/s


class ColumnView(NamedTuple):
    """Per-column object view: what the column-run detector reads. Row 0 of
    the second axis is the VEHICLE class, row 1 the WALKER class."""

    col: Tensor    # (B, 2, W) bool: any pixel of the class in the column
    col_d: Tensor  # (B, 2, W) f32: min near-face horizontal depth (1e9 empty)


def focal(cfg: CameraConfig) -> tuple[float, float, float]:
    """(focal length in pixels, principal point cx, cy)."""
    return ((cfg.width / 2.0) / math.tan(cfg.fov / 2.0), (cfg.width - 1) / 2.0,
            (cfg.height - 1) / 2.0)


def _rays(cfg: CameraConfig, device):
    """Unit ray directions in the camera frame (x fwd, y left, z up), each
    (H, W), and the focal length."""
    f, cx, cy = focal(cfg)
    u = torch.arange(cfg.width, dtype=torch.float32, device=device)
    v = torch.arange(cfg.height, dtype=torch.float32, device=device)
    a = ((cx - u) * (1.0 / f))[None, :]                 # y/x (left positive)
    b = ((cy - v) * (1.0 / f))[:, None]                 # z/x (up positive)
    dx = torch.ones((cfg.height, cfg.width), dtype=torch.float32, device=device)
    dy = a.expand_as(dx)
    dz = b.expand_as(dx)
    n = torch.sqrt(dx * dx + dy * dy + dz * dz)
    return dx / n, dy / n, dz / n, f


def _walkers(is_walker, obs: Obstacles) -> Tensor:
    """(B, K) bool walker mask from None, (K,) or (B, K)."""
    if is_walker is None:
        return torch.zeros_like(obs.valid)
    return torch.as_tensor(is_walker, device=obs.x.device).expand_as(obs.valid)


def _sizes(is_walker: Tensor):
    radius = torch.where(is_walker, WALKER_RADIUS, VEHICLE_RADIUS)
    height = torch.where(is_walker, WALKER_HEIGHT, VEHICLE_HEIGHT)
    return radius, height


def _camera_pose(ego: EgoState, cfg: CameraConfig):
    cphi, sphi = torch.cos(ego.phi), torch.sin(ego.phi)
    return cphi, sphi, ego.x + cfg.mount_forward * cphi, ego.y + cfg.mount_forward * sphi


def render(ego: EgoState, global_path: Path, obs: Obstacles,
           cfg: CameraConfig = CameraConfig(), is_walker=None,
           road_classes: bool = True) -> CameraFrame:
    """Render each lane's camera frame from the world state: ego (B,),
    global_path (B, N), obstacles (B, K). ``is_walker``: (K,) or (B, K) bool
    selecting walker-sized slots (the rest are vehicles).
    ``road_classes=False`` labels every ground hit TERRAIN, skipping the
    ROAD/TERRAIN split (a min-distance scan of each ground hit against the
    whole centreline, H x W x N a lane; the detector reads only object
    pixels and depth)."""
    H, W = cfg.height, cfg.width
    dev = ego.x.device
    K = obs.x.shape[1]
    is_walker = _walkers(is_walker, obs)
    cphi, sphi, cam_x, cam_y = _camera_pose(ego, cfg)
    cphi_, sphi_ = cphi[:, None, None], sphi[:, None, None]
    cam_z = float(torch.tensor(cfg.mount_height, dtype=torch.float32))

    dcx, dcy, dcz, f = _rays(cfg, dev)
    dwx = dcx * cphi_ - dcy * sphi_                  # (B, H, W)
    dwy = dcx * sphi_ + dcy * cphi_
    dwz = dcz

    # ground plane
    t_ground = torch.where(dwz < -1e-6, sdiv(-cam_z, torch.clamp(dwz, max=-1e-6)), BIG)
    if road_classes:
        gx = cam_x[:, None, None] + t_ground * dwx
        gy = cam_y[:, None, None] + t_ground * dwy
        n_path = global_path.x.shape[1]
        step = max(1, _ROAD_CHUNK_FLOATS // (H * W * n_path))
        on_road = []
        for i in range(0, gx.shape[0], step):
            px = global_path.x[i:i + step, None, None, :]
            py = global_path.y[i:i + step, None, None, :]
            ex = gx[i:i + step, ..., None] - px
            ey = gy[i:i + step, ..., None] - py
            d2 = ex * ex + ey * ey
            on_road.append(torch.sqrt(d2.min(-1).values) < cfg.road_halfwidth)
        ground_cls = torch.where(torch.cat(on_road), ROAD, TERRAIN).to(torch.int32)
    else:
        ground_cls = torch.full(dwx.shape, TERRAIN, dtype=torch.int32, device=dev)

    # obstacle cylinders: a running strict-< minimum over the slots (the
    # first minimum on ties), carrying the winner's class and velocity
    radius, height = _sizes(is_walker)
    ox = cam_x[:, None] - obs.x                      # (B, K)
    oy = cam_y[:, None] - obs.y
    a2 = dwx * dwx + dwy * dwy
    a2_den = torch.clamp(a2, min=1e-9)
    t_obs = torch.full_like(a2, BIG)
    obs_cls = torch.full(a2.shape, VEHICLE, dtype=torch.int32, device=dev)
    vpx_hw = torch.zeros_like(a2)
    vpy_hw = torch.zeros_like(a2)
    for k in range(K):
        oxk, oyk = ox[:, k, None, None], oy[:, k, None, None]
        b1 = dwx * oxk + dwy * oyk
        c0 = (ox[:, k] * ox[:, k] + oy[:, k] * oy[:, k]
              - radius[:, k] * radius[:, k])[:, None, None]
        disc = b1 * b1 - a2 * c0
        t_cyl = (-b1 - torch.sqrt(torch.clamp(disc, min=0.0))) / a2_den
        z_hit = cam_z + t_cyl * dwz
        ok = ((disc > 0.0) & (t_cyl > 0.0) & (z_hit > 0.0)
              & (z_hit < height[:, k, None, None]) & obs.valid[:, k, None, None])
        t_k = torch.where(ok, t_cyl, BIG)
        closer = t_k < t_obs
        t_obs = torch.where(closer, t_k, t_obs)
        cls_k = torch.where(is_walker[:, k], WALKER, VEHICLE).to(torch.int32)
        obs_cls = torch.where(closer, cls_k[:, None, None], obs_cls)
        vpx_hw = torch.where(closer, obs.vx[:, k, None, None], vpx_hw)
        vpy_hw = torch.where(closer, obs.vy[:, k, None, None], vpy_hw)

    # composite
    hit_obs = t_obs < t_ground
    t = torch.minimum(t_obs, t_ground.expand_as(t_obs))
    sky = t >= BIG
    semantic = torch.where(sky, SKY, torch.where(hit_obs, obs_cls, ground_cls)).to(torch.int32)
    depth = torch.clamp(t, max=cfg.max_depth)

    # analytic optical flow: the hit point's camera-frame velocity
    # Xdot = R^T (Vp - Vc) - omega_z x X, projected through the pinhole
    vex, vey = ego.v_world
    om = ego.omega
    vcx = (vex - om * cfg.mount_forward * sphi)[:, None, None]
    vcy = (vey + om * cfg.mount_forward * cphi)[:, None, None]
    vpx = torch.where(hit_obs, vpx_hw, 0.0)
    vpy = torch.where(hit_obs, vpy_hw, 0.0)
    rvx = vpx - vcx
    rvy = vpy - vcy
    rcx = rvx * cphi_ + rvy * sphi_
    rcy = -rvx * sphi_ + rvy * cphi_
    X = t * dcx
    Y = t * dcy
    Z = t * dcz
    om_ = om[:, None, None]
    xd = rcx + om_ * Y
    yd = rcy - om_ * X
    zd = torch.zeros_like(xd)
    Xs = torch.clamp(X, min=1e-3)
    du = -f * (yd * Xs - Y * xd) / (Xs * Xs)
    dv = -f * (zd * Xs - Z * xd) / (Xs * Xs)
    flow = torch.stack([torch.where(sky, 0.0, du), torch.where(sky, 0.0, dv)], -1)
    return CameraFrame(semantic, depth, flow)


def render_columns(ego: EgoState, obs: Obstacles, cfg: CameraConfig = CameraConfig(),
                   is_walker=None) -> ColumnView:
    """The per-column reduction of ``render`` computed without the rows.

    For an upright cylinder the horizontal depth of a hit is the same on
    every row of a column (the 2-D ray/circle intersection depends only on
    the column's azimuth), and the rows that see slot k are the integer
    rows of an open interval (vlo_k, vhi_k). Every slot j that beats k in a
    column (nearer, or as near with a lower index: the frame's running
    minimum) covers a suffix of that interval, so k is visible iff an
    integer row v in (vlo_k, vhi_k) has v <= min_j vlo_j. The frame's depth
    clamp is folded in at the visible interval's end rows."""
    W, H = cfg.width, cfg.height
    dev = ego.x.device
    K = obs.x.shape[1]
    is_walker = _walkers(is_walker, obs)
    f, cx, cy = focal(cfg)
    a = (cx - torch.arange(W, dtype=torch.float32, device=dev)) * (1.0 / f)  # (W,)
    L2 = 1.0 + a * a
    L = torch.sqrt(L2)

    cphi, sphi, cam_x, cam_y = _camera_pose(ego, cfg)
    cz = float(torch.tensor(cfg.mount_height, dtype=torch.float32))
    # unnormalised 2-D ray direction per column (length L), (B, W)
    ux = cphi[:, None] - a * sphi[:, None]
    uy = sphi[:, None] + a * cphi[:, None]

    radius, height = _sizes(is_walker)
    ox = cam_x[:, None] - obs.x                                          # (B, K)
    oy = cam_y[:, None] - obs.y

    # 2-D ray/circle: L2 t'^2 + 2 Bq t' + c0 = 0; d_h = t' * L
    Bq = ux[:, None, :] * ox[:, :, None] + uy[:, None, :] * oy[:, :, None]   # (B, K, W)
    c0 = (ox * ox + oy * oy - radius * radius)[:, :, None]
    disc = Bq * Bq - L2 * c0
    tp = (-Bq - torch.sqrt(torch.clamp(disc, min=0.0))) / L2
    d_h = tp * L
    hit = (disc > 0.0) & (tp > 0.0) & obs.valid[:, :, None]

    dh_safe = torch.where(hit, torch.clamp(d_h, min=1e-9), 1.0)
    # visible-row interval: z_hit = cz + d_h * (cy - v) / (f * L)
    vlo = cy - f * (height[:, :, None] - cz) * L / dh_safe
    f_cz = float(torch.tensor(f, dtype=torch.float32) * cz)   # rounded as f32
    vhi = cy + f_cz * L / dh_safe

    # occlusion threshold: m_k = min vlo_j over the slots j beating k
    dh_rank = torch.where(hit, d_h, BIG)
    kk = torch.arange(K, device=dev)
    lower = (kk[:, None] < kk[None, :])[None, :, :, None]
    beats = ((dh_rank[:, :, None, :] < dh_rank[:, None, :, :])
             | ((dh_rank[:, :, None, :] == dh_rank[:, None, :, :]) & lower)) \
        & hit[:, :, None, :]                                             # (B, j, k, W)
    m = torch.where(beats, vlo[:, :, None, :], math.inf).min(1).values  # (B, K, W)

    v_first = torch.clamp(torch.floor(vlo) + 1.0, min=0.0)
    v_last = torch.clamp(torch.minimum(torch.ceil(vhi) - 1.0, torch.floor(m)), max=H - 1.0)
    visible = hit & (v_first <= v_last)

    def hfrac_at(v):
        b = (cy - v) * (1.0 / f)
        return L / torch.sqrt(L2 + b * b)

    hf = torch.minimum(hfrac_at(v_first), hfrac_at(v_last))
    d_face = torch.minimum(d_h, cfg.max_depth * hf)

    cols, col_ds = [], []
    for wcls in (False, True):
        sel = visible & (is_walker == wcls)[:, :, None]
        cols.append(sel.any(1))
        col_ds.append(torch.where(sel, d_face, BIG).min(1).values)
    return ColumnView(torch.stack(cols, 1), torch.stack(col_ds, 1))


def rgb_frame(frame: CameraFrame, cfg: CameraConfig = CameraConfig()) -> Tensor:
    """(B, H, W, 3) uint8 image: the CityScapes palette with depth shading
    (the RGB camera's HUD-feed role, ``Sensors_camera_lib.py:98-137``)."""
    pal = torch.tensor(PALETTE, dtype=torch.float32, device=frame.depth.device)
    base = pal[frame.semantic.long()]
    shade = 1.0 - 0.6 * torch.clamp(frame.depth * (1.0 / cfg.max_depth), 0.0, 1.0)
    shade = torch.where(frame.semantic == SKY, 1.0, shade)
    return torch.clamp(base * shade[..., None], 0.0, 255.0).to(torch.uint8)
