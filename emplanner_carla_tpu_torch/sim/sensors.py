"""Synthetic sensor models on batch-first tensors (counterpart of
``emplanner_carla_tpu/sim/sensors.py``, the reference's ``sensors/``
library): pure functions of the simulated world state, ego fields (B,) and
obstacles (B, K).

* collision sensor (``Sensors_detector_lib.Collision_sensor:13-43``):
  penetration depth into obstacle discs;
* lane-invasion sensor (``Lane_invasion_sensor:44``): |l| against the lane
  half-width;
* obstacle detector (``Obstacle_detector:95``): masked range query;
* radar (``Sensors_other_lib.Radar_sensor:14``): per-obstacle depth,
  azimuth and closing speed inside a field of view;
* GNSS (``GNSS_sensor:48``): position, or a geodetic fix, with optional
  Gaussian noise drawn from an explicit ``torch.Generator``;
* IMU (``IMU_sensor:78``): body-frame accelerations and yaw rate.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from emplanner_carla_tpu_torch.ops import frenet
from emplanner_carla_tpu_torch.types import EgoState, Obstacles, Path, Tensor, hypot


class RadarReturn(NamedTuple):
    depth: Tensor      # (B, K) range (m)
    azimuth: Tensor    # (B, K) bearing in the sensor frame (rad)
    velocity: Tensor   # (B, K) radial closing speed (m/s, positive = closing)
    valid: Tensor      # (B, K) inside range and field of view


def collision_depth(ego: EgoState, obs: Obstacles, radius: float = 1.5) -> Tensor:
    """(B,) max penetration depth (m) into any obstacle disc; 0 when clear."""
    d = hypot(obs.x - ego.x[:, None], obs.y - ego.y[:, None])
    pen = torch.where(obs.valid, torch.clamp(radius - d, min=0.0), 0.0)
    return pen.max(1).values


def lane_invasion(ego: EgoState, lane_path: Path, s_map: Tensor,
                  half_width: float = 1.75) -> Tensor:
    """(B,) True when the ego centre leaves the lane band around its path
    (B, N) with arc-length table s_map (B, N)."""
    _, l = frenet.cartesian_to_sl(ego.x[:, None], ego.y[:, None], lane_path, s_map)
    return l[:, 0].abs() > half_width


def obstacle_detector(ego: EgoState, obs: Obstacles, hit_radius: float = 30.0,
                      dynamics_only: bool = True) -> Tensor:
    """(B, K) mask of detected obstacles (the 30 m ``Obstacle_detector``
    contract)."""
    d = hypot(obs.x - ego.x[:, None], obs.y - ego.y[:, None])
    hit = obs.valid & (d < hit_radius)
    if dynamics_only:
        hit = hit & (hypot(obs.vx, obs.vy) > 0.1)
    return hit


def radar(ego: EgoState, obs: Obstacles, max_range: float = 100.0,
          fov: float = math.pi / 3) -> RadarReturn:
    """Forward radar: per-obstacle depth, azimuth and radial closing speed."""
    dx = obs.x - ego.x[:, None]
    dy = obs.y - ego.y[:, None]
    depth = hypot(dx, dy)
    bearing = torch.atan2(dy, dx) - ego.phi[:, None]
    bearing = torch.atan2(torch.sin(bearing), torch.cos(bearing))
    vx_w, vy_w = ego.v_world
    rel_vx = obs.vx - vx_w[:, None]
    rel_vy = obs.vy - vy_w[:, None]
    d_safe = torch.clamp(depth, min=1e-3)
    closing = -(rel_vx * dx + rel_vy * dy) / d_safe
    valid = obs.valid & (depth < max_range) & (bearing.abs() < fov / 2)
    return RadarReturn(depth, bearing, closing, valid)


def _normal(generator: torch.Generator, ref: Tensor) -> Tensor:
    """(B, 2) standard normal draws from ``generator`` on its own device,
    moved to ref's."""
    dev = generator.device
    return torch.randn((ref.shape[0], 2), generator=generator, device=dev).to(ref.device)


def gnss(ego: EgoState, generator: torch.Generator | None = None, sigma: float = 0.0):
    """(x, y) position fix with optional Gaussian noise of ``sigma`` metres a
    coordinate, drawn from ``generator`` (the reference zeroes all its noise
    attributes, ``Sensors_other_lib.py:58-63``). Exact with ``sigma == 0`` or
    no generator."""
    if generator is None or sigma == 0.0:
        return ego.x, ego.y
    n = _normal(generator, ego.x) * sigma
    return ego.x + n[:, 0], ego.y + n[:, 1]


class GnssFix(NamedTuple):
    latitude: Tensor   # degrees
    longitude: Tensor  # degrees
    altitude: Tensor   # metres


# WGS84 equatorial radius: the sphere CARLA's GeoLocation conversion uses
_EARTH_RADIUS = 6378137.0


def gnss_geodetic(ego: EgoState, lat0: float = 0.0, lon0: float = 0.0,
                  alt0: float = 0.0, generator: torch.Generator | None = None,
                  sigma_deg: float = 0.0) -> GnssFix:
    """Geodetic fix like the reference's ``carla.GnssMeasurement`` fields
    (``Sensors_other_lib.py:72-74``): the local-tangent inverse on a
    spherical earth anchored at (lat0, lon0); north (+y) moves latitude,
    east (+x) longitude scaled by cos(lat0). ``sigma_deg``: per-axis
    Gaussian noise from ``generator``."""
    scale = 180.0 / (math.pi * _EARTH_RADIUS)
    lat = lat0 + ego.y * scale
    coslat = torch.cos(torch.deg2rad(torch.tensor(lat0, dtype=torch.float32)))
    lon = lon0 + ego.x * scale / coslat.to(ego.x.device)
    alt = torch.full_like(ego.x, alt0)
    if generator is not None and sigma_deg > 0.0:
        n = _normal(generator, ego.x) * sigma_deg
        lat, lon = lat + n[:, 0], lon + n[:, 1]
    return GnssFix(lat, lon, alt)


def imu(ego: EgoState):
    """Body-frame (ax, ay) and yaw rate, each (B,)."""
    c, s = torch.cos(ego.phi), torch.sin(ego.phi)
    ax_b = ego.ax * c + ego.ay * s
    ay_b = -ego.ax * s + ego.ay * c
    return ax_b, ay_b, ego.omega
