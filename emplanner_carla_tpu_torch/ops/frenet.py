"""Cartesian <-> Frenet geometry on batch-first tensors (counterpart of
``emplanner_carla_tpu/ops/frenet.py`` up to ``slice_path``).

Every path tensor is (B, N); a query is (B,) or (B, K). Nearest-node
searches are full masked argmins with first-minimum tie-breaking (the
reference's strict-< scan). The JAX package's one-hot contractions
(``_gather``, ``slice_path``) exist only because per-lane gathers are slow
on a TPU; here they are ``torch.gather``, which selects the same values.
"""

from __future__ import annotations

import torch

from emplanner_carla_tpu_torch.types import Path, Tensor

__all__ = [
    "heading_kappa",
    "path_from_xy",
    "nearest_index",
    "nearest_index_windowed",
    "project_to_path",
    "arc_length",
    "s_map_from_origin",
    "cartesian_to_sl",
    "cartesian_to_frenet_full",
    "dynamic_obs_frenet",
    "proj_point_at_s",
    "frenet_to_cartesian",
    "sample_window_indices",
    "slice_path",
]


def _rows(a: Tensor, q: Tensor) -> Tensor:
    """View a (B, N) path channel so it broadcasts against query q (B, ...)
    with the node axis last: (B, 1, ..., N)."""
    return a.reshape(a.shape[0], *([1] * (q.dim() - 1)), a.shape[-1])


def _gather(a: Tensor, idx: Tensor) -> Tensor:
    """a (B, N) at per-row indices idx (B,) or (B, K)."""
    flat = idx.reshape(idx.shape[0], -1).long()
    return torch.gather(a, 1, flat).reshape(idx.shape)


def heading_kappa(x: Tensor, y: Tensor) -> tuple[Tensor, Tensor]:
    """Midpoint-Euler heading and curvature along a polyline
    (``cal_heading_kappa``); x, y (..., N)."""
    dx_seg = torch.diff(x, dim=-1)
    dy_seg = torch.diff(y, dim=-1)
    dx = 0.5 * (
        torch.cat([dx_seg[..., :1], dx_seg], -1)
        + torch.cat([dx_seg, dx_seg[..., -1:]], -1)
    )
    dy = 0.5 * (
        torch.cat([dy_seg[..., :1], dy_seg], -1)
        + torch.cat([dy_seg, dy_seg[..., -1:]], -1)
    )
    theta = torch.atan2(dy, dx)
    dtheta_seg = torch.diff(theta, dim=-1)
    # wrap segment heading changes into (-pi, pi] before averaging
    dtheta_seg = torch.atan2(torch.sin(dtheta_seg), torch.cos(dtheta_seg))
    dtheta = torch.sin(
        0.5
        * (
            torch.cat([dtheta_seg[..., :1], dtheta_seg], -1)
            + torch.cat([dtheta_seg, dtheta_seg[..., -1:]], -1)
        )
    )
    ds = torch.sqrt(dx * dx + dy * dy) + 1e-12
    return theta, dtheta / ds


def path_from_xy(x: Tensor, y: Tensor) -> Path:
    theta, kappa = heading_kappa(x, y)
    return Path(x, y, theta, kappa)


def _sq_dist(px: Tensor, py: Tensor, path: Path) -> Tensor:
    dx = _rows(path.x, px) - px[..., None]
    dy = _rows(path.y, py) - py[..., None]
    return dx * dx + dy * dy


def nearest_index(px: Tensor, py: Tensor, path: Path,
                  valid: Tensor | None = None) -> Tensor:
    """Index of the nearest path node, int32, first minimum on ties.
    ``valid`` (B, N) bool, like a path channel, masks the nodes that may
    match (a masked node's distance is +inf)."""
    d2 = _sq_dist(px, py, path)
    if valid is not None:
        d2 = torch.where(_rows(valid, px), d2, float("inf"))
    return torch.argmin(d2, dim=-1).to(torch.int32)


def nearest_index_windowed(
    px: Tensor, py: Tensor, path: Path, center: Tensor, window: int
) -> Tensor:
    """Nearest node restricted to ``[center, center + window)``, the window
    clipped at the path end (forward-only search near the last match)."""
    n = path.x.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=px.device)
    lo = torch.clamp(center, 0, max(n - window, 0))
    in_win = (idx >= lo[..., None]) & (idx < lo[..., None] + window)
    d2 = torch.where(in_win, _sq_dist(px, py, path), float("inf"))
    return torch.argmin(d2, dim=-1).to(torch.int32)


def project_to_path(px, py, path: Path, match_idx):
    """First-order projection of (px, py) about the match node:
    (x_r, y_r, theta_r, kappa_r, ds)."""
    xm = _gather(path.x, match_idx)
    ym = _gather(path.y, match_idx)
    tm = _gather(path.theta, match_idx)
    km = _gather(path.kappa, match_idx)
    ct, st = torch.cos(tm), torch.sin(tm)
    ds = (px - xm) * ct + (py - ym) * st
    return xm + ds * ct, ym + ds * st, tm + km * ds, km, ds


def arc_length(path: Path) -> Tensor:
    """Cumulative polyline arc length from the first node."""
    ddx = torch.diff(path.x, dim=-1)
    ddy = torch.diff(path.y, dim=-1)
    seg = torch.sqrt(ddx * ddx + ddy * ddy)
    zero = torch.zeros_like(path.x[..., :1])
    return torch.cat([zero, torch.cumsum(seg, dim=-1)], -1)


def s_map_from_origin(path: Path, origin_x: Tensor, origin_y: Tensor) -> Tensor:
    """Arc-length table re-origined at the projection of (origin_x,
    origin_y), origin (B,): s = 0 at the projection, negative behind it."""
    ref_s = arc_length(path)
    idx = nearest_index(origin_x, origin_y, path)
    _, _, _, _, ds = project_to_path(origin_x, origin_y, path, idx)
    s0 = _gather(ref_s, idx) + ds
    return ref_s - s0[..., None]


def cartesian_to_sl(px, py, path: Path, s_map: Tensor):
    """(x, y) -> (s, l) against a reference line; l > 0 left of the tangent."""
    idx = nearest_index(px, py, path)
    xr, yr, tr, _, ds = project_to_path(px, py, path, idx)
    s = _gather(s_map, idx) + ds
    l = -(px - xr) * torch.sin(tr) + (py - yr) * torch.cos(tr)
    return s, l


def cartesian_to_frenet_full(px, py, vx, vy, ax, ay, path: Path, s_map):
    """Full state transform (``cal_s_l_deri_fun``):
    (s, l, s_dot, l_dot, s_ddot, l_ddot, l', l'')."""
    idx = nearest_index(px, py, path)
    xr, yr, tr, kr, ds = project_to_path(px, py, path, idx)
    s = _gather(s_map, idx) + ds
    nx, ny = -torch.sin(tr), torch.cos(tr)
    tx, ty = torch.cos(tr), torch.sin(tr)
    l = (px - xr) * nx + (py - yr) * ny
    l_dot = vx * nx + vy * ny
    one_kl = 1.0 - kr * l
    s_dot = (vx * tx + vy * ty) / one_kl
    l_ddot = ax * nx + ay * ny - kr * one_kl * (s_dot * s_dot)
    small = s_dot.abs() < 1e-6
    l_prime = torch.where(
        small, 0.0, l_dot / torch.where(small, torch.ones_like(s_dot), s_dot)
    )
    s_ddot = (ax * tx + ay * ty + 2.0 * (s_dot * s_dot) * kr * l_prime) / one_kl
    sd2 = s_dot * s_dot
    l_pprime = torch.where(
        small, 0.0,
        (l_ddot - l_prime * s_ddot) / torch.where(small, torch.ones_like(sd2), sd2),
    )
    return s, l, s_dot, l_dot, s_ddot, l_ddot, l_prime, l_pprime


def dynamic_obs_frenet(px, py, vx, vy, path: Path, s_map: Tensor):
    """(s, l, s_dot, l_dot) of moving obstacles (B, K) against a path
    (``cal_dy_obs_deri``), first-minimum nearest node."""
    idx = nearest_index(px, py, path)
    xr, yr, tr, kr, ds = project_to_path(px, py, path, idx)
    s = _gather(s_map, idx) + ds
    nx, ny = -torch.sin(tr), torch.cos(tr)
    tx, ty = torch.cos(tr), torch.sin(tr)
    l = (px - xr) * nx + (py - yr) * ny
    l_dot = vx * nx + vy * ny
    s_dot = (vx * tx + vy * ty) / (1.0 - kr * l)
    return s, l, s_dot, l_dot


def proj_point_at_s(s: Tensor, path: Path, s_map: Tensor):
    """Pose of the reference-line point at arc coordinate s (B, K):
    bracketing node by searchsorted semantics, tangent extrapolation."""
    below = s_map[:, None, :] <= s[:, :, None]                  # (B, K, N)
    idx = torch.clamp(
        below.to(torch.int32).sum(-1) - 1, 0, s_map.shape[-1] - 2
    )
    xm = _gather(path.x, idx)
    ym = _gather(path.y, idx)
    tm = _gather(path.theta, idx)
    km = _gather(path.kappa, idx)
    ds = s - _gather(s_map, idx)
    return xm + ds * torch.cos(tm), ym + ds * torch.sin(tm), tm + km * ds, km


def frenet_to_cartesian(s, l, l_prime, l_pprime, path: Path, s_map) -> Path:
    """(s, l(s)) profile -> Cartesian path with heading and curvature
    (``Frenet2Cartesian``; kappa' ~ 0 as in the reference)."""
    xr, yr, tr, kr = proj_point_at_s(s, path, s_map)
    nx, ny = -torch.sin(tr), torch.cos(tr)
    x = xr + l * nx
    y = yr + l * ny
    one_kl = 1.0 - kr * l
    heading = tr + torch.atan2(l_prime, one_kl)
    dth = heading - tr
    cd = torch.cos(dth)
    kappa = (
        (l_pprime + kr * l_prime * torch.tan(dth)) * (cd * cd) / one_kl + kr
    ) * cd / one_kl
    return Path(x, y, heading, kappa)


def sample_window_indices(match_idx: Tensor, n_total: int, back: int,
                          forward: int) -> Tensor:
    """Start index of the local window around a match point (``sampling``)."""
    length = back + forward + 1
    return torch.clamp(match_idx - back, 0, max(n_total - length, 0))


def slice_path(path: Path, start: Tensor, length: int) -> Path:
    """Fixed-length slice per row, ``start`` (B,) already clipped to
    [0, n - length]."""
    idx = start[:, None].long() + torch.arange(length, device=start.device)
    take = lambda a: torch.gather(a, 1, idx)  # noqa: E731
    return Path(take(path.x), take(path.y), take(path.theta), take(path.kappa))
