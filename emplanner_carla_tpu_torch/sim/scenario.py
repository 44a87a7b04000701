"""Scenario construction: synthetic roads, ego spawns, obstacle layouts
(counterpart of ``synthetic_centerline``, ``place_on_path``,
``make_scenario``, ``_place``, ``lights_on_path`` and ``batch_scenarios`` in
``emplanner_carla_tpu/sim/scenario.py``).

A road is a curvature-profile centerline: kappa(s) as a sum of smooth
random bumps, integrated to heading and position. Random draws come from a
seeded ``torch.Generator`` as unit uniforms (:func:`draw_uniforms`); the
deterministic rest (:func:`make_scenario_from_uniforms`) maps them into the
same ranges with the same float32 arithmetic as ``jax.random.uniform``, so
a test can feed it the JAX package's own unit draws. The two generators
give different numbers for the same seed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from emplanner_carla_tpu_torch.config import EMConfig
from emplanner_carla_tpu_torch.ops import frenet
from emplanner_carla_tpu_torch.sim.traffic_light import TrafficLights
from emplanner_carla_tpu_torch.types import EgoState, Obstacles, Path, Tensor

N_BUMPS = 6
WALKER_SPEED = 1.4  # m/s, typical crossing pedestrian


class Scenario(NamedTuple):
    global_path: Path
    ego0: EgoState
    obstacles: Obstacles


class ScenarioUniforms(NamedTuple):
    """Unit draws in [0, 1) for a batch of scenarios."""

    amp: Tensor      # (B, N_BUMPS) curvature bump amplitudes
    pos: Tensor      # (B, N_BUMPS) bump centres
    width: Tensor    # (B, N_BUMPS) bump widths
    s: Tensor        # (B, K) obstacle station jitter within its band
    l: Tensor        # (B, K) obstacle lateral offsets
    dyn: Tensor      # (B,) lead NPC station
    walk: Tensor     # (B,) crossing pedestrian station


def _uniform(u01: Tensor, minval, maxval) -> Tensor:
    """``jax.random.uniform``'s map of unit floats to [minval, maxval):
    u * (max - min) + min, floored at min, in float32."""
    lo = torch.as_tensor(minval, dtype=torch.float32, device=u01.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=u01.device)
    return torch.maximum(lo, u01 * (hi - lo) + lo)


def draw_uniforms(gen: torch.Generator, batch: int, cfg: EMConfig) -> ScenarioUniforms:
    K = cfg.n_static_obs + cfg.n_dynamic_obs
    r = lambda *shape: torch.rand(shape, generator=gen, dtype=torch.float32)  # noqa: E731
    return ScenarioUniforms(
        r(batch, N_BUMPS), r(batch, N_BUMPS), r(batch, N_BUMPS),
        r(batch, K), r(batch, K), r(batch), r(batch),
    )


def synthetic_centerline(amp_u, pos_u, width_u, n: int = 256, ds: float = 2.0,
                         max_kappa: float = 0.02) -> Path:
    """Random smooth centerlines (B, n) at ds spacing: kappa(s) = sum of
    raised-cosine bumps clipped to |max_kappa|, integrated to heading and
    position."""
    dev = amp_u.device
    s = torch.arange(n, device=dev).to(torch.float32) * ds
    total = n * ds
    amps = _uniform(amp_u, -max_kappa, max_kappa)
    centers = _uniform(pos_u, 0.0, total)
    widths = _uniform(width_u, 40.0, 120.0)
    arg = (s[None, :, None] - centers[:, None, :]) / widths[:, None, :]
    bump = torch.where(
        arg.abs() < 1.0, 0.5 * (1.0 + torch.cos(math.pi * arg)), 0.0
    )
    kappa = torch.clamp((amps[:, None, :] * bump).sum(-1), -max_kappa, max_kappa)
    theta = torch.cumsum(kappa * ds, -1) - (kappa[:, :1] * ds)
    x = torch.cumsum(torch.cos(theta) * ds, -1) - torch.cos(theta[:, :1]) * ds
    y = torch.cumsum(torch.sin(theta) * ds, -1) - torch.sin(theta[:, :1]) * ds
    return Path(x, y, theta, kappa)


def place_on_path(path: Path, s: Tensor, l: Tensor):
    """World position of Frenet (s, l) (B, K) relative to the path start."""
    s_map = frenet.arc_length(path)
    x, y, theta, _ = frenet.proj_point_at_s(s, path, s_map)
    return x - l * torch.sin(theta), y + l * torch.cos(theta), theta


def make_scenario_from_uniforms(
    u: ScenarioUniforms,
    cfg: EMConfig,
    n_path: int = 256,
    path_ds: float = 2.0,
    v0: float = 8.0,
    n_active_static: int = 3,
    with_dynamic: bool = True,
    npc_speed: float = 30.0 / 3.6,
    with_walker: bool = False,
) -> Scenario:
    """Deterministic scenario layout from unit draws: the test_9 layout —
    ego at the path start, parked cars in disjoint s bands near the line,
    one slower lead NPC, optionally a crossing pedestrian."""
    gp = synthetic_centerline(u.amp, u.pos, u.width, n_path, path_ds)
    B = u.s.shape[0]
    dev = u.s.device
    K = cfg.n_static_obs + cfg.n_dynamic_obs
    slot = torch.arange(K, device=dev)
    is_static_slot = slot < cfg.n_static_obs
    static_active = slot < n_active_static

    s_extent = torch.tensor(n_path * path_ds, dtype=torch.float32, device=dev)
    s_max = torch.clamp(s_extent - 100.0, max=300.0)
    band = (s_max - 60.0) / max(cfg.n_static_obs, 1)
    obs_s = (
        60.0
        + band * torch.arange(K, device=dev).to(torch.float32)
        + _uniform(u.s, 0.1 * band, 0.9 * band)
    )
    obs_l = _uniform(u.l, -1.0, 1.0)

    dyn_slot = slot == cfg.n_static_obs
    dyn_s0 = _uniform(u.dyn, 30.0, 45.0)
    obs_s = torch.where(dyn_slot, dyn_s0[:, None], obs_s)
    obs_l = torch.where(dyn_slot, 0.0, obs_l)

    walker_slot = slot == cfg.n_static_obs + 1
    walk_s = _uniform(u.walk, 65.0, 85.0)
    obs_s = torch.where(walker_slot, walk_s[:, None], obs_s)
    obs_l = torch.where(walker_slot, -8.0, obs_l)

    ox, oy, oth = place_on_path(gp, obs_s, obs_l)
    dyn_active = dyn_slot & with_dynamic
    walker_active = walker_slot & with_walker
    ovx = torch.where(dyn_active, npc_speed * torch.cos(oth), 0.0)
    ovy = torch.where(dyn_active, npc_speed * torch.sin(oth), 0.0)
    ovx = torch.where(walker_active, -WALKER_SPEED * torch.sin(oth), ovx)
    ovy = torch.where(walker_active, WALKER_SPEED * torch.cos(oth), ovy)
    valid = ((is_static_slot & static_active) | dyn_active | walker_active)
    obstacles = Obstacles(ox, oy, ovx, ovy, valid[None, :].expand(B, K).clone())

    z = torch.zeros(B, dtype=torch.float32, device=dev)
    ego0 = EgoState(
        gp.x[:, 0].clone(), gp.y[:, 0].clone(), gp.theta[:, 0].clone(),
        torch.full((B,), v0, dtype=torch.float32, device=dev), z, z, z, z, z,
    )
    return Scenario(gp, ego0, obstacles)


def lights_on_path(gp: Path, s_positions, period: float = 12.0,
                   green_frac: float = 0.5, offsets=None, device="cuda"):
    """Traffic lights at path stations (stop lines on the centerline) for a
    batch of global paths (B, N): ``s_positions`` (L,) or (B, L), ``offsets``
    likewise (zeros by default). Returns a ``traffic_light.TrafficLights`` of
    (B, L) on ``device`` (the card unless the caller asks for the CPU), for
    the closed loops' ``lights`` argument."""
    gp = Path(*(a.to(device) for a in gp))
    B = gp.x.shape[0]
    s = torch.as_tensor(s_positions, dtype=torch.float32, device=device)
    s = s.expand(B, s.shape[-1]).contiguous()
    x, y, _ = place_on_path(gp, s, torch.zeros_like(s))
    off = (torch.zeros_like(s) if offsets is None else
           torch.as_tensor(offsets, dtype=torch.float32, device=device)
           .expand_as(s).contiguous())
    return TrafficLights(
        x, y, torch.full_like(s, period), off, torch.full_like(s, green_frac),
        torch.ones_like(s, dtype=torch.bool),
    )


def batch_scenarios(seed: int, batch: int, cfg: EMConfig, device="cuda",
                    **kw) -> Scenario:
    """A batch of randomized scenarios (the fleet input), drawn from a
    ``torch.Generator`` seeded with ``seed`` and built on ``device`` (the
    card unless the caller asks for the CPU). The same seed gives the same
    scenarios on every device."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    u = draw_uniforms(gen, batch, cfg)
    u = ScenarioUniforms(*[t.to(device) for t in u])
    return make_scenario_from_uniforms(u, cfg, **kw)
