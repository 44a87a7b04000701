"""Scenario construction: synthetic and routed roads, ego spawns, obstacle
layouts (counterpart of ``emplanner_carla_tpu/sim/scenario.py``:
``synthetic_centerline``, ``place_on_path``, ``make_scenario``,
``populate_scenario``, ``_place``, ``lights_on_path``, ``batch_scenarios``,
``test9_scenario``, ``routed_scenarios`` and ``routed_scenarios_device``).

A road is a curvature-profile centerline: kappa(s) as a sum of smooth
random bumps, integrated to heading and position. Random draws come from a
seeded ``torch.Generator`` as unit uniforms (:func:`draw_uniforms`); the
deterministic rest (:func:`make_scenario_from_uniforms`) maps them into the
same ranges with the same float32 arithmetic as ``jax.random.uniform``, so
a test can feed it the JAX package's own unit draws. The two generators
give different numbers for the same seed. Routed fleets take their
(origin, destination) pairs from a seeded generator too, or from the
caller, and place the same layout along each route's own extent.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from emplanner_carla_tpu_torch.config import EMConfig
from emplanner_carla_tpu_torch.ops import frenet
from emplanner_carla_tpu_torch.routing import astar
from emplanner_carla_tpu_torch.routing import graph as graph_mod
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
    s_extent = torch.full((u.s.shape[0],), n_path * path_ds, dtype=torch.float32,
                          device=u.s.device)
    return _place(PlacementUniforms(u.s, u.l, u.dyn, u.walk), cfg, gp, s_extent,
                  v0, n_active_static, with_dynamic, npc_speed, with_walker)


class PlacementUniforms(NamedTuple):
    """Unit draws in [0, 1) of an obstacle layout along given paths (the
    placement fields of ``ScenarioUniforms``)."""

    s: Tensor        # (B, K) obstacle station jitter within its band
    l: Tensor        # (B, K) obstacle lateral offsets
    dyn: Tensor      # (B,) lead NPC station
    walk: Tensor     # (B,) crossing pedestrian station


def draw_placement(gen: torch.Generator, batch: int, cfg: EMConfig) -> PlacementUniforms:
    K = cfg.n_static_obs + cfg.n_dynamic_obs
    r = lambda *shape: torch.rand(shape, generator=gen, dtype=torch.float32)  # noqa: E731
    return PlacementUniforms(r(batch, K), r(batch, K), r(batch), r(batch))


def populate_scenario_from_uniforms(
    u: PlacementUniforms,
    cfg: EMConfig,
    gp: Path,
    s_extent: Tensor,
    v0: float = 8.0,
    n_active_static: int = 3,
    with_dynamic: bool = True,
    npc_speed: float = 30.0 / 3.6,
    with_walker: bool = False,
) -> Scenario:
    """Place the ego and the obstacle layout along given global paths
    (synthetic or routed), (B, N); ``s_extent`` (B,) the usable arc length
    of each lane's path."""
    return _place(u, cfg, gp, s_extent, v0, n_active_static, with_dynamic,
                  npc_speed, with_walker)


def _place(u: PlacementUniforms, cfg: EMConfig, gp: Path, s_extent: Tensor, v0,
           n_active_static, with_dynamic, npc_speed, with_walker) -> Scenario:
    """Parked cars in disjoint s bands of each lane's extent (B,), the lead
    NPC and the optional crossing pedestrian, ego at the path start."""
    B = u.s.shape[0]
    dev = u.s.device
    K = cfg.n_static_obs + cfg.n_dynamic_obs
    slot = torch.arange(K, device=dev)
    is_static_slot = slot < cfg.n_static_obs
    static_active = slot < n_active_static

    # spread static obstacles over disjoint s bands so they never stack on
    # the spawn point or each other
    s_max = torch.clamp(s_extent - 100.0, max=300.0)[:, None]      # (B, 1)
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


def make_scenario(seed: int, cfg: EMConfig, device="cuda", **kw) -> Scenario:
    """One randomized scenario, the test_9 layout (:func:`batch_scenarios`'
    draw at batch 1, keyword arguments as ``make_scenario_from_uniforms``'):
    every field has a batch axis of 1."""
    return batch_scenarios(seed, 1, cfg, device=device, **kw)


def populate_scenario(seed: int, cfg: EMConfig, gp: Path, s_extent: Tensor,
                      device="cuda", **kw) -> Scenario:
    """The ego and the obstacle layout along given global paths (B, N) with
    usable arc lengths ``s_extent`` (B,), placed from unit draws of a
    ``torch.Generator`` seeded with ``seed`` (keyword arguments as
    :func:`populate_scenario_from_uniforms`'), on ``device``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    u = draw_placement(gen, gp.x.shape[0], cfg)
    u = PlacementUniforms(*[t.to(device) for t in u])
    return populate_scenario_from_uniforms(
        u, cfg, type(gp)(*[f.to(device) for f in gp]),
        torch.as_tensor(s_extent, dtype=torch.float32, device=device).expand(gp.x.shape[0]),
        **kw)


def _routed_paths(x: Tensor, y: Tensor, n_valid: Tensor) -> Path:
    """Global paths (B, pad_to) from stitched route points, the heading and
    curvature of the padded tail held at the last valid point (repeated end
    points would give theta = kappa = 0 there)."""
    gp = frenet.path_from_xy(x, y)
    idx = torch.minimum(torch.arange(x.shape[1], device=x.device)[None, :],
                        n_valid.to(torch.int64)[:, None] - 1)
    return gp._replace(theta=torch.gather(gp.theta, 1, idx),
                       kappa=torch.gather(gp.kappa, 1, idx))


def test9_scenario(cfg: EMConfig, v0: float = 8.0, pad_to: int = 256,
                   device="cuda"):
    """The reference's headline scenario (``test_9.py:242-291``), batch 1:
    the recorded Town05 sub-network (``routing.graph.town05_test9``), the
    ego routed from the spawn-259 stand-in to the spawn-48 stand-in by host
    A*, the three parked cars and the BehaviorAgent NPC (30 km/h, on the
    ego's own road) at the reference's pinned world coordinates. Returns
    (Scenario of batch 1, n_valid (1,) int32) on ``device`` (the card unless
    the caller asks for the CPU). Drive it with
    ``closed_loop.simulate_traffic``."""
    town = graph_mod.town05_test9()
    x, y, n_valid, _ = astar.plan_route(
        town, graph_mod.TEST9_EGO_SPAWN, graph_mod.TEST9_DESTINATION,
        pad_to=pad_to, with_options=True,
    )
    f32 = dict(dtype=torch.float32, device=device)
    nv = torch.tensor([n_valid], dtype=torch.int32, device=device)
    gp = _routed_paths(torch.as_tensor(x.astype(np.float32), device=device)[None],
                       torch.as_tensor(y.astype(np.float32), device=device)[None], nv)

    K = cfg.n_static_obs + cfg.n_dynamic_obs
    ox, oy, ovx, ovy = (np.zeros(K, np.float32) for _ in range(4))
    valid = np.zeros(K, bool)
    statics = graph_mod.TEST9_STATICS
    if len(statics) > cfg.n_static_obs:
        raise ValueError("cfg.n_static_obs too small for the fixture")
    for i, (sx, sy, _yaw) in enumerate(statics):
        ox[i], oy[i], valid[i] = sx, sy, True
    d0 = cfg.n_static_obs
    nx, ny, nspeed = graph_mod.TEST9_NPC
    ox[d0], oy[d0] = nx, ny
    ovy[d0] = nspeed                    # the spawn road heads +y
    valid[d0] = True
    obstacles = Obstacles(*(torch.as_tensor(a[None], **f32) for a in (ox, oy, ovx, ovy)),
                          torch.as_tensor(valid[None], device=device))
    z = torch.zeros(1, **f32)
    ego0 = EgoState(gp.x[:, 0].clone(), gp.y[:, 0].clone(), gp.theta[:, 0].clone(),
                    torch.full((1,), v0, **f32), z, z, z, z, z)
    return Scenario(gp, ego0, obstacles), nv


class RoutedScenarios(NamedTuple):
    """A fleet whose global paths come from A* routes over a road graph."""

    scenario: Scenario      # global_path padded to a fixed length, (B, pad_to)
    road_option: Tensor     # (B, pad_to) int32 RoadOption per path point
    n_valid: Tensor         # (B,) int32 valid path-point counts


def _populate_routed(x, y, n_valid, options, town, seed, batch, cfg, placement,
                     device, kw) -> RoutedScenarios:
    gp = _routed_paths(x, y, n_valid)
    if placement is None:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(seed))
        placement = draw_placement(gen, batch, cfg)
    placement = PlacementUniforms(*[torch.as_tensor(t).to(device) for t in placement])
    # the graph's resample spacing turns point counts into metres
    s_extent = n_valid.to(torch.float32) * town.resolution
    sc = populate_scenario_from_uniforms(placement, cfg, gp, s_extent, **kw)
    return RoutedScenarios(sc, options, n_valid)


def routed_scenarios(seed: int, batch: int, cfg: EMConfig, town=None,
                     pad_to: int = 256, min_points: int = 120, pairs=None,
                     placement: PlacementUniforms | None = None, device="cuda",
                     **kw) -> RoutedScenarios:
    """Fleet scenarios routed through a town (``grid_town_curved`` by
    default) by host A* and host stitching (the reference routes the town
    before every drive, ``test_9.py:295-313``), the layout of
    ``batch_scenarios`` placed along each route.

    Candidate (origin, destination) node pairs are drawn as
    ``rng.integers(0, N, 2)`` from ``numpy.random.default_rng(seed)``, or
    taken in order from ``pairs`` = (origins, destinations); o == d, unroutable pairs and routes of
    fewer than ``min_points`` points are skipped until ``batch`` are kept.
    ``placement``: the layout's unit draws, else drawn from a
    ``torch.Generator`` seeded with ``seed``. Built on ``device`` (the card
    unless the caller asks for the CPU)."""
    if town is None:
        town = graph_mod.grid_town_curved()
    N = town.n_nodes
    if pairs is None:
        rng = np.random.default_rng(int(seed))
        cand = (rng.integers(0, N, 2) for _ in iter(int, 1))
    else:
        cand = zip(*(np.asarray(p).tolist() for p in pairs))
    route_cache: dict[tuple[int, int], tuple | None] = {}
    xs, ys, opts, ns = [], [], [], []
    while len(xs) < batch:
        try:
            o, d = next(cand)
        except StopIteration:
            raise ValueError(f"only {len(xs)}/{batch} routable pairs in `pairs`") from None
        if o == d:
            continue
        pair = (int(o), int(d))
        if pair not in route_cache:
            try:
                route_cache[pair] = astar.plan_route(
                    town, tuple(town.nodes_xy[pair[0]]), tuple(town.nodes_xy[pair[1]]),
                    pad_to=pad_to, with_options=True,
                )
            except ValueError:
                route_cache[pair] = None
        r = route_cache[pair]
        if r is None or r[2] < min_points:
            continue
        xs.append(r[0])
        ys.append(r[1])
        ns.append(r[2])
        opts.append(r[3])
    f32 = dict(dtype=torch.float32, device=device)
    x = torch.as_tensor(np.stack(xs).astype(np.float32), **f32)
    y = torch.as_tensor(np.stack(ys).astype(np.float32), **f32)
    n_valid = torch.as_tensor(np.asarray(ns, np.int32), device=device)
    options = torch.as_tensor(np.stack(opts).astype(np.int32), device=device)
    return _populate_routed(x, y, n_valid, options, town, seed, batch, cfg,
                            placement, device, kw)


def routed_scenarios_device(seed: int, batch: int, cfg: EMConfig, town=None,
                            pad_to: int = 256, min_points: int = 120,
                            oversample: int = 8, pairs=None,
                            placement: PlacementUniforms | None = None,
                            device="cuda", **kw) -> RoutedScenarios:
    """``routed_scenarios`` with the route queries on ``device`` (the card
    unless the caller asks for the CPU): batched ``astar_device``,
    backtracking and stitching (``route_nodes_device`` /
    ``stitch_route_device``) for ``oversample * batch`` candidate pairs at
    once. The candidates are (origins, destinations), each
    (oversample * batch,), drawn by ``torch.randint`` from a
    ``torch.Generator`` seeded with ``seed``, or given as ``pairs``. The
    first ``batch`` routed, with o != d and at least ``min_points`` points,
    are kept (only the (n_cand,) selection mask goes to the host); fewer
    raise ``ValueError``. ``placement`` as in ``routed_scenarios``."""
    if town is None:
        town = graph_mod.grid_town_curved()
    N = town.n_nodes
    n_cand = oversample * batch
    if pairs is None:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(seed))
        pairs = (torch.randint(0, N, (n_cand,), generator=gen),
                 torch.randint(0, N, (n_cand,), generator=gen))
    o, d = (torch.as_tensor(np.array(p)).to(device=device, dtype=torch.int32)
            for p in pairs)
    route, valid, reached = astar.route_nodes_device(town, o, d)
    x, y, n, opt = astar.stitch_route_device(town, route, valid, pad_to)
    ok = reached & (o != d) & (n >= min_points)
    sel = torch.nonzero(ok.cpu())[:, 0]
    if sel.numel() < batch:
        raise ValueError(f"only {sel.numel()}/{batch} routable pairs at oversample="
                         f"{oversample}; raise oversample")
    sel = sel[:batch].to(device)
    return _populate_routed(x[sel], y[sel], n[sel], opt[sel], town, seed, batch, cfg,
                            placement, device, kw)
