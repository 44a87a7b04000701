"""PyTorch port, behaviours the reference pins in its own tests, on the
port's CPU run of the JAX test's arrays, with the JAX test's assertions:
the emergency brake on arrival (``tests/test_closed_loop.py:73``), a
stopped ego that keeps seeing its lead through three plain tick loops (the
standstill branch of ``_motion_dir``, :89), the ego's stop at a red light,
its run through a green one and an agent NPC's stop at a red one
(``tests/test_traffic_light.py:42``, :69, :82), and a crossing obstacle
slowing the full EM plan (``tests/test_full_em_loop.py:64``). The JAX
function runs on the same arrays and holds the port at the loop's bar
(``torch_port_helpers.assert_metrics_match``: decisions identical, floats
within rtol 1e-5 / atol 5 mm). The first two go through
``chip_smoke.edge_run`` and ``assert_edge``, as on the card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
import test_traffic_light as j_tlt
from emplanner_carla_tpu import types as j_types
from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.planner import em_planner as j_em
from emplanner_carla_tpu.sim import closed_loop as j_cl
from emplanner_carla_tpu.sim import scenario as j_sc
from emplanner_carla_tpu.sim import traffic_light as j_tl
from emplanner_carla_tpu.types import EgoState, Obstacles, Path
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.planner import em_planner
from emplanner_carla_tpu_torch.sim import closed_loop as t_cl
from test_torch_edge_oracle import port_scenario, xy
from torch_port_helpers import assert_metrics_match, np_of

FIELDS = t_cl.TickMetrics._fields


def _cfgs(n_plans):
    jcfg = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=n_plans))
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


def _lights(tl):
    return convert.lights_from_numpy(jax.tree.map(lambda a: np.asarray(a)[None], tl))


def _batch1(tree):
    """A JAX output with a batch axis of 1, as NumPy."""
    return jax.tree.map(lambda a: np.asarray(a)[None], tree)


def _jax_scenario(sc):
    """Lane 0 of a port (global path, ego, obstacles) as JAX arrays."""
    gp, ego, obs = (tuple(jnp.asarray(np_of(t)[0]) for t in part) for part in sc)
    return Path(*gp), EgoState(*ego), Obstacles(*obs)


def test_port_emergency_brake_on_arrival():
    """A 100-node road: the ego arrives and stops."""
    jcfg, tcfg = _cfgs(30)
    sc = j_sc.make_scenario(jax.random.PRNGKey(5), jcfg, n_path=100, n_active_static=0,
                            with_dynamic=False)
    out = chip_smoke.edge_run("emergency_brake", port_scenario(sc), {}, tcfg, "cpu")
    chip_smoke.assert_edge("emergency_brake", out, tcfg)
    assert bool(t_cl.summarize(out[1])["arrived"])
    _, mj = _batch1(j_cl.simulate(sc.global_path, sc.ego0, sc.obstacles, jcfg))
    assert_metrics_match(out[1], mj, FIELDS, "emergency_brake.")


def test_port_stopped_ego_keeps_seeing_its_lead():
    """At rest 5 m behind a stopped lead (inside the 7 m standoff, cap 0),
    300 ticks of the plain tick loop hold the ego exactly: the motion
    direction falls back to the heading at standstill."""
    jcfg = JCfg()
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    sc, extra = chip_smoke.edge_scenario("stopped_behind_lead", tcfg)
    before = t_cl.launches["tick_lqr"]
    ego, m = out = chip_smoke.edge_run("stopped_behind_lead", sc, extra, tcfg, "cpu")
    assert t_cl.launches["tick_lqr"] == before          # CPU tensors: the plain loop
    chip_smoke.assert_edge("stopped_behind_lead", out, tcfg)
    assert float(ego.x[0]) == 25.0 and float(ego.vx[0]) == 0.0
    # the JAX test's three _full_ticks_base loops on the same arrays
    gp, ego_j, obs = _jax_scenario(sc)
    nd = jcfg.speed.n_dense
    tq = jnp.arange(nd, dtype=jnp.float32) * (jcfg.speed.n_t * jcfg.speed.t_step / (nd - 1))
    tspeed = jnp.full((nd,), jcfg.loop.target_speed_kmh / 3.6)
    buf, cnt, last = jnp.zeros(jcfg.control.pid_buffer), jnp.zeros((), jnp.int32), jnp.zeros(())
    arrived, tru = jnp.zeros((), bool), jnp.ones((), bool)
    for _ in range(chip_smoke.EDGE_CASES["stopped_behind_lead"][1]):
        ego_j, buf, cnt, last, obs, arrived, mj = j_cl._full_ticks_base(
            ego_j, buf, cnt, last, obs, tspeed, tq, gp, arrived, tru, tru, gp.x[-1], gp.y[-1],
            j_tl.TrafficLights.none(), jnp.float32(0.0), jcfg)
    assert_metrics_match(m, _batch1(mj), FIELDS[:-1], "stopped_behind_lead.")
    for f in j_types.EgoState._fields:
        np.testing.assert_allclose(np_of(getattr(ego, f)), _batch1(getattr(ego_j, f)),
                                   rtol=1e-5, atol=5e-3, err_msg=f"ego.{f}")


def test_port_ego_stops_at_red_then_proceeds():
    """Red for t < 8 s at a stop line at x = 60: the ego holds short of it,
    nearly stops, and drives through once green."""
    jcfg, tcfg = _cfgs(12)
    sc = j_tlt._straight_scenario(jcfg)
    lights = j_sc.lights_on_path(sc.global_path, [60.0], period=16.0, green_frac=0.5,
                                 offsets=[8.0])
    _, m = t_cl.simulate(*port_scenario(sc), tcfg, lights=_lights(lights), device="cpu")
    _, mj = _batch1(j_cl.simulate(sc.global_path, sc.ego0, sc.obstacles, jcfg, lights=lights))
    assert_metrics_match(m, mj, FIELDS, "red_then_green.")
    xs, _ = xy(m)
    vs = m.speed_kmh.numpy().reshape(-1)
    t = (np.arange(xs.size) + 1) * tcfg.plant.dt
    red = t < 8.0
    assert xs[red].max() < 60.0, f"ran the red at x={xs[red].max():.1f}"
    assert vs[red].min() < 3.0
    assert xs[-1] > 75.0, f"never proceeded (x_end={xs[-1]:.1f})"
    assert not bool(t_cl.summarize(m)["collided"])


def test_port_ego_ignores_green_light():
    jcfg, tcfg = _cfgs(6)
    sc = j_tlt._straight_scenario(jcfg)
    lights = j_sc.lights_on_path(sc.global_path, [60.0], period=1000.0, green_frac=1.0)
    _, m = t_cl.simulate(*port_scenario(sc), tcfg, lights=_lights(lights), device="cpu")
    _, mj = _batch1(j_cl.simulate(sc.global_path, sc.ego0, sc.obstacles, jcfg, lights=lights))
    assert_metrics_match(m, mj, FIELDS, "green.")
    assert xy(m)[0][-1] > 70.0


def test_port_npc_agent_stops_at_red():
    """An agent NPC 30 m ahead at 8 m/s holds at a permanently red light at
    x = 80, and the ego queues behind it without a collision."""
    jcfg, tcfg = _cfgs(12)
    n = 160
    gp = Path(jnp.arange(n) * 2.0, jnp.zeros(n), jnp.zeros(n), jnp.zeros(n))
    K = jcfg.n_static_obs + jcfg.n_dynamic_obs
    dyn = jnp.arange(K) == jcfg.n_static_obs
    obstacles = Obstacles(jnp.where(dyn, 30.0, 0.0), jnp.zeros(K),
                          jnp.where(dyn, 8.0, 0.0), jnp.zeros(K), dyn)
    z = jnp.zeros(())
    ego0 = EgoState(gp.x[0], gp.y[0], gp.theta[0], jnp.asarray(8.0, jnp.float32),
                    z, z, z, z, z)
    lights = j_sc.lights_on_path(gp, [80.0], period=1000.0, green_frac=0.0)
    carry, m = t_cl.simulate_traffic(*port_scenario(j_sc.Scenario(gp, ego0, obstacles)),
                                     tcfg, lights=_lights(lights), device="cpu")
    carry_j, mj = _batch1(j_cl.simulate_traffic(gp, ego0, obstacles, jcfg, lights=lights))
    assert_metrics_match(m, mj, FIELDS, "npc_red.")
    i = tcfg.n_static_obs
    obs = carry.loop.obstacles
    for f in ("x", "y", "vx", "vy"):
        np.testing.assert_allclose(np_of(getattr(obs, f)), getattr(carry_j.loop.obstacles, f),
                                   rtol=1e-5, atol=5e-3, err_msg=f"npc.{f}")
    npc_x = float(obs.x[0, i])
    npc_v = float(np.hypot(float(obs.vx[0, i]), float(obs.vy[0, i])))
    assert npc_x < 80.0, f"NPC ran the red (x={npc_x:.1f})"
    assert npc_v < 1.0, f"NPC still moving at the red (v={npc_v:.1f})"
    assert not bool(t_cl.summarize(m)["collided"])


def test_port_full_em_slows_for_crossing_obstacle():
    """A crossing NPC placed 28 m ahead and 3 m off the path, entering the
    lane band while the ego would pass: the planned speed over the first 3 s
    drops by more than 0.5 m/s against free flow."""
    jcfg = JCfg()
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    sc = j_sc.make_scenario(jax.random.PRNGKey(3), jcfg, n_active_static=0,
                            with_dynamic=False)
    sc = sc._replace(ego0=sc.ego0._replace(vx=jnp.float32(13.9)))
    ox, oy, oth = j_sc.place_on_path(sc.global_path, jnp.asarray([28.0]),
                                     jnp.asarray([-3.0]))
    nx, ny = -jnp.sin(oth[0]), jnp.cos(oth[0])
    d0 = jcfg.n_static_obs
    obs = sc.obstacles._replace(
        x=sc.obstacles.x.at[d0].set(ox[0]), y=sc.obstacles.y.at[d0].set(oy[0]),
        vx=sc.obstacles.vx.at[d0].set(1.2 * nx), vy=sc.obstacles.vy.at[d0].set(1.2 * ny),
        valid=sc.obstacles.valid.at[d0].set(True))
    mi = torch.zeros(1, dtype=torch.int32)
    speeds = []
    for o in (sc.obstacles, obs):
        gp, ego, ob = port_scenario(sc._replace(obstacles=o))
        res = em_planner.plan_full_cycle(gp, ego, ob, mi, tcfg)
        ref = _batch1(j_em.plan_full_cycle(sc.global_path, sc.ego0, o, jnp.int32(0), jcfg))
        np.testing.assert_array_equal(np_of(res.path.feasible), ref.path.feasible)
        np.testing.assert_array_equal(np_of(res.segments_dropped), ref.segments_dropped)
        np.testing.assert_array_equal(np_of(res.trajectory.valid), ref.trajectory.valid)
        for f in ("speed", "accel", "time", "x", "y"):
            np.testing.assert_allclose(np_of(getattr(res.trajectory, f)),
                                       getattr(ref.trajectory, f), rtol=1e-5, atol=5e-3,
                                       err_msg=f"trajectory.{f}")
        speeds.append(float(res.trajectory.speed[0, :150].mean()))
    free, blocked = speeds
    assert blocked < free - 0.5, (free, blocked)
