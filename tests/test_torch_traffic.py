"""PyTorch port, agent traffic: the plain tick loop of the traffic branch
(the K7 kernel's plain version, ``closed_loop._traffic_ticks_base``) against
``jax.vmap(closed_loop._traffic_ticks_base)``, and ``simulate_traffic``
(path-only and full EM, with and without traffic lights) against
``jax.vmap(closed_loop.simulate_traffic)``, on the same JAX-made inputs;
then two hand-built scenarios: a parked car that makes an 8 m/s agent
change lanes (resumed mid-manoeuvre from the JAX package's TrafficCarry)
and two agents in one lane (every NPC must see the other slots as they
stood at the start of the tick).

Bars: the plain K7 loop at the JAX package's kernel-vs-scan traffic bar
(``tests/test_tick_pallas.py``: NPC indices, lane targets and decisions
identical, lane offsets within 1e-5, positions within 1e-3, with
``torch_port_helpers.assert_traffic_bar``); the loops at
``__graft_entry__._assert_metrics_match``'s (decisions identical, floats
within rtol 1e-5 / atol 5 mm).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.planner import em_planner as j_em
from emplanner_carla_tpu.sim import closed_loop as j_cl
from emplanner_carla_tpu.sim import scenario as j_sc
from emplanner_carla_tpu.sim.traffic_light import TrafficLights
from emplanner_carla_tpu.types import EgoState as JEgo
from emplanner_carla_tpu.types import Obstacles as JObs
from emplanner_carla_tpu.types import Path as JPath
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.sim import closed_loop as t_cl
from torch_port_helpers import assert_metrics_match, assert_traffic_bar, np_of, t32

JC = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=2, plan_every=20))
TC = convert.config_from_dict(dataclasses.asdict(JC))
B = 8
LIGHT_S = (25.0, 51.0)   # between nodes of the 2 m paths
OFFSETS = np.asarray([0.0, 3.9, 5.0, 6.5, 8.0, 11.95, 2.0, 9.0], np.float32)


def _jax_lights(gp, stations=LIGHT_S):
    return jax.vmap(lambda g, off: j_sc.lights_on_path(
        g, stations, period=12.0, green_frac=0.5, offsets=off))(
        gp, jnp.stack([OFFSETS[:gp.x.shape[0]]] * len(stations), 1))


def _port(sc):
    return (convert.path_from_numpy(sc.global_path), convert.ego_from_numpy(sc.ego0),
            convert.obstacles_from_numpy(sc.obstacles))


def _close(a, b, atol, name):
    np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=0, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def k7_inputs():
    """One traffic cycle's tick inputs from a JAX full EM plan on the bench
    mix with its walker; half the lanes start with their agent mid lane
    change (offset 0-3.5 m toward a 3.5 m target)."""
    sc = j_sc.batch_scenarios(jax.random.PRNGKey(3), B, JC, n_path=96,
                              with_walker=True)
    mi = jax.vmap(lambda e, g: j_cl.frenet.nearest_index(e.x, e.y, g))(
        sc.ego0, sc.global_path)
    res = jax.jit(jax.vmap(lambda g, e, o, m: j_em.plan_full_cycle(g, e, o, m, JC)))(
        sc.global_path, sc.ego0, sc.obstacles, mi)
    K = sc.obstacles.x.shape[1]
    npc_idx = jax.vmap(lambda g, o: j_cl.frenet.nearest_index(o.x, o.y, g))(
        sc.global_path, sc.obstacles)
    speed0 = np.hypot(np.asarray(sc.obstacles.vx), np.asarray(sc.obstacles.vy))
    agent = (np.arange(K) >= JC.n_static_obs) & (speed0 > 2.5)
    assert agent.any(1).all()
    assert np.allclose(speed0[:, JC.n_static_obs + 1], 1.4)    # the walker
    rng = np.random.default_rng(0)
    mid = (np.arange(B) % 2 == 1)[:, None] & agent
    lane_tgt = np.where(mid, 3.5, 0.0).astype(np.float32)
    lane_off = np.where(mid, rng.uniform(0.0, 3.5, (B, K)), 0.0).astype(np.float32)
    nb = JC.control.pid_buffer
    traj = res.trajectory
    return dict(
        sc=sc, target=jax.tree.map(np.asarray, res.path.target),
        tspeed=np.nan_to_num(np.asarray(traj.speed)),
        ttime=np.nan_to_num(np.asarray(traj.time)), feas=np.asarray(res.path.feasible),
        npc_idx=np.asarray(npc_idx), agent=agent, lane_off=lane_off,
        lane_tgt=lane_tgt, pid=(np.zeros((B, nb), np.float32),
                                np.zeros(B, np.int32), np.zeros(B, np.float32)),
    )


def _k7_jax(inp, behavior, lights, t0):
    sc = inp["sc"]
    gp = sc.global_path
    fn = jax.jit(jax.vmap(lambda *a: j_cl._traffic_ticks_base(*a, JC, behavior)))
    ones = np.ones(B, bool)
    return fn(sc.ego0, *inp["pid"], sc.obstacles, inp["npc_idx"], inp["lane_off"],
              inp["lane_tgt"], inp["agent"], inp["tspeed"], inp["ttime"],
              inp["target"], ~ones, inp["feas"], ones, gp.x[:, -1], gp.y[:, -1], gp,
              lights, t0)


def _k7_port(inp, behavior, lights, t0):
    gp, ego, obs = _port(inp["sc"])
    ones = torch.ones(B, dtype=torch.bool)
    traffic = t_cl.TrafficInputs(gp, torch.as_tensor(np.array(inp["npc_idx"])), t32(inp["lane_off"]),
                                 t32(inp["lane_tgt"]), torch.as_tensor(inp["agent"]),
                                 behavior)
    return t_cl.run_traffic_ticks(
        ego, *[torch.as_tensor(a) for a in inp["pid"]], obs, t32(inp["tspeed"]),
        t32(inp["ttime"][0]), convert.path_from_numpy(inp["target"]), ~ones,
        torch.as_tensor(inp["feas"]), ones, gp.x[:, -1].contiguous(),
        gp.y[:, -1].contiguous(), TC, traffic=traffic,
        lights=None if lights is None else convert.lights_from_numpy(lights),
        t0=None if t0 is None else t32(t0))


@pytest.mark.parametrize("behavior,with_lights", [
    ("normal", False), ("cautious", True), ("aggressive", False),
])
def test_k7_plain_matches_jax_tick_loop(k7_inputs, behavior, with_lights):
    inp = k7_inputs
    t0 = np.full(B, 2.0, np.float32)
    if with_lights:
        lights = _jax_lights(inp["sc"].global_path)
    else:
        lights = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                              TrafficLights.none())
    ref = _k7_jax(inp, behavior, lights, t0)
    before = dict(t_cl.launches)
    out = _k7_port(inp, behavior, lights if with_lights else None,
                   t0 if with_lights else None)
    assert t_cl.launches == before      # CPU tensors: the plain loop
    (ego_j, buf_j, cnt_j, last_j, obs_j, idx_j, off_j, tgt_j, arr_j, m_j) = ref
    assert_traffic_bar(out, (ego_j, buf_j, cnt_j, last_j, obs_j, arr_j, m_j, None,
                             idx_j, off_j, tgt_j))
    assert_metrics_match(t_cl.TickMetrics(*out[6], None), m_j,
                         j_cl.TickMetrics._fields[:8], "ticks.")
    # the agents drove and decided: indices advanced, some lane targets moved
    assert (np_of(out[8]) != inp["npc_idx"]).any()
    assert (np_of(out[10]) != inp["lane_tgt"]).any()
    if with_lights:
        free = _k7_port(inp, behavior, None, None)
        moved = np.abs(np_of(out[4].x) - np_of(free[4].x)) > 1e-3
        assert moved[inp["agent"]].any()


@pytest.fixture(scope="module")
def jax_traffic_runs():
    """JAX ``simulate_traffic`` on the bench mix with its walker: path-only
    under each behaviour with lights (normal without), full EM under
    normal."""
    sc = j_sc.batch_scenarios(jax.random.PRNGKey(0), B, JC, n_path=96,
                              with_walker=True)
    lights = _jax_lights(sc.global_path)
    out = {}
    for key, behavior, full, tl in (("normal", "normal", False, None),
                                    ("cautious+lights", "cautious", False, lights),
                                    ("full", "normal", True, None),
                                    ("full+lights", "aggressive", True, lights)):
        run = jax.jit(jax.vmap(lambda g, e, o, l, _b=behavior, _f=full: j_cl.simulate_traffic(
            g, e, o, JC, behavior=_b, full=_f, lights=l)))
        carry, metrics = run(sc.global_path, sc.ego0, sc.obstacles, tl)
        out[key] = (behavior, full, tl, jax.tree.map(np.asarray, carry), metrics)
    return sc, out


@pytest.mark.parametrize("key", ["normal", "cautious+lights", "full", "full+lights"])
def test_simulate_traffic_matches_jax(jax_traffic_runs, key):
    sc, runs = jax_traffic_runs
    behavior, full, lights, carry_j, mj = runs[key]
    carry_t, mt = t_cl.simulate_traffic(
        *_port(sc), TC, behavior=behavior, full=full,
        lights=None if lights is None else convert.lights_from_numpy(lights),
        device="cpu")
    assert_metrics_match(mt, mj, j_cl.TickMetrics._fields, f"traffic[{key}].")
    lc_t, lc_j = carry_t.loop, carry_j.loop
    for f in ("x", "y", "phi", "vx"):
        np.testing.assert_allclose(np_of(getattr(lc_t.ego, f)), getattr(lc_j.ego, f),
                                   rtol=1e-5, atol=5e-3, err_msg=f"ego.{f}")
    for f in ("x", "y", "vx", "vy"):
        np.testing.assert_allclose(np_of(getattr(lc_t.obstacles, f)),
                                   getattr(lc_j.obstacles, f), rtol=1e-5, atol=5e-3,
                                   err_msg=f"obstacles.{f}")
    np.testing.assert_array_equal(np_of(lc_t.match_index), lc_j.match_index)
    np.testing.assert_array_equal(np_of(lc_t.arrived), lc_j.arrived)
    np.testing.assert_array_equal(np_of(lc_t.ctrl.pid.count), lc_j.ctrl.pid.count)
    np.testing.assert_array_equal(np_of(carry_t.npc_path_index), carry_j.npc_path_index)
    np.testing.assert_array_equal(np_of(carry_t.npc_lane.target), carry_j.npc_lane.target)
    np.testing.assert_allclose(np_of(carry_t.npc_lane.offset), carry_j.npc_lane.offset,
                               atol=1e-5)
    # the agent slot drove
    d0 = TC.n_static_obs
    moved = np.hypot(np_of(lc_t.obstacles.x[:, d0]) - np.asarray(sc.obstacles.x[:, d0]),
                     np_of(lc_t.obstacles.y[:, d0]) - np.asarray(sc.obstacles.y[:, d0]))
    assert (moved > 2.0).all()


def _straight(n=200):
    s = jnp.arange(n) * 2.0
    z = jnp.zeros(n)
    return JPath(s, z, z, z)


def _hand_scenario(cfg, xs, vxs, valid_slots, ego_v):
    """Straight road; obstacle slot k at (xs[k], 0) moving at vxs[k] along
    it, valid where listed; the ego at the origin at ``ego_v``."""
    K = cfg.n_static_obs + cfg.n_dynamic_obs
    ox, ovx, valid = jnp.zeros(K), jnp.zeros(K), jnp.zeros(K, bool)
    for k, x, v in zip(valid_slots, xs, vxs):
        ox, ovx, valid = ox.at[k].set(x), ovx.at[k].set(v), valid.at[k].set(True)
    z = jnp.zeros(())
    return (_straight(), JEgo(z, z, z, jnp.float32(ego_v), z, z, z, z, z),
            JObs(ox, jnp.zeros(K), ovx, jnp.zeros(K), valid))


def _batched(tree):
    return jax.tree.map(lambda a: np.asarray(a)[None], tree)


def test_lane_change_and_resume_mid_manoeuvre_match_jax():
    """A parked car 40 m ahead of an 8 m/s agent (``tests/test_aux.py``'s
    checkpoint scenario). After two 100-tick cycles the agent is mid lane
    change; resumed from the JAX package's TrafficCarry
    (``convert.traffic_carry_from_numpy``, through ``npc_init``) it completes
    the change to the left lane (go_left), and resumed once more, past the
    car, it merges back. Both packages run every stage from the same carry."""
    cfg = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=2))
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    d0 = cfg.n_static_obs
    gp, ego0, obs0 = _hand_scenario(cfg, (60.0, 20.0), (0.0, 8.0), (0, d0), 5.0)
    tgp = convert.path_from_numpy(_batched(gp))
    carry_j, m_j = j_cl.simulate_traffic(gp, ego0, obs0, cfg, behavior="normal")
    carry_t, m_t = t_cl.simulate_traffic(
        tgp, convert.ego_from_numpy(_batched(ego0)),
        convert.obstacles_from_numpy(_batched(obs0)), tcfg, device="cpu")
    stages = [("start", carry_t, m_t, carry_j, m_j)]
    for label in ("resumed", "resumed again"):
        lc = carry_j.loop
        carry_j, m_j = j_cl.simulate_traffic(
            gp, lc.ego, lc.obstacles, cfg, behavior="normal",
            npc_init=(carry_j.npc_path_index, carry_j.npc_lane))
        tc = convert.traffic_carry_from_numpy(_batched(stages[-1][3]))
        carry_t, m_t = t_cl.simulate_traffic(
            tgp, tc.loop.ego, tc.loop.obstacles, tcfg,
            npc_init=(tc.npc_path_index, tc.npc_lane), device="cpu")
        stages.append((label, carry_t, m_t, carry_j, m_j))
    for label, c_t, mt, c_j, mj in stages:
        assert_metrics_match(mt, _batched(mj), j_cl.TickMetrics._fields, f"{label}.")
        np.testing.assert_array_equal(np_of(c_t.npc_lane.target),
                                      _batched(c_j.npc_lane.target))
        np.testing.assert_array_equal(np_of(c_t.npc_path_index),
                                      _batched(c_j.npc_path_index))
        _close(c_t.npc_lane.offset, _batched(c_j.npc_lane.offset), 1e-5, f"{label} offset")
        _close(c_t.loop.obstacles.x, _batched(c_j.loop.obstacles.x), 1e-3, f"{label} x")
        assert not bool(mt.collided.any())
    off = [float(st[1].npc_lane.offset[0, d0]) for st in stages]
    tgt = [float(st[1].npc_lane.target[0, d0]) for st in stages]
    x = [float(st[1].loop.obstacles.x[0, d0]) for st in stages]
    assert 0.5 < off[0] < 3.4                      # checkpointed mid-manoeuvre
    assert off[1] == 3.5 and tgt[1] == 3.5         # the change to the left completed
    assert x[2] > 60.0 + 8.0 and tgt[2] == 0.0 and off[2] < 3.4   # past, merging back


def test_two_agents_update_simultaneously():
    """Two agents in one lane, 30 m apart, the follower faster but not
    blocked (the leader is above 0.8 of the cautious preset's top speed):
    the follower's IDM gap, every tick, is the leader's position at the
    start of the tick, as in the JAX package, whose slots update together.
    Both slot orders, over two 100-tick cycles, so that an in-place update
    of either slot (the leader moving 7.5 cm a tick before the follower
    looks) shows in the follower's position."""
    cfg = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=2))
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    d0 = cfg.n_static_obs
    lanes = [_hand_scenario(cfg, (45.0, 15.0), (7.5, 8.0), slots, 4.0)
             for slots in ((d0, d0 + 1), (d0 + 1, d0))]
    gp, ego0, obs0 = jax.tree.map(lambda *a: jnp.stack(a), *lanes)
    carry_j, m_j = jax.jit(jax.vmap(lambda g, e, o: j_cl.simulate_traffic(
        g, e, o, cfg, behavior="cautious")))(gp, ego0, obs0)
    carry_t, m_t = t_cl.simulate_traffic(
        convert.path_from_numpy(gp), convert.ego_from_numpy(ego0),
        convert.obstacles_from_numpy(obs0), tcfg, behavior="cautious", device="cpu")
    assert_metrics_match(m_t, m_j, j_cl.TickMetrics._fields, "two agents.")
    for f in ("x", "vx"):
        _close(getattr(carry_t.loop.obstacles, f), getattr(carry_j.loop.obstacles, f),
               1e-4, f"obstacles.{f}")
    np.testing.assert_array_equal(np_of(carry_t.npc_path_index),
                                  np.asarray(carry_j.npc_path_index))
    # the follower braked for the leader in its own lane
    vx = np_of(carry_t.loop.obstacles.vx)
    assert vx[0, d0 + 1] < 7.5 and vx[1, d0] < 7.5
    assert not np_of(carry_t.npc_lane.target).any()
