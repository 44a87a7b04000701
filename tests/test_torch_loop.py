"""PyTorch port, closed loop: the plain tick loop (the K3 kernel's plain
version) against ``jax.vmap(_full_ticks_base)``, and the port's
``simulate`` against ``jax.vmap(closed_loop.simulate)`` on the same
JAX-made scenarios, from the start and from a mid-run JAX carry."""

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
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.sim import closed_loop as t_cl
from emplanner_carla_tpu_torch.sim import scenario as t_sc
from torch_port_helpers import assert_metrics_match, np_of

JC = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=2, plan_every=20))
TC = convert.config_from_dict(dataclasses.asdict(JC))
B = 8
TICK_FIELDS = ("x", "y", "speed_kmh", "lateral_err", "heading", "collided",
               "arrived", "feasible")


def _scenarios(seed=0, **kw):
    return j_sc.batch_scenarios(jax.random.PRNGKey(seed), B, JC, n_path=96, **kw)


def _tick_inputs():
    """One cycle's tick-loop inputs from a real JAX plan: edge cases in
    some lanes (bad plan, already arrived, destination within reach)."""
    sc = _scenarios(1)
    mi = jax.vmap(lambda e, g: j_cl.frenet.nearest_index(e.x, e.y, g))(sc.ego0, sc.global_path)
    res = jax.jit(jax.vmap(lambda g, e, o, m: j_em.plan_path_cycle(g, e, o, m, JC)))(
        sc.global_path, sc.ego0, sc.obstacles, mi)
    v, tq = t_cl._constant_profile(TC)
    tspeed = np.full((B, tq.shape[0]), v, np.float32)
    plan_ok = np.ones(B, bool)
    plan_ok[1] = False
    arrived = np.zeros(B, bool)
    arrived[2] = True
    dest_x = np.asarray(sc.global_path.x[:, -1]).copy()
    dest_y = np.asarray(sc.global_path.y[:, -1]).copy()
    dest_x[3] = float(sc.ego0.x[3]) + 2.5      # reached within the cycle
    dest_y[3] = float(sc.ego0.y[3])
    feas = np.asarray(res.feasible)
    nb = JC.control.pid_buffer
    pid = (np.zeros((B, nb), np.float32), np.zeros(B, np.int32), np.zeros(B, np.float32))
    return sc, res.target, tspeed, tq, plan_ok, arrived, feas, dest_x, dest_y, pid


def _tick_args_torch(inp, device="cpu"):
    sc, target, tspeed, tq, plan_ok, arrived, feas, dest_x, dest_y, pid = inp
    f = lambda a, dt=torch.float32: torch.as_tensor(np.array(a), device=device, dtype=dt)  # noqa: E731
    return (
        convert.ego_from_numpy(sc.ego0, device), f(pid[0]), f(pid[1], torch.int32),
        f(pid[2]), convert.obstacles_from_numpy(sc.obstacles, device), f(tspeed),
        f(tq), convert.path_from_numpy(target, device), f(arrived, torch.bool),
        f(feas, torch.bool), f(plan_ok, torch.bool), f(dest_x), f(dest_y), TC,
    )


def test_k3_plain_matches_jax_tick_loop():
    inp = _tick_inputs()
    sc, target, tspeed, tq, plan_ok, arrived, feas, dest_x, dest_y, pid = inp
    lights = TrafficLights.none()
    out_j = jax.jit(jax.vmap(
        lambda e, b, c, l, o, ts, tgt, ar, fe, ok, dx, dy: j_cl._full_ticks_base(
            e, b, c, l, o, ts, jnp.asarray(tq), tgt, ar, fe, ok, dx, dy,
            lights, jnp.float32(0.0), JC)))(
        sc.ego0, *pid, sc.obstacles, tspeed, target, arrived, feas, plan_ok,
        dest_x, dest_y)
    before = t_cl.launches["tick_lqr"]
    out_t = t_cl.run_ticks(*_tick_args_torch(inp))
    assert t_cl.launches["tick_lqr"] == before  # CPU tensors: plain loop
    mt = t_cl.TickMetrics(*out_t[6], None)
    assert_metrics_match(mt, out_j[6], TICK_FIELDS, "ticks.")
    m = out_j[6]
    assert bool(np.asarray(m.arrived)[3].any()) and not bool(np.asarray(m.feasible)[1].any())
    for a, b in zip(out_t[0], out_j[0]):
        np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=1e-5, atol=5e-3)
    np.testing.assert_array_equal(np_of(out_t[2]), np.asarray(out_j[2]))
    np.testing.assert_allclose(np_of(out_t[1]), np.asarray(out_j[1]), atol=5e-3)
    np.testing.assert_array_equal(np_of(out_t[5]), np.asarray(out_j[5]))


@pytest.fixture(scope="module")
def jax_run():
    sc = _scenarios(0)
    run = jax.jit(jax.vmap(lambda g, e, o: j_cl.simulate(g, e, o, JC)))
    carry, metrics = run(sc.global_path, sc.ego0, sc.obstacles)
    return sc, carry, metrics


def test_simulate_matches_jax(jax_run):
    sc, _, mj = jax_run
    _, mt = t_cl.simulate(
        convert.path_from_numpy(sc.global_path), convert.ego_from_numpy(sc.ego0),
        convert.obstacles_from_numpy(sc.obstacles), TC, device="cpu")
    assert_metrics_match(mt, mj, j_cl.TickMetrics._fields, "simulate.")
    sj = {k: float(v) for k, v in j_cl.summarize(mj).items()}
    st = {k: float(v) for k, v in t_cl.summarize(mt).items()}
    assert sj.keys() == st.keys()
    for k in sj:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-4, atol=5e-3, err_msg=k)


def test_one_more_cycle_from_jax_carry(jax_run):
    """Mid-run: carry the JAX LoopCarry across and run one more cycle on
    both sides."""
    sc, carry, _ = jax_run
    cfg1 = dataclasses.replace(JC, loop=dataclasses.replace(JC.loop, n_plans=1))

    def more(g, c):
        dest = (g.x[-1], g.y[-1])
        v = jnp.float32(JC.loop.target_speed_kmh) / 3.6
        nd = JC.speed.n_dense
        tq = jnp.arange(nd, dtype=jnp.float32) * (JC.speed.n_t * JC.speed.t_step / (nd - 1))
        res = j_em.plan_path_cycle(g, c.ego, c.obstacles, c.match_index, cfg1,
                                   qp_warm=c.qp_warm[0])
        cs = c.ctrl.rebind()
        plan_ok = j_cl._all_finite(res.target)
        out = j_cl._full_ticks_base(
            c.ego, cs.pid.buffer, cs.pid.count, cs.pid.last_error, c.obstacles,
            jnp.full((nd,), v), tq, j_cl._sanitize(res.target), c.arrived,
            res.feasible, plan_ok, dest[0], dest[1], TrafficLights.none(),
            jnp.float32(0.0), cfg1)
        return out[6]._replace(segments_dropped=jnp.broadcast_to(
            res.obs_dropped, out[6].x.shape))

    mj = jax.jit(jax.vmap(more))(sc.global_path, carry)
    gp = convert.path_from_numpy(sc.global_path)
    tcarry = convert.carry_from_numpy(carry)
    v, tq = t_cl._constant_profile(TC)
    _, mt = t_cl.plan_cycle(
        gp, tcarry, TC, torch.full((B, tq.shape[0]), float(v)), torch.as_tensor(tq),
        gp.x[:, -1].contiguous(), gp.y[:, -1].contiguous())
    assert_metrics_match(mt, mj, j_cl.TickMetrics._fields, "cycle3.")


def test_lights_now_run():
    """Traffic lights are ported: a red stop line 8 m ahead brakes the ego
    in both loops (the cap (8 - 4) / 1.2 m/s is below its 8 m/s), where
    the lights-free run keeps its speed."""
    sc = t_sc.batch_scenarios(0, 2, TC, device="cpu", n_path=96)
    # the ego starts at station 0; a light with green_frac 0 is always red
    lights = t_sc.lights_on_path(sc.global_path, [8.0], period=100.0,
                                 green_frac=0.0, device="cpu")
    for sim in (t_cl.simulate, t_cl.simulate_full):
        _, free = sim(*sc, TC, device="cpu")
        _, held = sim(*sc, TC, lights=lights, device="cpu")
        assert bool(torch.isfinite(held.x).all())
        assert float(held.speed_kmh[:, -1, -1].max()) < float(free.speed_kmh[:, -1, -1].min())
