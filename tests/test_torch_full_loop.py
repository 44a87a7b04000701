"""PyTorch port, the full EM loop and traffic lights: the port's
``plan_full_cycle`` and ``simulate_full`` against ``jax.vmap`` of the JAX
functions, the plain tick loop with lights (the K3-L kernel's plain
version) against ``jax.vmap(_full_ticks_base)``, and both loops with
lights, on the same JAX-made inputs.

Two batches: (a) the bench mix, JAX ``batch_scenarios``; (b) the
three-crosser scenario tiled to four lanes with the crossers' speeds varied
per lane, whose ST graph holds three valid segments at cycle 0 (the bench
mix's walker spawns beyond the 50 m perception range, so a 0.4 s run sees no
segment there). Bar (``__graft_entry__._assert_metrics_match``): decisions
identical, floats within rtol 1e-5 / atol 5 mm.
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
from emplanner_carla_tpu.sim.traffic_light import TrafficLights as JLights
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.ops import frenet
from emplanner_carla_tpu_torch.planner import em_planner
from emplanner_carla_tpu_torch.planner import speed_planner as t_sp
from emplanner_carla_tpu_torch.sim import closed_loop as t_cl
from emplanner_carla_tpu_torch.sim import scenario as t_sc
from test_torch_loop import _tick_args_torch, _tick_inputs
from test_torch_speed import crosser_batch
from torch_port_helpers import assert_metrics_match, np_of, t32

JC = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=2, plan_every=20))
TC = convert.config_from_dict(dataclasses.asdict(JC))
TICK_FIELDS = j_cl.TickMetrics._fields[:8]
LIGHT_S = (11.0, 41.0)      # stations ahead of the start: the cap binds at 11 m
# (between path nodes, so both packages bracket each station alike)
# per-lane phase offsets of a 12 s cycle, green on its first 6 s: lanes see
# red, green, and a switch inside the cycles
OFFSETS = np.asarray([0.0, 3.9, 5.0, 6.5, 8.0, 11.95, 2.0, 9.0], np.float32)


def _bench_mix(batch=8):
    return j_sc.batch_scenarios(jax.random.PRNGKey(0), batch, JC, n_path=96)


def _batch(name):
    if name == "bench_mix":
        return _bench_mix()
    return crosser_batch(4)


def _port(sc):
    return (convert.path_from_numpy(sc.global_path), convert.ego_from_numpy(sc.ego0),
            convert.obstacles_from_numpy(sc.obstacles))


def _jax_lights(gp, batch):
    return jax.vmap(lambda g, off: j_sc.lights_on_path(
        g, LIGHT_S, period=12.0, green_frac=0.5, offsets=off))(
        gp, jnp.stack([OFFSETS[:batch]] * len(LIGHT_S), 1))


def test_lights_on_path_matches_jax():
    sc = _bench_mix()
    ref = _jax_lights(sc.global_path, 8)
    out = t_sc.lights_on_path(convert.path_from_numpy(sc.global_path), LIGHT_S,
                              period=12.0, green_frac=0.5,
                              offsets=np.stack([OFFSETS] * len(LIGHT_S), 1),
                              device="cpu")
    for name, a, b in zip(JLights._fields, out, ref):
        np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=1e-5, atol=5e-3,
                                   err_msg=name)
    lt = convert.lights_from_numpy(jax.tree.map(np.asarray, ref))
    for a, b in zip(lt, out):
        assert a.dtype == b.dtype and a.shape == b.shape


def test_k3l_plain_matches_jax_tick_loop():
    """The red-light branch of the tick loop, plain version, against the
    JAX tick loop with the same lights: some lanes red, some green, some
    switching, at an absolute cycle start of 2 s."""
    inp = _tick_inputs()
    sc, target, tspeed, tq, plan_ok, arrived, feas, dest_x, dest_y, pid = inp
    B = tspeed.shape[0]
    lights = _jax_lights(sc.global_path, B)
    t0 = np.full(B, 2.0, np.float32)
    out_j = jax.jit(jax.vmap(
        lambda e, b, c, l, o, ts, tgt, ar, fe, ok, dx, dy, tl, t: j_cl._full_ticks_base(
            e, b, c, l, o, ts, jnp.asarray(tq), tgt, ar, fe, ok, dx, dy, tl, t, JC)))(
        sc.ego0, *pid, sc.obstacles, tspeed, target, arrived, feas, plan_ok,
        dest_x, dest_y, lights, t0)
    args = _tick_args_torch(inp)
    before = t_cl.launches["tick_lqr"]
    out_t = t_cl.run_ticks(*args, lights=convert.lights_from_numpy(lights),
                           t0=t32(t0))
    assert t_cl.launches["tick_lqr"] == before  # CPU tensors: plain loop
    assert_metrics_match(t_cl.TickMetrics(*out_t[6], None), out_j[6], TICK_FIELDS,
                         "ticks.")
    for a, b in zip(out_t[0], out_j[0]):
        np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=1e-5, atol=5e-3)
    np.testing.assert_array_equal(np_of(out_t[2]), np.asarray(out_j[2]))
    np.testing.assert_array_equal(np_of(out_t[5]), np.asarray(out_j[5]))
    # the cap acted: a red lane ends slower than without lights
    free = t_cl.run_ticks(*args)
    slower = np_of(out_t[6][2][:, -1]) < np_of(free[6][2][:, -1]) - 1.0
    assert slower.any() and not slower.all()



@pytest.mark.parametrize("standoff,headway", [(2.5, 0.8), (6.0, 2.0)])
def test_red_light_cap_standoff_headway_matches_jax(standoff, headway):
    """``red_light_cap(..., standoff=, headway=)`` at non-default values,
    on red, green and switching lanes, moving and at rest (the heading
    fallback of the stop corridor)."""
    from emplanner_carla_tpu.sim import traffic_light as j_tl
    from emplanner_carla_tpu_torch.sim import traffic_light as t_tl

    sc = _bench_mix()
    lights = _jax_lights(sc.global_path, 8)
    ego = sc.ego0._replace(vx=sc.ego0.vx.at[::3].set(0.0))
    t = np.linspace(0.0, 11.0, 8).astype(np.float32)
    want = jax.vmap(lambda e, tl, ti: j_tl.red_light_cap(e, tl, ti, standoff, headway))(
        ego, lights, t)
    got = t_tl.red_light_cap(convert.ego_from_numpy(ego),
                             convert.lights_from_numpy(lights), t32(t),
                             standoff=standoff, headway=headway)
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    default = t_tl.red_light_cap(convert.ego_from_numpy(ego),
                                 convert.lights_from_numpy(lights), t32(t))
    finite = np.isfinite(np_of(got))
    assert finite.any() and (~finite).any()          # some red ahead, some not
    assert not np.array_equal(np_of(got)[finite], np_of(default)[finite])


@pytest.fixture(scope="module")
def full_cycles():
    """One JAX full EM cycle from the zero warm state on each batch."""
    out = {}
    for name in ("bench_mix", "crossers"):
        sc = _batch(name)
        mi = jax.vmap(lambda e, g: j_cl.frenet.nearest_index(e.x, e.y, g))(
            sc.ego0, sc.global_path)
        res = jax.jit(jax.vmap(lambda g, e, o, m: j_em.plan_full_cycle(
            g, e, o, m, JC, qp_warm=j_em.warm_init(JC, full=True))))(
            sc.global_path, sc.ego0, sc.obstacles, mi)
        out[name] = (sc, jax.tree.map(np.asarray, res))
    return out


@pytest.mark.parametrize("name", ["bench_mix", "crossers"])
def test_plan_full_cycle_matches_jax(full_cycles, name):
    sc, ref = full_cycles[name]
    gp, ego, obs = _port(sc)
    B = ego.x.shape[0]
    mi = frenet.nearest_index(ego.x, ego.y, gp)
    res = em_planner.plan_full_cycle(gp, ego, obs, mi, TC,
                                     qp_warm=em_planner.warm_init(TC, B, "cpu", full=True))
    np.testing.assert_array_equal(np_of(res.path.feasible), ref.path.feasible)
    np.testing.assert_array_equal(np_of(res.segments_dropped), ref.segments_dropped)
    for f in ("x", "y", "theta", "kappa"):
        np.testing.assert_allclose(np_of(getattr(res.path.target, f)),
                                   getattr(ref.path.target, f), rtol=1e-5, atol=5e-3,
                                   err_msg=f"target.{f}")
    for f in ("speed", "accel", "time", "x", "y"):
        np.testing.assert_allclose(np_of(getattr(res.trajectory, f)),
                                   getattr(ref.trajectory, f), rtol=1e-5, atol=5e-3,
                                   err_msg=f"trajectory.{f}")
    np.testing.assert_array_equal(np_of(res.trajectory.valid), ref.trajectory.valid)
    # the carried speed-QP state (x_s, z) of the whole cycle: the loop's bar
    for a, b in zip(res.speed_qp_state[:2], ref.speed_qp_state[:2]):
        np.testing.assert_allclose(np_of(a), b, rtol=1e-5, atol=5e-3)
    if name == "crossers":
        # three valid segments, st_top_m 2 keeps two: one drop a lane
        assert (np.asarray(ref.segments_dropped) > 0).all()
        assert TC.speed.st_top_m == 2


@pytest.fixture(scope="module")
def jax_full_runs():
    run = jax.jit(jax.vmap(lambda g, e, o: j_cl.simulate_full(g, e, o, JC)))
    out = {}
    for name in ("bench_mix", "crossers"):
        sc = _batch(name)
        carry, metrics = run(sc.global_path, sc.ego0, sc.obstacles)
        out[name] = (sc, carry, metrics)
    return out


@pytest.mark.parametrize("name", ["bench_mix", "crossers"])
def test_simulate_full_matches_jax(jax_full_runs, name):
    sc, carry_j, mj = jax_full_runs[name]
    carry_t, mt = t_cl.simulate_full(*_port(sc), TC, device="cpu")
    assert_metrics_match(mt, mj, j_cl.TickMetrics._fields, "simulate_full.")
    sj = {k: float(v) for k, v in j_cl.summarize(mj).items()}
    st = {k: float(v) for k, v in t_cl.summarize(mt).items()}
    for k in sj:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-4, atol=5e-3, err_msg=k)
    for a, b in zip(carry_t.qp_warm[1][:2], carry_j.qp_warm[1][:2]):
        np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=1e-5, atol=5e-3)
    if name == "crossers":
        assert st["segments_dropped"] > 0


def test_record_cycle_states_matches_jax(jax_full_runs):
    sc, _, _ = jax_full_runs["crossers"]
    _, _, egos_j = jax.jit(jax.vmap(lambda g, e, o: j_cl.simulate_full(
        g, e, o, JC, record_cycle_states=True)))(sc.global_path, sc.ego0, sc.obstacles)
    _, _, egos_t = t_cl.simulate_full(*_port(sc), TC, record_cycle_states=True,
                                      device="cpu")
    for f in egos_t._fields:
        np.testing.assert_allclose(np_of(getattr(egos_t, f)),
                                   np.asarray(getattr(egos_j, f)), rtol=1e-5,
                                   atol=5e-3, err_msg=f)


@pytest.mark.parametrize("name", ["bench_mix", "crossers"])
def test_one_more_full_cycle_from_jax_carry(jax_full_runs, name):
    """Mid-run: carry the JAX LoopCarry (both QP warm states) across and run
    the third cycle on both sides."""
    sc, carry, _ = jax_full_runs[name]

    def more(g, c):
        res = j_em.plan_full_cycle(g, c.ego, c.obstacles, c.match_index, JC,
                                   qp_warm=c.qp_warm)
        plan_ok = j_cl._all_finite(res.path.target) & j_cl._all_finite(
            (res.trajectory.speed, res.trajectory.time))
        cs = c.ctrl.rebind()
        out = j_cl._full_ticks_base(
            c.ego, cs.pid.buffer, cs.pid.count, cs.pid.last_error, c.obstacles,
            jnp.nan_to_num(res.trajectory.speed), jnp.nan_to_num(res.trajectory.time),
            j_cl._sanitize(res.path.target), c.arrived, res.path.feasible, plan_ok,
            g.x[-1], g.y[-1], JLights.none(), jnp.float32(0.4), JC)
        return out[6]._replace(segments_dropped=jnp.broadcast_to(
            res.segments_dropped, out[6].x.shape))

    mj = jax.jit(jax.vmap(more))(sc.global_path, carry)
    tcarry = convert.carry_from_numpy(jax.tree.map(np.asarray, carry))
    assert tcarry.qp_warm[1] is not None
    gp = convert.path_from_numpy(sc.global_path)
    _, mt = t_cl.full_plan_cycle(gp, tcarry, TC, gp.x[:, -1].contiguous(),
                                 gp.y[:, -1].contiguous())
    assert_metrics_match(mt, mj, j_cl.TickMetrics._fields, "cycle3.")


@pytest.mark.parametrize("loop", ["simulate", "simulate_full"])
def test_loops_with_lights_match_jax(loop):
    sc = _bench_mix()
    lights = _jax_lights(sc.global_path, 8)
    j_fn = getattr(j_cl, loop)
    mj = jax.jit(jax.vmap(lambda g, e, o, tl: j_fn(g, e, o, JC, tl)[1]))(
        sc.global_path, sc.ego0, sc.obstacles, lights)
    port_fn = getattr(t_cl, loop)
    _, mt = port_fn(*_port(sc), TC, lights=convert.lights_from_numpy(lights),
                    device="cpu")
    assert_metrics_match(mt, mj, j_cl.TickMetrics._fields, f"{loop}+lights.")
    # the lights acted: the lanes that met red end slower than without lights
    _, free = port_fn(*_port(sc), TC, device="cpu")
    slower = np_of(mt.speed_kmh[:, -1, -1]) < np_of(free.speed_kmh[:, -1, -1]) - 1.0
    assert slower.any() and not slower.all()


def test_speed_qp_site_counts_apart_from_path_qp():
    """The speed QP runs the K1 kernel under its own launch counter, and a
    full cycle on the CPU launches no kernel."""
    solver = t_sp._speed_solver(TC.speed)
    assert solver.name == "qp_admm_speed" and (solver.n, solver.m) == (51, 99)
    sc = t_sc.batch_scenarios(0, 2, TC, device="cpu", n_path=96)
    before = dict(t_sp.qp.launches), t_sp.launches["speed_dp"]
    t_cl.simulate_full(*sc, TC, device="cpu")
    assert (dict(t_sp.qp.launches), t_sp.launches["speed_dp"]) == before
