"""PyTorch port, fault containment: the four cases of
``tests/test_feasibility.py`` (the wall :55, a feasible scenario :76, NaN
obstacle slots :106, a NaN ego speed in one lane of four :140) through the
port's ``simulate`` on the CPU, on the JAX test's own arrays, with the JAX
test's assertions (``chip_smoke.assert_planted``, which the card's edge
phase applies too) and against ``jax.vmap(closed_loop.simulate)``: the
healthy lanes' decisions identical and their floats within rtol 1e-5 /
atol 5 mm (the loop's bar, ``torch_port_helpers.assert_metrics_match``);
the NaN lane held by ``feasible`` and the JAX test's assertions (the
port's PID skips its window at ki = kd = 0, so a NaN lane's floats need
not be JAX's)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_feasibility as j_feas
from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.sim import closed_loop as j_cl
from emplanner_carla_tpu.sim import scenario as j_sc
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.sim import closed_loop as t_cl
from torch_port_helpers import assert_metrics_match, np_of

TC = convert.config_from_dict(dataclasses.asdict(j_feas.CFG))
FIELDS = t_cl.TickMetrics._fields


def _port(sc, cfg=TC, batched=False):
    """The port's ``simulate`` on a JAX scenario (one lane, or a batch)."""
    b = sc if batched else jax.tree.map(lambda a: np.asarray(a)[None], sc)
    return t_cl.simulate(convert.path_from_numpy(b.global_path), convert.ego_from_numpy(b.ego0),
                         convert.obstacles_from_numpy(b.obstacles), cfg, device="cpu")


def _jax_one(sc, cfg=j_feas.CFG):
    """``closed_loop.simulate`` on one JAX scenario, with a batch axis of 1."""
    carry, m = j_cl.simulate(sc.global_path, sc.ego0, sc.obstacles, cfg)
    return jax.tree.map(lambda a: np.asarray(a)[None], (carry, m))


def test_port_wall_is_infeasible_and_stops_short():
    """tests/test_feasibility.py:55: the flag surfaces, is constant within
    a cycle, and the ACC guard stops the ego short of the wall."""
    sc = j_feas._wall_scenario(j_feas.CFG)
    carry, m = _port(sc)
    chip_smoke.assert_planted("wall", "simulate", carry, m, 0, TC)
    assert tuple(m.feasible.shape[1:]) == (TC.loop.n_plans, TC.loop.plan_every)
    assert float(t_cl.summarize(m)["infeasible_frac"]) > 0.0
    _, mj = _jax_one(sc)
    assert_metrics_match(m, mj, FIELDS, "wall.")


def test_port_feasible_scenario_reports_feasible():
    """tests/test_feasibility.py:76: a benign scenario is feasible in every
    cycle."""
    jcfg = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=4))
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    sc = j_sc.make_scenario(jax.random.PRNGKey(0), jcfg)
    _, m = _port(sc, tcfg)
    assert bool(m.feasible.all())
    assert float(t_cl.summarize(m)["infeasible_frac"]) == 0.0
    _, mj = _jax_one(sc, jcfg)
    assert_metrics_match(m, mj, FIELDS, "feasible.")


def test_port_nan_obstacles_are_contained():
    """tests/test_feasibility.py:106: NaN x in slot 0 and NaN y in slot 1
    of the wall: perception gates them like invalid slots, every metric and
    the carried ego stay finite, the ego passes through the gap past x = 40
    and clears the surviving slots by more than the collision radius."""
    sc = j_feas._wall_scenario(j_feas.CFG)
    bad = sc._replace(obstacles=sc.obstacles._replace(
        x=sc.obstacles.x.at[0].set(jnp.nan), y=sc.obstacles.y.at[1].set(jnp.nan)))
    carry, m = _port(bad)
    chip_smoke.assert_planted("nan_wall", "simulate", carry, m, 0, TC)
    for leaf in carry.ego:
        assert bool(np.isfinite(np_of(leaf)).all())
    _, mj = _jax_one(bad)
    assert_metrics_match(m, mj, FIELDS, "nan obstacles.")


def test_port_nan_ego_stays_contained_in_its_lane():
    """tests/test_feasibility.py:140: a NaN speed in lane 1 of four leaves
    lanes 0, 2 and 3 finite and as JAX runs them, and its own plans are
    infeasible in every cycle, as in JAX; feasible, collided and arrived
    identical in every lane."""
    scs = j_sc.batch_scenarios(jax.random.PRNGKey(5), 4, j_feas.CFG)
    scs = scs._replace(ego0=scs.ego0._replace(vx=scs.ego0.vx.at[1].set(jnp.nan)))
    carry, m = _port(jax.tree.map(np.asarray, scs), batched=True)
    _, mj = jax.vmap(lambda g, e, o: j_cl.simulate(g, e, o, j_feas.CFG))(
        scs.global_path, scs.ego0, scs.obstacles)
    chip_smoke.assert_planted("nan_vx", "simulate", carry, m, 1, TC)
    assert not np.asarray(mj.feasible)[1].any()
    healthy = [0, 2, 3]
    lat = np_of(m.lateral_err)
    assert np.isfinite(lat[healthy]).all()
    assert_metrics_match(t_cl.TickMetrics(*[a[healthy] for a in m]),
                         jax.tree.map(lambda a: np.asarray(a)[healthy], mj), FIELDS,
                         "healthy lanes.")
    for name in ("feasible", "collided", "arrived"):
        np.testing.assert_array_equal(np_of(getattr(m, name)), np.asarray(getattr(mj, name)),
                                      err_msg=name)


def test_port_full_em_wall_and_nan_obstacles_match_jax():
    """The wall and the NaN-obstacle wall through the full EM loop (the
    card's edge phase plants both into config 5 and 7), against
    ``jax.vmap(closed_loop.simulate_full)``: decisions identical, floats at
    the loop's bar, the card's assertions (``chip_smoke.assert_planted``)
    met. Through the gap the full EM loop ends 8 plans short of x = 40 in
    both packages (x = 39.31), which is why the card holds the full-EM
    loops' NaN-obstacle lanes to passing the wall."""
    sc = j_feas._wall_scenario(j_feas.CFG)
    bad = sc._replace(obstacles=sc.obstacles._replace(
        x=sc.obstacles.x.at[0].set(jnp.nan), y=sc.obstacles.y.at[1].set(jnp.nan)))
    both = jax.tree.map(lambda a, b: np.stack([np.asarray(a), np.asarray(b)]), sc, bad)
    carry, m = t_cl.simulate_full(convert.path_from_numpy(both.global_path),
                                  convert.ego_from_numpy(both.ego0),
                                  convert.obstacles_from_numpy(both.obstacles), TC,
                                  device="cpu")
    _, mj = jax.vmap(lambda g, e, o: j_cl.simulate_full(g, e, o, j_feas.CFG))(
        both.global_path, both.ego0, both.obstacles)
    assert_metrics_match(m, mj, FIELDS, "full EM.")
    chip_smoke.assert_planted("wall", "simulate_full", carry, m, 0, TC)
    chip_smoke.assert_planted("nan_wall", "simulate_full", carry, m, 1, TC)
    assert 26.5 < float(np.asarray(mj.x)[1, -1, -1]) < 40.0


@pytest.mark.parametrize("entry", ["simulate", "simulate_full", "simulate_traffic"])
def test_tick_loops_get_a_finite_plan_on_poisoned_lanes(entry, monkeypatch):
    """The tick kernel requires a finite plan (target path, speed profile and
    its times) and does not check it: every entry point sanitises the plan
    it hands the tick loop, also where the planner's own output is not
    finite. A NaN and an infinite ego speed and the wall with NaN obstacle
    slots, three cycles of each entry point: every tick loop call gets a
    finite plan, and the NaN lane's plan is not ok in some cycle (the
    sanitised plan is one the planner did not make)."""
    cfg = dataclasses.replace(TC, loop=dataclasses.replace(TC.loop, n_plans=3))
    w = chip_smoke.wall_scenario(cfg, nan_slots=True)
    sc = type(w)(*(type(p)(*(torch.cat([t] * 3) for t in p)) for p in w))
    sc.ego0.vx[0], sc.ego0.vx[1] = float("nan"), float("inf")
    seen = []

    def checked(fn):
        def run(*args, **kw):
            tspeed, ttime, target, plan_ok = args[5], args[6], args[7], args[10]
            for name, t in [("tspeed", tspeed), ("ttime", ttime)] + list(
                    zip(target._fields, target)):
                assert bool(torch.isfinite(t).all()), f"{entry}: non-finite {name}"
            seen.append(bool(plan_ok[0]))
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(t_cl, "run_ticks", checked(t_cl.run_ticks))
    monkeypatch.setattr(t_cl, "run_traffic_ticks", checked(t_cl.run_traffic_ticks))
    if entry == "simulate_traffic":
        t_cl.simulate_traffic(*sc, cfg, behavior="normal", full=True, device="cpu")
    else:
        getattr(t_cl, entry)(*sc, cfg, device="cpu")
    assert len(seen) == cfg.loop.n_plans and not all(seen), seen
