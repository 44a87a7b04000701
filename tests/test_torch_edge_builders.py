"""``chip_smoke.py``'s edge-phase scenarios, built from NumPy without JAX,
against the JAX package's tests' own builders (or, where a JAX test builds
its scenario inline, that test's code): the same arrays, bit for bit; the
random road of ``tests/test_closed_loop.py:73`` from the same unit draws,
at the scenario test's bar (its cumulative sums run in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
import test_fidelity as j_fid
import test_feasibility as j_feas
from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.sim import scenario as j_sc
from emplanner_carla_tpu.sim import traffic_light as j_tl
from emplanner_carla_tpu.types import EgoState, Obstacles, Path
from emplanner_carla_tpu_torch import convert
from test_torch_scenario import _jax_unit_draws
from torch_port_helpers import np_of

JC = JCfg()
TC = convert.config_from_dict(dataclasses.asdict(JC))


def _straight(n):
    s = jnp.arange(n) * 2.0
    return Path(s, jnp.zeros(n), jnp.zeros(n), jnp.zeros(n))


def _ego(gp, v0):
    z = jnp.zeros(())
    return EgoState(gp.x[0], gp.y[0], gp.theta[0], jnp.asarray(v0, jnp.float32),
                    z, z, z, z, z)


def _jax_inline(name, cfg):
    """The scenarios that the JAX tests build inline, by their code."""
    K = cfg.n_static_obs + cfg.n_dynamic_obs
    d0 = cfg.n_static_obs
    if name == "red_light_stop":                     # tests/test_fidelity.py:728-744
        gp = _straight(200)
        obstacles = Obstacles(*(jnp.zeros(K),) * 4, jnp.zeros(K, bool))
        lights = j_tl.TrafficLights(
            jnp.asarray([40.0, 0.0]), jnp.asarray([0.0, 0.0]),
            jnp.asarray([10.0, 1.0]), jnp.asarray([5.0, 0.0]),
            jnp.asarray([0.5, 1.0]), jnp.asarray([True, False]))
        return j_sc.Scenario(gp, _ego(gp, 10.0), obstacles), {"lights": lights}
    if name == "walker_yield":                       # :784-795
        gp = _straight(200)
        ox = jnp.zeros(K).at[d0].set(18.0)
        oy = jnp.zeros(K).at[d0].set(-3.4)
        ovy = jnp.zeros(K).at[d0].set(1.4)
        valid = jnp.zeros(K, bool).at[d0].set(True)
        return j_sc.Scenario(gp, _ego(gp, 10.0),
                             Obstacles(ox, oy, jnp.zeros(K), ovy, valid)), {}
    if name == "npc_lane_change":                    # :839-852
        gp = _straight(200)
        ox = jnp.zeros(K).at[0].set(60.0).at[d0].set(20.0)
        ovx = jnp.zeros(K).at[d0].set(8.0)
        valid = jnp.zeros(K, bool).at[0].set(True).at[d0].set(True)
        return j_sc.Scenario(gp, _ego(gp, 5.0),
                             Obstacles(ox, jnp.zeros(K), ovx, jnp.zeros(K), valid)), {}
    if name == "stopped_behind_lead":                # tests/test_closed_loop.py:106-115
        gp = Path(jnp.arange(64) * 2.0, jnp.zeros(64), jnp.zeros(64), jnp.zeros(64))
        z = jnp.zeros(())
        ego = EgoState(jnp.float32(25.0), z, z, z, z, z, z, z, z)
        obs = Obstacles(jnp.zeros(K).at[0].set(30.0), jnp.zeros(K), jnp.zeros(K),
                        jnp.zeros(K), jnp.zeros(K, bool).at[0].set(True))
        return j_sc.Scenario(gp, ego, obs), {}
    if name == "yield_infeasible":
        return j_fid._yield_infeasible_scenario(cfg), {}
    raise KeyError(name)


def _assert_same(port, ref, label):
    """A one-lane port tree against a JAX tree, array for array, bit for bit
    (NaN at the same places)."""
    a = [np_of(t)[0] for t in jax.tree.leaves(port)]
    b = [np.asarray(t) for t in jax.tree.leaves(ref)]
    assert len(a) == len(b), label
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape and x.dtype == y.dtype, f"{label}: leaf {i}"
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), f"{label}: leaf {i}"


@pytest.mark.parametrize("nan_slots", [False, True])
@pytest.mark.parametrize("n", [160, 256])
def test_wall_builder_equals_test_feasibility(nan_slots, n):
    """The wall of tests/test_feasibility.py:26 (160 nodes there; the
    planted lanes' 256-node road takes the same layout), and with the NaN
    slots of :106."""
    ref = j_feas._wall_scenario(j_feas.CFG)
    if n != 160:
        gp = _straight(n)
        ref = j_sc.Scenario(gp, _ego(gp, 8.0), ref.obstacles)
    if nan_slots:
        ref = ref._replace(obstacles=ref.obstacles._replace(
            x=ref.obstacles.x.at[0].set(jnp.nan), y=ref.obstacles.y.at[1].set(jnp.nan)))
    _assert_same(chip_smoke.wall_scenario(TC, n, nan_slots), ref, "wall")


def test_planted_batch_holds_the_wall_and_the_nan_ego():
    """``plant_lanes`` on a 4096-lane batch: the wall lanes are the wall on
    the batch's road length, the NaN-speed lanes their own scenario with vx
    NaN, every other lane untouched."""
    import torch

    from emplanner_carla_tpu_torch.sim import scenario as t_sc
    from emplanner_carla_tpu_torch.types import tree_leaves

    sc = t_sc.batch_scenarios(1, chip_smoke.BATCH, TC, device="cpu")
    planted = chip_smoke.plant_lanes(sc, TC)
    kinds = set(chip_smoke.PLANTED.values())
    assert kinds == {"nan_vx", "wall", "nan_wall"}
    assert {1, 33, 4095} <= set(chip_smoke.PLANTED)
    for lane, kind in chip_smoke.PLANTED.items():
        if kind == "nan_vx":
            assert bool(torch.isnan(planted.ego0.vx[lane]))
            continue
        w = chip_smoke.wall_scenario(TC, sc.global_path.x.shape[1], kind == "nan_wall")
        for a, b in zip(tree_leaves(planted), tree_leaves(w)):
            assert torch.equal(torch.nan_to_num(a[lane]), torch.nan_to_num(b[0]))
    healthy = torch.ones(chip_smoke.BATCH, dtype=torch.bool)
    healthy[sorted(chip_smoke.PLANTED)] = False
    for a, b in zip(tree_leaves(planted), tree_leaves(sc)):
        assert torch.equal(a[healthy], b[healthy])
    vx = planted.ego0.vx.clone()
    vx[[k for k, v in chip_smoke.PLANTED.items() if v == "nan_vx"]] = 0.0
    assert bool(torch.isfinite(vx).all())


@pytest.mark.parametrize("name", ["red_light_stop", "walker_yield", "npc_lane_change",
                                  "stopped_behind_lead", "yield_infeasible"])
def test_edge_builder_equals_the_jax_tests(name):
    sc, extra = chip_smoke.edge_scenario(name, TC)
    ref, ref_extra = _jax_inline(name, JC)
    _assert_same(sc, ref, name)
    assert extra.keys() == ref_extra.keys()
    for k in extra:
        _assert_same(extra[k], ref_extra[k], f"{name}.{k}")


def test_emergency_brake_builder_equals_make_scenario():
    """tests/test_closed_loop.py:73's scenario, make_scenario(PRNGKey(5),
    n_path=100, no obstacles): chip_smoke.py's unit draws are JAX's, float
    for float, and the road built from them agrees with JAX's at the
    scenario test's bar (tests/test_torch_scenario.py)."""
    draws = _jax_unit_draws(jax.random.PRNGKey(5), JC)
    for a, b in zip(chip_smoke.EMERGENCY_DRAWS, draws):
        assert np.array_equal(np.asarray(a, np.float32), np.atleast_1d(np.asarray(b)))
    cfg = JCfg(loop=dataclasses.replace(JC.loop, n_plans=30))
    ref = j_sc.make_scenario(jax.random.PRNGKey(5), cfg, n_path=100, n_active_static=0,
                             with_dynamic=False)
    sc, _ = chip_smoke.edge_scenario("emergency_brake", TC)
    for i, (a, b) in enumerate(zip(jax.tree.leaves(sc), jax.tree.leaves(ref))):
        a, b = np_of(a)[0], np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if b.dtype == np.bool_:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-3, err_msg=str(i))
