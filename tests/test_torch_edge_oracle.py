"""PyTorch port against the float64 NumPy oracle on the reference's edge
scenarios (``tests/test_fidelity.py``), part 1: the full EM loop behind a
slower lead NPC (:114), three simultaneous crossers at the default st_top_m
with its dropped segments surfaced (:227), the path DP's obstacle
compression surfacing its drops (:681) and an agent NPC's lane change
(:828), each with the JAX test's assertions on the port's CPU run and its
bars: lateral RMSE <= 5 cm against the oracle, the drop counts, no
collision. Where the test's bar is a count and not the oracle (:227,
:681), the JAX function runs on the same arrays: the drop counts equal
its own and the metrics meet the loop's bar
(``torch_port_helpers.assert_metrics_match``). The oracle runs in a child process with one BLAS thread
(``torch_port_helpers.run_single_threaded``). Part 2 is
``test_torch_edge_oracle_stops.py``, so that the oracle's runs share two
workers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.oracle import closed_loop_np
from emplanner_carla_tpu.sim import closed_loop as j_cl
from emplanner_carla_tpu.sim import scenario as j_sc
from emplanner_carla_tpu.types import EgoState, Obstacles, Path
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.sim import closed_loop as t_cl
from test_fidelity import N_PLANS, _three_crosser_scenario, lateral_rmse, unpack_scenario
from torch_port_helpers import assert_metrics_match, run_single_threaded


def _cfgs(n_plans):
    jcfg = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=n_plans))
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


def port_scenario(sc):
    """A one-lane JAX scenario as the port's (global path, ego, obstacles)."""
    b = jax.tree.map(lambda a: np.asarray(a)[None], sc)
    return (convert.path_from_numpy(b.global_path), convert.ego_from_numpy(b.ego0),
            convert.obstacles_from_numpy(b.obstacles))


def xy(m):
    return m.x.numpy().reshape(-1), m.y.numpy().reshape(-1)


def test_port_full_em_lead_npc_matches_oracle():
    """tests/test_fidelity.py:114: the full EM loop on the standard
    scenario with a slower lead NPC."""
    jcfg, tcfg = _cfgs(N_PLANS)
    sc = j_sc.make_scenario(jax.random.PRNGKey(0), jcfg, with_dynamic=True,
                            n_active_static=2, v0=10.0)
    _, m = t_cl.simulate_full(*port_scenario(sc), tcfg, device="cpu")
    g, ego0, statics, dynamics = unpack_scenario(sc)
    assert len(dynamics) == 1
    ox, oy = run_single_threaded(closed_loop_np.simulate_full, g, ego0, statics, dynamics,
                                 jcfg, N_PLANS)
    px, py = xy(m)
    assert len(ox) == len(px)
    rmse = lateral_rmse(px, py, ox, oy)
    assert rmse <= 0.05, f"port full-EM lateral RMSE vs oracle {rmse:.3f} m"


def test_port_three_crossers_surface_dropped_segments():
    """tests/test_fidelity.py:227: at the default st_top_m = 2 three
    crossers overflow the ST graph; the drops surface and the ACC guard
    still avoids the unseen crosser."""
    jcfg, tcfg = _cfgs(N_PLANS)
    sc = _three_crosser_scenario(jcfg)
    _, m = t_cl.simulate_full(*port_scenario(sc), tcfg, device="cpu")
    summ = t_cl.summarize(m)
    assert int(summ["segments_dropped"]) > 0
    assert not bool(summ["collided"])
    _, mj = j_cl.simulate_full(sc.global_path, sc.ego0, sc.obstacles, jcfg)
    assert int(summ["segments_dropped"]) == int(j_cl.summarize(mj)["segments_dropped"])
    assert_metrics_match(m, jax.tree.map(lambda a: np.asarray(a)[None], mj),
                         t_cl.TickMetrics._fields, "three_crossers.")


def test_port_dp_obstacle_compression_surfaces_drops():
    """tests/test_fidelity.py:681: 8 parked cars and a closing lead NPC (its
    4 virtual obstacle points) exceed dp_top_m = 8; the drops surface and
    the loop stays collision-free and finite."""
    jcfg, tcfg = _cfgs(3)
    assert tcfg.path.dp_top_m == 8
    n = 200
    s = jnp.arange(n) * 2.0
    gp = Path(s, jnp.zeros(n), jnp.zeros(n), jnp.zeros(n))
    K = jcfg.n_static_obs + jcfg.n_dynamic_obs
    d0 = jcfg.n_static_obs
    sx = 20.0 + 9.0 * np.arange(8)
    sy = np.where(np.arange(8) % 2 == 0, 2.4, -2.4)
    ox = jnp.zeros(K).at[:8].set(jnp.asarray(sx, jnp.float32)).at[d0].set(30.0)
    oy = jnp.zeros(K).at[:8].set(jnp.asarray(sy, jnp.float32))
    ovx = jnp.zeros(K).at[d0].set(3.0)
    valid = jnp.ones(K, bool).at[d0 + 1:].set(False)
    z = jnp.zeros(())
    ego0 = EgoState(gp.x[0], gp.y[0], gp.theta[0], jnp.asarray(8.0, jnp.float32),
                    z, z, z, z, z)
    sc = j_sc.Scenario(gp, ego0, Obstacles(ox, oy, ovx, jnp.zeros(K), valid))
    _, m = t_cl.simulate(*port_scenario(sc), tcfg, device="cpu")
    summ = t_cl.summarize(m)
    assert int(summ["segments_dropped"]) > 0, "compression never engaged"
    assert not bool(summ["collided"])
    assert bool(np.isfinite(m.lateral_err.numpy()).all())
    _, mj = j_cl.simulate(sc.global_path, sc.ego0, sc.obstacles, jcfg)
    assert int(summ["segments_dropped"]) == int(j_cl.summarize(mj)["segments_dropped"])
    assert_metrics_match(m, jax.tree.map(lambda a: np.asarray(a)[None], mj),
                         t_cl.TickMetrics._fields, "dp_compression.")


def test_port_npc_lane_change_matches_oracle():
    """tests/test_fidelity.py:828, from chip_smoke.py's builder (held equal
    to the JAX test's in test_torch_edge_builders.py): the agent NPC closing
    on a parked car commits to the left lane in the port as in the oracle,
    their NPCs within 0.3 m of each other, and the ego trails at the
    oracle's 5 cm bar, with no collision."""
    jcfg, tcfg = _cfgs(3)
    sc, extra = chip_smoke.edge_scenario("npc_lane_change", tcfg)
    carry, m = out = chip_smoke.edge_run("npc_lane_change", sc, extra, tcfg, "cpu")
    chip_smoke.assert_edge("npc_lane_change", out, tcfg)
    g, ego0, statics, dynamics = unpack_scenario(
        j_sc.Scenario(*jax.tree.map(lambda a: np.asarray(a)[0], sc)))
    assert len(statics) == 1 and len(dynamics) == 1
    ox, oy, o_npcs = run_single_threaded(closed_loop_np.simulate_traffic, g, ego0, statics,
                                         dynamics, jcfg, "normal", 3, False, True)
    d0 = tcfg.n_static_obs
    o_slot = o_npcs[0]
    assert o_slot[6] == pytest.approx(3.5) and o_slot[5] > 3.0
    npc = carry.loop.obstacles
    assert abs(float(npc.x[0, d0]) - o_slot[0]) < 0.3
    assert abs(float(npc.y[0, d0]) - o_slot[1]) < 0.3
    rmse = lateral_rmse(*xy(m), ox, oy)
    assert rmse <= 0.05, f"lane-change RMSE vs oracle {rmse:.3f} m"
