"""PyTorch port, routing and routed fleets: the towns and the test_9
fixture array for array, the host A* engine (``astar_host``,
``stitch_route``, ``plan_route``) against its JAX-package twin, the batched
device engine (``astar_device``, ``route_nodes_device``,
``stitch_route_device``) against ``jax.vmap`` of the JAX device engine
(each engine against its own twin: the two break ties differently), the
routed scenario functions fed the JAX package's pairs and unit draws, the
test_9 scenario, routed ``simulate_full`` against the JAX loop, and the
test_9 drive against the float64 oracle.

Bars: graphs, routes, parents, options and stitched x / y exactly (x and y
are copies of graph points); scenario floats and the closed loop within
rtol 1e-5 / atol 5 mm with decisions identical
(``__graft_entry__._assert_metrics_match``); the test_9 drive within 5 cm
lateral RMSE of the oracle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.oracle import closed_loop_np
from emplanner_carla_tpu.routing import astar as j_astar
from emplanner_carla_tpu.routing import graph as j_graph
from emplanner_carla_tpu.sim import closed_loop as j_cl
from emplanner_carla_tpu.sim import scenario as j_sc
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.routing import astar as t_astar
from emplanner_carla_tpu_torch.routing import graph as t_graph
from emplanner_carla_tpu_torch.sim import closed_loop as t_cl
from emplanner_carla_tpu_torch.sim import scenario as t_sc
from test_fidelity import lateral_rmse, unpack_scenario
from torch_port_helpers import assert_metrics_match, np_of, run_single_threaded

JC = JCfg()
TC = convert.config_from_dict(dataclasses.asdict(JC))
TOWNS = ("grid_town", "grid_town_curved", "multilane_highway", "town05_test9",
         "ring_town")
GRAPH_FIELDS = ("nodes_xy", "adj", "adj_edge", "edge_len", "edge_path", "edge_n",
                "edge_option")
DEVICE_PAIRS = 64


@pytest.mark.parametrize("name", TOWNS)
def test_town_arrays_equal(name):
    a, b = getattr(j_graph, name)(), getattr(t_graph, name)()
    for f in GRAPH_FIELDS:
        ja, tb = getattr(a, f), getattr(b, f)
        assert ja.dtype == tb.dtype, f
        assert np.array_equal(ja, tb, equal_nan=True), f"{name}.{f}"
    assert a.resolution == b.resolution
    if name == "grid_town_curved":
        assert b.n_nodes == 48 and b.n_edges == 152
        assert b.edge_path.shape[1] == 26 and b.adj.shape[1] == 6


def test_test9_fixtures_and_options_equal():
    for f in ("TEST9_EGO_SPAWN", "TEST9_DESTINATION", "TEST9_STATICS", "TEST9_NPC"):
        assert getattr(t_graph, f) == getattr(j_graph, f), f
    assert {o.name: int(o) for o in t_graph.RoadOption} == \
        {o.name: int(o) for o in j_graph.RoadOption}
    gt, gj = t_graph.grid_town_curved(), j_graph.grid_town_curved()
    for n1 in range(gt.n_nodes):
        for n2 in range(gt.n_nodes):
            assert gt.edge_between(n1, n2) == gj.edge_between(n1, n2)
    for x, y in ((81.0, 14.0), (-5.0, 250.0), (120.0, 120.0)):
        assert gt.nearest_node(x, y) == gj.nearest_node(x, y)


def _host_pairs(g):
    rng = np.random.default_rng(11)
    pairs = [tuple(int(v) for v in rng.integers(0, g.n_nodes, 2)) for _ in range(24)]
    return pairs + [(3, 3)]


@pytest.mark.parametrize("name", ("grid_town_curved", "multilane_highway"))
def test_host_engine_matches_jax(name):
    gj, gt = getattr(j_graph, name)(), getattr(t_graph, name)()
    unreachable = 0
    for o, d in _host_pairs(gt):
        rj, rt = j_astar.astar_host(gj, o, d), t_astar.astar_host(gt, o, d)
        assert rj == rt, (o, d)
        if rt is None:
            unreachable += 1
            with pytest.raises(ValueError):
                t_astar.plan_route(gt, tuple(gt.nodes_xy[o]), tuple(gt.nodes_xy[d]))
            continue
        if len(rt) > 1:
            for a, b in zip(j_astar.stitch_route(gj, rj, with_options=True),
                            t_astar.stitch_route(gt, rt, with_options=True)):
                assert np.array_equal(a, b)
        for pad in (None, 64):
            oj = j_astar.plan_route(gj, tuple(gj.nodes_xy[o]), tuple(gj.nodes_xy[d]),
                                    pad_to=pad, with_options=True)
            ot = t_astar.plan_route(gt, tuple(gt.nodes_xy[o]), tuple(gt.nodes_xy[d]),
                                    pad_to=pad, with_options=True)
            for a, b in zip(oj, ot):
                assert np.array_equal(a, b), (o, d, pad)
    # the one-way highway has pairs no route joins
    assert (unreachable > 0) == (name == "multilane_highway")


def _device_pairs(g):
    rng = np.random.default_rng(5)
    o = rng.integers(0, g.n_nodes, DEVICE_PAIRS).astype(np.int32)
    d = rng.integers(0, g.n_nodes, DEVICE_PAIRS).astype(np.int32)
    d[0] = o[0]                                  # o == d
    return o, d


@pytest.mark.parametrize("name", ("grid_town_curved", "multilane_highway"))
def test_device_engine_matches_jax(name):
    """Parents, found, routes, slot masks, reached, n_valid, options and the
    stitched points of 64 pairs, identical; pad 128 cuts the longest routes."""
    gj, gt = getattr(j_graph, name)(), getattr(t_graph, name)()
    o, d = _device_pairs(gt)
    pad = 128

    def one(o_, d_):
        parent, found = j_astar.astar_device(gj, o_, d_)
        route, valid, reached = j_astar.route_nodes_device(gj, o_, d_)
        x, y, n, opt = j_astar.stitch_route_device(gj, route, valid, pad)
        return parent, found, route, valid, reached, x, y, n, opt

    ref = jax.jit(jax.vmap(one))(jnp.asarray(o), jnp.asarray(d))
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    parent, found = t_astar.astar_device(gt, ot, dt)
    route, valid, reached = t_astar.route_nodes_device(gt, ot, dt)
    out = (parent, found, route, valid, reached,
           *t_astar.stitch_route_device(gt, route, valid, pad))
    names = ("parent", "found", "route", "valid", "reached", "x", "y", "n_valid",
             "options")
    for nm, a, b in zip(names, out, ref):
        a, b = np_of(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, nm
        assert np.array_equal(a, b), f"{nm}: {int(np.sum(a != b))} differ"
    n = np_of(out[7])
    if name == "grid_town_curved":
        assert bool(found.all()) and (n == pad).any() and (n < pad).any()
    else:
        assert not bool(reached.all())


def _jax_placement(keys, cfg):
    """The unit draws behind ``populate_scenario`` for each key: the same
    splits, drawn on [0, 1)."""
    K = cfg.n_static_obs + cfg.n_dynamic_obs

    def one(k):
        k_s, k_l, k_dyn = jax.random.split(k, 3)
        u = jax.random.uniform
        return (u(k_s, (K,)), u(k_l, (K,)), u(k_dyn, ()),
                u(jax.random.fold_in(k_dyn, 1), ()))

    draws = jax.vmap(one)(keys)
    return t_sc.PlacementUniforms(*[torch.as_tensor(np.array(a)) for a in draws])


def _assert_routed_match(rt, rj):
    np.testing.assert_array_equal(np_of(rt.n_valid), np.asarray(rj.n_valid))
    np.testing.assert_array_equal(np_of(rt.road_option), np.asarray(rj.road_option))
    gt, gj = rt.scenario.global_path, rj.scenario.global_path
    np.testing.assert_array_equal(np_of(gt.x), np.asarray(gj.x))
    np.testing.assert_array_equal(np_of(gt.y), np.asarray(gj.y))
    for part in ("global_path", "ego0", "obstacles"):
        assert_metrics_match(getattr(rt.scenario, part), getattr(rj.scenario, part),
                             getattr(rt.scenario, part)._fields, f"{part}.")


def test_routed_scenarios_match_jax():
    key = jax.random.PRNGKey(4)
    batch = 4
    rj = j_sc.routed_scenarios(key, batch, JC, with_walker=True)
    k_route, k_pop = jax.random.split(key)
    seed = int(jax.random.randint(k_route, (), 0, 2**31 - 1))
    rt = t_sc.routed_scenarios(seed, batch, TC, with_walker=True, device="cpu",
                               placement=_jax_placement(jax.random.split(k_pop, batch), JC))
    _assert_routed_match(rt, rj)
    # the padded tail holds the last valid heading and curvature
    n = int(rt.n_valid[0])
    th = np_of(rt.scenario.global_path.theta[0])
    assert n < 256 and np.all(th[n - 1:] == th[n - 1])


def test_routed_scenarios_device_matches_jax():
    key = jax.random.PRNGKey(2)
    batch, over = 4, 8
    rj = j_sc.routed_scenarios_device(key, batch, JC, oversample=over)
    k_route, k_pop = jax.random.split(key)
    k_o, k_d = jax.random.split(k_route)
    n_cand = over * batch
    N = t_graph.grid_town_curved().n_nodes
    pairs = (np.asarray(jax.random.randint(k_o, (n_cand,), 0, N)),
             np.asarray(jax.random.randint(k_d, (n_cand,), 0, N)))
    rt = t_sc.routed_scenarios_device(
        0, batch, TC, oversample=over, pairs=pairs, device="cpu",
        placement=_jax_placement(jax.random.split(k_pop, batch), JC))
    _assert_routed_match(rt, rj)
    # seeded draws: deterministic, and too few routable pairs raise
    a = t_sc.routed_scenarios_device(3, 2, TC, device="cpu")
    b = t_sc.routed_scenarios_device(3, 2, TC, device="cpu")
    assert torch.equal(a.scenario.global_path.x, b.scenario.global_path.x)
    assert torch.equal(a.scenario.obstacles.x, b.scenario.obstacles.x)
    assert bool((a.n_valid >= 120).all())
    with pytest.raises(ValueError):
        t_sc.routed_scenarios_device(3, 4, TC, oversample=1, min_points=250,
                                     device="cpu")


def test_test9_scenario_matches_jax():
    sj, nj = j_sc.test9_scenario(JC)
    st, nt = t_sc.test9_scenario(TC, device="cpu")
    assert int(nt[0]) == int(nj) and nt.dtype == torch.int32
    for part in ("global_path", "ego0", "obstacles"):
        for f, a, b in zip(getattr(st, part)._fields, getattr(st, part),
                           getattr(sj, part)):
            a, b = np_of(a)[0], np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, f"{part}.{f}"
            if part == "global_path" and f in ("theta", "kappa"):
                # atan2 and sin of the two libraries: last-ulp rounding
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                           err_msg=f"{part}.{f}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{part}.{f}")


def test_routed_simulate_full_matches_jax():
    """Routed roads (junction arcs, padded tails) through the full EM loop:
    4 lanes x 2 plans, the port on the CPU against ``jax.vmap`` of the JAX
    ``simulate_full`` on the same routed scenarios."""
    jc = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=2, plan_every=20))
    tc = convert.config_from_dict(dataclasses.asdict(jc))
    sc = j_sc.routed_scenarios(jax.random.PRNGKey(6), 4, jc).scenario
    _, m_j = jax.jit(jax.vmap(lambda g, e, o: j_cl.simulate_full(g, e, o, jc)))(*sc)
    before = dict(t_cl.launches)
    _, m_t = t_cl.simulate_full(convert.path_from_numpy(sc.global_path),
                                convert.ego_from_numpy(sc.ego0),
                                convert.obstacles_from_numpy(sc.obstacles), tc,
                                device="cpu")
    assert t_cl.launches == before      # CPU tensors: the plain tick loop
    assert_metrics_match(m_t, m_j, j_cl.TickMetrics._fields, "routed.")
    assert bool(np.isfinite(np_of(m_t.lateral_err)).all())


def test_test9_drive_matches_oracle():
    """The reference's headline drive: the port's ``test9_scenario`` under
    MPC + the dynamic bicycle with the BehaviorAgent-analogue NPC
    (``simulate_traffic``, normal preset, 5 plans), within 5 cm lateral RMSE
    of the float64 oracle's ``simulate_traffic`` and collision-free
    (``tests/test_town05.py``'s configuration)."""
    base = JCfg()
    jc = JCfg(control=dataclasses.replace(base.control, kind="MPC"),
              plant=dataclasses.replace(base.plant, kind="dynamic"),
              loop=dataclasses.replace(base.loop, n_plans=5))
    tc = convert.config_from_dict(dataclasses.asdict(jc))
    st, _ = t_sc.test9_scenario(tc, device="cpu")
    _, m = t_cl.simulate_traffic(*st, tc, behavior="normal", device="cpu")
    g, ego0, statics, dynamics = unpack_scenario(jax.tree.map(lambda a: np_of(a)[0], st))
    assert len(statics) == 3 and len(dynamics) == 1
    ox, oy = run_single_threaded(closed_loop_np.simulate_traffic, g, ego0, statics,
                                 dynamics, jc, "normal", 5)
    px, py = np_of(m.x).reshape(-1), np_of(m.y).reshape(-1)
    assert len(ox) == len(px)
    rmse = lateral_rmse(px, py, ox, oy)
    assert rmse <= 0.05, f"test_9 drive lateral RMSE vs oracle {rmse:.3f} m"
    assert not bool(m.collided.any())
