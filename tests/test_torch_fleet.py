"""PyTorch port, the fleet (``parallel/fleet.py``): a scenario batch split
over ``torch.distributed`` ranks with one all-reduce of the aggregates.

On the same JAX-made batch (8 scenarios, 96-point roads, 2 plans x 20
ticks): the port's fleet on two gloo ranks (one child process each) against
the JAX package's ``fleet_simulate`` on a two-device mesh (the same batch
split, the same partial sums), in path and full mode; and two ranks against
one (``make_mesh("cpu")``'s own one-rank group, in this process) in path,
full, agent-traffic and pixel mode.

Bars: per-scenario metrics at ``__graft_entry__._assert_metrics_match``'s
(bool and int channels identical, floats within rtol 1e-5 / atol 5 mm; the
pixel loop's tracked counts identical); the counts among the aggregates
(collisions, scenarios, infeasible cycles, drops) exact; lateral RMSE and
mean speed within rtol 1e-5 of the one-rank run and of a float64 host
reduction of the metrics, and against JAX within what the per-scenario
differences allow (the floats differ within the loop's bar, by up to 2e-5 m
in lateral error, and the RMSE by up to 5e-5 relative), an allowance held
under 1e-4 of the aggregate.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.parallel import fleet as j_fleet
from emplanner_carla_tpu.sim import scenario as j_sc
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.parallel import fleet as t_fleet
from emplanner_carla_tpu_torch.sim.scenario import Scenario
from torch_port_helpers import fleet_rank, numpy_tree, run_gloo_ranks

JC = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=2, plan_every=20))
TC = convert.config_from_dict(dataclasses.asdict(JC))
B = 8
MODES = {"path": {}, "full": {"full": True},
         "traffic": {"traffic": True, "full": True},
         "pixels": {"pixels": True, "full": True}}
COUNTS = ("collisions", "n_scenarios", "infeasible_cycles", "segments_dropped")


@pytest.fixture(scope="module")
def scenarios():
    """The JAX batch and the port's copy of it."""
    sc = j_sc.batch_scenarios(jax.random.PRNGKey(4), B, JC, n_path=96)
    port = Scenario(convert.path_from_numpy(sc.global_path),
                    convert.ego_from_numpy(sc.ego0),
                    convert.obstacles_from_numpy(sc.obstacles))
    return sc, port


@pytest.fixture(scope="module")
def two_ranks(scenarios, tmp_path_factory):
    """Every mode on two gloo ranks, then a checkpoint of the full mode's
    carry: {mode: (metrics, aggregates), "checkpoint": (files, restored
    equal)} of each rank, in rank order."""
    ckpt = str(tmp_path_factory.mktemp("fleet_ckpt"))
    return run_gloo_ranks(2, fleet_rank, scenarios[1], TC, MODES, ckpt)


@pytest.fixture(scope="module")
def one_rank(scenarios):
    """Every mode on the one-rank CPU group that ``make_mesh`` starts."""
    assert not dist.is_initialized()
    mesh = t_fleet.make_mesh("cpu")
    try:
        assert (mesh.rank, mesh.world, mesh.backend) == (0, 1, "gloo")
        local = t_fleet.shard_scenarios(scenarios[1], mesh)
        out = {}
        for name, kw in MODES.items():
            metrics, agg = t_fleet.fleet_simulate(local, TC, mesh, **kw)
            out[name] = (numpy_tree(metrics), {k: float(v) for k, v in agg.items()})
    finally:
        dist.destroy_process_group()
    return out


def _concat(shards):
    """Per-scenario metrics of the ranks, joined along the batch axis."""
    first = shards[0]
    if isinstance(first, tuple):
        return type(first)(*[_concat([s[i] for s in shards]) for i in range(len(first))])
    return np.concatenate(shards, 0)


def _assert_match(a, b, label):
    if isinstance(b, tuple):
        for name, x, y in zip(type(b)._fields, a, b):
            _assert_match(x, y, f"{label}.{name}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{label}: {a.shape} != {b.shape}"
    if b.dtype == np.bool_ or np.issubdtype(b.dtype, np.integer):
        assert np.array_equal(a, b), f"{label}: {int(np.sum(a != b))} of {a.size} differ"
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=5e-3, err_msg=label)


def _assert_agg(a: dict, b: dict, label):
    assert list(a) == list(b), f"{label}: keys {list(a)} != {list(b)}"
    for k in b:
        if k in COUNTS:
            assert float(a[k]) == float(b[k]), f"{label} {k}: {a[k]} != {b[k]}"
        else:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-5,
                                       err_msg=f"{label} {k}")


@pytest.mark.parametrize("mode", ["path", "full"])
def test_fleet_matches_jax_on_two_devices(scenarios, two_ranks, mode):
    sc, _ = scenarios
    mesh = j_fleet.make_mesh(jax.devices()[:2])
    metrics, agg = j_fleet.fleet_simulate(j_fleet.shard_scenarios(sc, mesh), JC, mesh,
                                          full=mode == "full")
    jm = jax.tree.map(np.asarray, metrics)
    jagg = {k: float(v) for k, v in agg.items()}
    port = _concat([r[mode][0] for r in two_ranks])
    _assert_match(port, jm, f"{mode} fleet vs JAX")
    # The per-scenario floats differ within the loop's bar (XLA and PyTorch
    # order float32 operations differently), so the two RMSEs and means
    # differ by up to what those differences allow: |rms(a) - rms(b)| <=
    # rms(a - b) and |mean(a) - mean(b)| <= mean|a - b|, plus rtol 1e-5 of
    # float32 summation; the counts are exact.
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    d_lat = np.sqrt(np.mean((f64(port.lateral_err) - f64(jm.lateral_err)) ** 2))
    d_spd = np.mean(np.abs(f64(port.speed_kmh) - f64(jm.speed_kmh)))
    for r in two_ranks:
        a = r[mode][1]
        assert list(a) == list(jagg)
        for k in COUNTS:
            assert a[k] == jagg[k], f"{mode} {k}: {a[k]} != {jagg[k]}"
        for k, d in (("lateral_rmse", d_lat), ("mean_speed_kmh", d_spd)):
            # the derived allowance itself stays small, so a drift of the
            # per-scenario floats cannot widen the aggregate's bar unnoticed
            assert d <= 1e-4 * abs(jagg[k]), f"{mode} {k}: metrics differ by {d}"
            assert abs(a[k] - jagg[k]) <= d + 1e-5 * abs(jagg[k]), (
                f"{mode} {k}: port {a[k]}, JAX {jagg[k]}, metrics allow {d}")
    assert two_ranks[0][mode][1]["n_scenarios"] == B


@pytest.mark.parametrize("mode", list(MODES))
def test_two_ranks_match_one(two_ranks, one_rank, mode):
    _assert_match(_concat([r[mode][0] for r in two_ranks]), one_rank[mode][0],
                  f"{mode} 2 ranks vs 1")
    for r in two_ranks:
        _assert_agg(r[mode][1], one_rank[mode][1], f"{mode} agg")
    agg = one_rank[mode][1]
    assert agg["n_scenarios"] == B
    assert all(np.isfinite(v) for v in agg.values())
    # the aggregates are the host reduction of the per-scenario metrics
    tk = one_rank[mode][0]
    tk = tk.ticks if mode == "pixels" else tk
    lat = tk.lateral_err.astype(np.float64)
    np.testing.assert_allclose(agg["lateral_rmse"], np.sqrt(np.mean(lat**2)), rtol=1e-5)
    np.testing.assert_allclose(agg["mean_speed_kmh"], tk.speed_kmh.astype(np.float64).mean(),
                               rtol=1e-5)
    assert agg["collisions"] == tk.collided.reshape(B, -1).any(1).sum()
    assert agg["infeasible_cycles"] == (~tk.feasible[..., 0]).sum()
    assert agg["segments_dropped"] == tk.segments_dropped[..., 0].sum()


def test_each_rank_writes_its_checkpoint_shard(two_ranks):
    for files, same in (r["checkpoint"] for r in two_ranks):
        assert files == ["shard-00000-of-00002.pt", "shard-00001-of-00002.pt"]
        assert same


def test_fleet_rejects_bad_arguments(scenarios):
    _, sc = scenarios
    three = t_fleet.FleetMesh(None, torch.device("cpu"), 0, 3, "gloo")
    with pytest.raises(ValueError, match="does not split"):
        t_fleet.shard_scenarios(sc, three)
    with pytest.raises(ValueError, match="mutually exclusive"):
        t_fleet.fleet_simulate(sc, TC, three, pixels=True, traffic=True)
    assert not dist.is_initialized()
    t_fleet.make_mesh(["cpu"])
    try:
        # a card's metrics are never reduced through a gloo group
        with pytest.raises(ValueError, match="NCCL"):
            t_fleet.make_mesh("cuda")
        with pytest.raises(ValueError, match="one device"):
            t_fleet.make_mesh(["cpu", "cpu"])
    finally:
        dist.destroy_process_group()
