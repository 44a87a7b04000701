"""PyTorch port against the float64 NumPy oracle on the reference's edge
scenarios (``tests/test_fidelity.py``), part 2, where the ego has to stop
or yield: the crosser it cannot yield to (:589, the speed QP's relaxation
active at cycle 0), the red light (:720) and the walker (:773). Each runs
``chip_smoke.py``'s builder (held equal to the JAX test's in
``test_torch_edge_builders.py``) through the port on the CPU, meets the JAX
test's assertions (``chip_smoke.assert_edge``, which the card's edge phase
applies to its 4096 lanes) and its oracle bars: lateral RMSE <= 5 cm,
positions within 1 m a tick, and for the crosser and the walker the
clearance of the oracle's own run."""

import dataclasses

import jax
import numpy as np

import chip_smoke
from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.oracle import closed_loop_np
from emplanner_carla_tpu.sim import scenario as j_sc
from emplanner_carla_tpu_torch import convert
from test_fidelity import N_PLANS, lateral_rmse, unpack_scenario
from test_torch_edge_oracle import xy
from torch_port_helpers import run_single_threaded


def _run(name):
    """(JAX config, port config, the JAX test's scenario as one lane of
    NumPy arrays, the port's output) of chip_smoke.EDGE_CASES[name]."""
    n_plans = chip_smoke.EDGE_CASES[name][1]
    jcfg = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=n_plans))
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    sc, extra = chip_smoke.edge_scenario(name, tcfg)
    out = chip_smoke.edge_run(name, sc, extra, tcfg, "cpu")
    chip_smoke.assert_edge(name, out, tcfg)
    j = j_sc.Scenario(*jax.tree.map(lambda a: np.asarray(a)[0], sc))
    return jcfg, tcfg, sc, j, out


def _assert_oracle_bars(m, ox, oy, label):
    px, py = xy(m)
    assert len(ox) == len(px)
    rmse = lateral_rmse(px, py, ox, oy)
    assert rmse <= 0.05, f"{label} RMSE vs oracle {rmse:.3f} m"
    gap = float(np.hypot(px - ox, py - oy).max())
    assert gap < 1.0, f"{label}: longitudinal divergence {gap:.2f} m"


def test_port_yield_infeasible_relaxation_end_to_end():
    """(a) + (b): cycle 0's speed stage, recomputed with the port's pieces
    (``chip_smoke.yield_cycle0``), has one ST segment, yields below the
    float64 max-braking envelope (the relaxation active) and brakes at
    accel_min; (c): the closed loop brakes hard and collides with nothing,
    at fidelity with the oracle, whose own run clears the crosser."""
    jcfg, tcfg, sc, j, (_, m) = _run("yield_infeasible")
    chip_smoke.assert_yield_relaxation(chip_smoke.yield_cycle0(sc, tcfg), tcfg)
    g, ego0, statics, dynamics = unpack_scenario(j)
    assert statics == [] and len(dynamics) == 1
    ox, oy = run_single_threaded(closed_loop_np.simulate_full, g, ego0, statics, dynamics,
                                 jcfg, N_PLANS)
    _assert_oracle_bars(m, ox, oy, "yield-infeasible")
    t_obs = (np.arange(len(ox)) + 1.0) * tcfg.plant.dt
    assert float(np.hypot(ox - 26.0, oy - (-21.0 + 19.0 * t_obs)).min()) > 1.5


def test_port_red_light_stop_matches_oracle():
    """The ego brakes to a crawl short of the line at x = 40 while red, goes
    on green at 5 s, and tracks the oracle's red-light mirror."""
    jcfg, tcfg, sc, j, (_, m) = _run("red_light_stop")
    g, ego0, _, _ = unpack_scenario(j)
    ox, oy = run_single_threaded(closed_loop_np.simulate, g, ego0, [], jcfg,
                                 chip_smoke.EDGE_CASES["red_light_stop"][1],
                                 [(40.0, 0.0, 10.0, 5.0, 0.5)])
    _assert_oracle_bars(m, ox, oy, "red-light")


def test_port_walker_yield_matches_oracle():
    """A walker stepping into the lane 18 m ahead: the ego brakes and
    swerves, clears the walker by 2 m, and tracks the oracle."""
    jcfg, tcfg, sc, j, (_, m) = _run("walker_yield")
    g, ego0, statics, dynamics = unpack_scenario(j)
    assert statics == [] and len(dynamics) == 1
    ox, oy = run_single_threaded(closed_loop_np.simulate_full, g, ego0, statics, dynamics,
                                 jcfg, N_PLANS)
    _assert_oracle_bars(m, ox, oy, "walker-yield")
