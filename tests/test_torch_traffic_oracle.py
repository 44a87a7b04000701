"""PyTorch port against the float64 NumPy oracle, agent traffic: the port's
``simulate_traffic`` (normal preset, path-only) on
``test_fidelity._traffic_scenario`` (a straight road, an accelerating agent
NPC ahead on the ego's route and a far crossing walker) must stay within
BASELINE.md's 5 cm lateral-RMSE bar against ``oracle/closed_loop_np.
simulate_traffic`` (whose loop-based agent model, ``oracle/npc_np.py``, is
independent of the port's), track its positions to 1 m a tick, collide
with nothing, and the NPC must have driven, at the settings of
``test_fidelity.test_simulate_traffic_matches_oracle``. A file of its own,
so that the oracle's run gets a worker to itself."""

import dataclasses

import jax
import numpy as np

from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.oracle import closed_loop_np
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.sim import closed_loop as t_cl
from test_fidelity import N_PLANS, _traffic_scenario, lateral_rmse, unpack_scenario
from torch_port_helpers import run_single_threaded


def test_port_traffic_matches_oracle():
    jcfg = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=N_PLANS))
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    sc = _traffic_scenario(jcfg)
    batch = jax.tree.map(lambda a: np.asarray(a)[None], sc)
    carry, m = t_cl.simulate_traffic(
        convert.path_from_numpy(batch.global_path), convert.ego_from_numpy(batch.ego0),
        convert.obstacles_from_numpy(batch.obstacles), tcfg, behavior="normal",
        full=False, device="cpu",
    )
    g, ego0, statics, dynamics = unpack_scenario(sc)
    assert statics == [] and len(dynamics) == 2
    ox, oy = run_single_threaded(closed_loop_np.simulate_traffic, g, ego0, statics,
                                 dynamics, jcfg, "normal", N_PLANS, False)
    px = m.x.numpy().reshape(-1)
    py = m.y.numpy().reshape(-1)
    assert len(ox) == len(px)
    rmse = lateral_rmse(px, py, ox, oy)
    assert rmse <= 0.05, f"port traffic lateral RMSE vs oracle {rmse:.3f} m"
    per_tick = np.hypot(px - ox, py - oy)
    assert float(per_tick.max()) < 1.0, f"per-tick gap {per_tick.max():.2f} m"
    assert not bool(m.collided.any())
    # the NPC drove: slot d0 well beyond constant-velocity coasting
    d0 = tcfg.n_static_obs
    npc_x = float(carry.loop.obstacles.x[0, d0])
    assert npc_x > 30.0 + 4.0 * N_PLANS * 100 * tcfg.plant.dt + 2.0
