"""PyTorch port against the float64 NumPy oracle, full EM loop: the port's
``simulate_full`` (path + S-T speed planning, config 5's shape) on the
crossing-NPC scenario, whose ST graph is non-empty, must stay within
BASELINE.md's 5 cm lateral-RMSE bar and track the oracle's positions to
1 m a tick, at the settings of
``test_fidelity.test_full_em_matches_oracle_crossing_npc``. A file of its
own, so that the oracle's run gets a worker to itself."""

import dataclasses

import jax
import numpy as np

from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.oracle import closed_loop_np
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.sim import closed_loop as t_cl
from test_fidelity import N_PLANS, _crossing_scenario, lateral_rmse, unpack_scenario
from torch_port_helpers import run_single_threaded


def test_port_full_em_matches_oracle_crossing_npc():
    jcfg = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=N_PLANS))
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    sc = _crossing_scenario(jcfg)
    batch = jax.tree.map(lambda a: np.asarray(a)[None], sc)
    _, m = t_cl.simulate_full(
        convert.path_from_numpy(batch.global_path),
        convert.ego_from_numpy(batch.ego0),
        convert.obstacles_from_numpy(batch.obstacles), tcfg, device="cpu",
    )
    g, ego0, statics, dynamics = unpack_scenario(sc)
    assert statics == [] and len(dynamics) == 1
    ox, oy = run_single_threaded(closed_loop_np.simulate_full, g, ego0, statics,
                                 dynamics, jcfg, N_PLANS)
    px = m.x.numpy().reshape(-1)
    py = m.y.numpy().reshape(-1)
    assert len(ox) == len(px)
    rmse = lateral_rmse(px, py, ox, oy)
    assert rmse <= 0.05, f"port full-EM lateral RMSE vs oracle {rmse:.3f} m"
    # positions encode the speed profile on the straight road: a flipped
    # yield / overtake decision would differ by metres
    per_tick = np.hypot(px - ox, py - oy)
    assert float(per_tick.max()) < 1.0, f"per-tick gap {per_tick.max():.2f} m"
