"""PyTorch port against the float64 NumPy oracle: the port's ``simulate``
(config 3: path loop, LQR + kinematic plant) must stay within BASELINE.md's
5 cm lateral-RMSE bar, at the settings of
``test_fidelity.test_closed_loop_matches_numpy_oracle``."""

import dataclasses

import jax
import numpy as np
import pytest

from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.oracle import closed_loop_np
from emplanner_carla_tpu.sim import scenario as j_sc
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.sim import closed_loop as t_cl
from test_fidelity import N_PLANS, lateral_rmse, unpack_scenario
from torch_port_helpers import run_single_threaded


@pytest.mark.parametrize("seed", [0, 2])
def test_port_closed_loop_matches_numpy_oracle(seed):
    jcfg = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=N_PLANS))
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    sc = j_sc.make_scenario(
        jax.random.PRNGKey(seed), jcfg, with_dynamic=False, n_active_static=2,
        v0=10.0,
    )
    batch = jax.tree.map(lambda a: np.asarray(a)[None], sc)
    _, m = t_cl.simulate(
        convert.path_from_numpy(batch.global_path),
        convert.ego_from_numpy(batch.ego0),
        convert.obstacles_from_numpy(batch.obstacles), tcfg, device="cpu",
    )
    g, ego0, statics, _ = unpack_scenario(sc)
    ox, oy = run_single_threaded(closed_loop_np.simulate, g, ego0, statics, jcfg,
                                 N_PLANS)
    px = m.x.numpy().reshape(-1)
    py = m.y.numpy().reshape(-1)
    assert len(ox) == len(px)
    rmse = lateral_rmse(px, py, ox, oy)
    assert rmse <= 0.05, f"port lateral RMSE vs oracle {rmse:.3f} m"
