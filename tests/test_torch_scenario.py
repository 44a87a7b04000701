"""PyTorch port: scenario generation against the JAX generator fed the same
unit draws, the seeded generator path, and the port's import isolation
(no JAX, nothing of the JAX package)."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.sim import scenario as j_sc
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.sim import scenario as t_sc
from torch_port_helpers import np_of

JC = JCfg()
TC = convert.config_from_dict(dataclasses.asdict(JC))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_unit_draws(key, cfg):
    """The unit floats behind ``make_scenario``'s draws: the same key
    splits, drawn on [0, 1) (``jax.random.uniform``'s raw floats)."""
    K = cfg.n_static_obs + cfg.n_dynamic_obs
    k_path, k_s, k_l, k_dyn = jax.random.split(key, 4)
    k_amp, k_pos, k_width = jax.random.split(k_path, 3)
    u = jax.random.uniform
    return (u(k_amp, (6,)), u(k_pos, (6,)), u(k_width, (6,)), u(k_s, (K,)),
            u(k_l, (K,)), u(k_dyn, ()), u(jax.random.fold_in(k_dyn, 1), ()))


def test_make_scenario_from_jax_uniforms():
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    kw = dict(n_path=128, with_walker=True)
    sj = jax.vmap(lambda k: j_sc.make_scenario(k, JC, **kw))(keys)
    draws = jax.vmap(lambda k: _jax_unit_draws(k, JC))(keys)
    u = t_sc.ScenarioUniforms(*[torch.as_tensor(np.array(a)) for a in draws])
    st = t_sc.make_scenario_from_uniforms(u, TC, **kw)
    for part in ("global_path", "ego0", "obstacles"):
        for f, a, b in zip(getattr(st, part)._fields, getattr(st, part),
                           getattr(sj, part)):
            b = np.asarray(b)
            if b.dtype == np.bool_:
                np.testing.assert_array_equal(np_of(a), b, err_msg=f"{part}.{f}")
            else:
                # cumulative sums over 128 nodes: float32 summation order
                np.testing.assert_allclose(np_of(a), b, rtol=1e-5, atol=2e-3,
                                           err_msg=f"{part}.{f}")


def test_batch_scenarios_seeded():
    a = t_sc.batch_scenarios(3, 5, TC, device="cpu", n_path=96)
    b = t_sc.batch_scenarios(3, 5, TC, device="cpu", n_path=96)
    c = t_sc.batch_scenarios(4, 5, TC, device="cpu", n_path=96)
    K = TC.n_static_obs + TC.n_dynamic_obs
    assert a.global_path.x.shape == (5, 96) and a.global_path.x.dtype == torch.float32
    assert a.ego0.x.shape == (5,) and a.obstacles.x.shape == (5, K)
    assert a.obstacles.valid.dtype == torch.bool
    assert int(a.obstacles.valid[0].sum()) == 4  # 3 parked + the lead NPC
    for ta, tb in zip(jax.tree.leaves(tuple(a)), jax.tree.leaves(tuple(b))):
        assert torch.equal(ta, tb)
    assert not torch.equal(a.global_path.x, c.global_path.x)
    for t in (a.global_path.x, a.global_path.kappa, a.obstacles.x):
        assert bool(torch.isfinite(t).all())
    assert float(a.global_path.kappa.abs().max()) <= 0.02 + 1e-7
    jnp.zeros(())  # JAX stays usable beside the port in one process


def test_port_imports_no_jax():
    """A process that blocks ``jax`` and the JAX package imports the port
    and runs a small simulate on the CPU."""
    code = r"""
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "emplanner_carla_tpu" \
                or name.startswith("emplanner_carla_tpu."):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
import dataclasses, importlib, pkgutil
import emplanner_carla_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from emplanner_carla_tpu_torch.config import EMConfig
from emplanner_carla_tpu_torch.sim import closed_loop, scenario
cfg = EMConfig(loop=dataclasses.replace(EMConfig().loop, n_plans=1, plan_every=10))
sc = scenario.batch_scenarios(0, 2, cfg, device="cpu", n_path=96)
_, m = closed_loop.simulate(*sc, cfg, device="cpu")
assert m.x.shape == (2, 1, 10)
assert not any(k == "jax" or k.startswith(("jax.", "emplanner_carla_tpu."))
               or k == "emplanner_carla_tpu" for k in sys.modules)
print("isolated ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "isolated ok" in out.stdout


def test_make_scenario_and_the_remaining_names():
    """``make_scenario`` (one scenario at batch 1, ``batch_scenarios``' draw),
    ``populate_scenario``, ``em_planner.n_target`` and the Frenet types."""
    from emplanner_carla_tpu import types as j_types
    from emplanner_carla_tpu.planner import em_planner as j_em
    from emplanner_carla_tpu_torch import types as t_types
    from emplanner_carla_tpu_torch.planner import em_planner as t_em

    K = TC.n_static_obs + TC.n_dynamic_obs
    one = t_sc.make_scenario(3, TC, device="cpu", n_path=96)
    assert one.global_path.x.shape == (1, 96) and one.ego0.x.shape == (1,)
    assert one.obstacles.x.shape == (1, K) and one.obstacles.valid.dtype == torch.bool
    ref = t_sc.batch_scenarios(3, 1, TC, device="cpu", n_path=96)
    for a, b in zip(jax.tree.leaves(tuple(one)), jax.tree.leaves(tuple(ref))):
        assert torch.equal(a, b)
    gp = t_sc.batch_scenarios(4, 3, TC, device="cpu", n_path=96).global_path
    placed = t_sc.populate_scenario(9, TC, gp, 190.0, device="cpu")
    assert placed.global_path.x.shape == (3, 96) and placed.obstacles.x.shape == (3, K)
    assert torch.equal(placed.global_path.x, gp.x)
    assert bool(torch.isfinite(placed.obstacles.x).all())
    assert t_em.n_target(TC) == j_em.n_target(JC)
    assert t_types.SLObstacles._fields == j_types.SLObstacles._fields
    assert t_types.FrenetState._fields == j_types.FrenetState._fields
