"""PyTorch port, the cold QP contract (kernel K1c's plain version) and the
two open-loop entries that use it, against the JAX package on the CPU:
``path_qp`` and ``speed_qp`` without a warm state, the open-loop path plan
``plan_path_cycle(qp_warm=None)`` (BASELINE config 2), the standalone S-T
DP + cold speed QP of BASELINE config 1 (``bench_all.py:52-78``) and a full
EM cycle from no warm state.

Bar: the K1 bar on x (rtol 1e-4 / atol 1e-4; float32 dot order differs),
decisions identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.planner import em_planner as j_em
from emplanner_carla_tpu.planner import path_qp as j_path_qp
from emplanner_carla_tpu.planner import speed_planner as j_sp
from emplanner_carla_tpu.sim import scenario as j_sc
from emplanner_carla_tpu.types import STSegments as JSeg
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.ops import qp as t_qp
from emplanner_carla_tpu_torch.planner import em_planner as t_em
from emplanner_carla_tpu_torch.planner import path_qp as t_path_qp
from emplanner_carla_tpu_torch.planner import speed_planner as t_sp
from emplanner_carla_tpu_torch.types import STSegments
from torch_port_helpers import np_of, t32

JC = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=1, plan_every=20))
TC = convert.config_from_dict(dataclasses.asdict(JC))
B = 8
N_ST = 25      # path-QP stations of the default config (n 100, m 179)


def _close(a, b, err_msg="", rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def test_cold_solvers_are_their_own_sites():
    """The cold solvers run 3 x 80 iterations from zero under their own
    launch counters; on the CPU a cold solve launches nothing and equals
    the warm ladder from the zero state."""
    path_cold, _, _ = t_path_qp._solver_for(N_ST, 4.0, TC.path, False)
    speed_cold = t_sp._speed_solver(TC.speed, warm=False)
    assert (path_cold.name, path_cold.iters, path_cold.warm) == ("qp_admm_cold_path", 80, False)
    assert (speed_cold.name, speed_cold.iters) == ("qp_admm_cold_speed", 80)
    assert t_path_qp._solver_for(N_ST, 4.0, TC.path)[0].iters == 15
    assert t_sp._speed_solver(TC.speed).iters == 40
    rng = np.random.default_rng(2)
    q = t32(rng.normal(size=(3, speed_cold.n)) * 50.0)
    l = t32(-rng.uniform(1, 5, (3, speed_cold.m)))
    u = t32(rng.uniform(1, 5, (3, speed_cold.m)))
    before = dict(t_qp.launches)
    x = speed_cold(q, l, u)
    assert dict(t_qp.launches) == before
    zero = t_qp.warm_zero_state(speed_cold.n, speed_cold.m, 3)
    assert torch.equal(x, t_qp.warm_ladder_torch(speed_cold, q, l, u, zero)[0])


def test_cold_path_qp_matches_jax(rng):
    n = N_ST
    st_s = (np.arange(n) * 4.0 + rng.uniform(-2, 2, (B, 1))).astype(np.float32)
    st_l = rng.normal(size=(B, n)).astype(np.float32)
    obs_s = rng.uniform(0, 100, (B, 12)).astype(np.float32)
    obs_l = rng.uniform(-3, 3, (B, 12)).astype(np.float32)
    valid = rng.uniform(size=(B, 12)) < 0.5
    lo, hi = t_path_qp.corridor(t32(st_s), t32(st_l), t32(obs_s), t32(obs_l),
                                torch.as_tensor(valid), TC.path)
    start = [rng.normal(size=B).astype(np.float32) * s for s in (1.0, 0.1, 0.01)]
    qj = jax.vmap(lambda a, b, c, d, e: j_path_qp.path_qp(a, b, c, d, e, JC.path, 4.0))(
        np_of(lo), np_of(hi), *start)
    qt = t_path_qp.path_qp(lo, hi, *[t32(a) for a in start], TC.path, 4.0)
    assert len(qj) == 3 and qt[3] is None
    for name, a, b in zip(("l", "dl", "ddl"), qt[:3], qj):
        _close(a, b, name)


def _config1_inputs(batch=B):
    """bench_all.py config 1's fixed set (K = 4, two valid segments) tiled
    to the batch, its 60-point straight path and its plan-start speed of
    10 m/s."""
    rows = ([20.0, 35.0, 0, 0], [25.0, 38.0, 0, 0], [2.0, 4.0, 0, 0], [5.0, 6.5, 0, 0])
    f = [np.tile(np.asarray(r, np.float32), (batch, 1)) for r in rows]
    valid = np.tile(np.asarray([True, True, False, False]), (batch, 1))
    v0 = np.full(batch, 10.0, np.float32)
    v0[1:4] = [4.0, 13.0, 7.5]          # some lanes start elsewhere
    return f, valid, v0


def _jax_st_solve(seg_row, v0, cfg):
    """bench_all.py config 1, per lane."""
    dp = j_sp.speed_dp(seg_row, v0, cfg.speed)
    bounds = j_sp.convex_space(dp, seg_row, jnp.linspace(0, 120.0, 60),
                               jnp.full(60, 1e-3), cfg.speed)
    return j_sp.speed_qp(v0, jnp.float32(0.0), *bounds, cfg.speed)


def test_config1_st_solve_matches_jax():
    """The standalone S-T DP + cold speed QP: the port's batch-first stages
    against bench config 1's JAX function."""
    f, valid, v0 = _config1_inputs()
    qj = jax.jit(jax.vmap(lambda s, v: _jax_st_solve(s, v, JC)))(JSeg(*f, valid), v0)
    seg = STSegments(*(t32(a) for a in f), torch.as_tensor(valid))
    v0t = t32(v0)
    dp = t_sp.speed_dp(seg, v0t, TC.speed)
    path_s = torch.linspace(0, 120.0, 60).expand(B, 60)
    bounds = t_sp.convex_space(dp, seg, path_s, torch.full((B, 60), 1e-3), TC.speed)
    qt = t_sp.speed_qp(v0t, torch.zeros(B), *bounds, TC.speed)
    assert qt[4] is None
    for name, a, b in zip(("s", "s_dot", "s_dot2"), qt[:3], qj):
        _close(a, b, name)
    _close(qt[3], np.asarray(qj[3])[0], "t")


@pytest.fixture(scope="module")
def bench_mix():
    return j_sc.batch_scenarios(jax.random.PRNGKey(3), B, JC, n_path=96)


def test_open_loop_path_plan_matches_jax(bench_mix):
    """BASELINE config 2: ``plan_path_cycle`` with match index 0 and no warm
    state (``bench_all.py:80-88``)."""
    sc = bench_mix
    mi = np.zeros(B, np.int32)
    rj = jax.jit(jax.vmap(lambda g, e, o, m: j_em.plan_path_cycle(g, e, o, m, JC)))(
        sc.global_path, sc.ego0, sc.obstacles, mi)
    assert rj.qp_state is None
    rt = t_em.plan_path_cycle(convert.path_from_numpy(sc.global_path),
                              convert.ego_from_numpy(sc.ego0),
                              convert.obstacles_from_numpy(sc.obstacles),
                              torch.zeros(B, dtype=torch.int32), TC)
    assert rt.qp_state is None
    np.testing.assert_array_equal(np_of(rt.feasible), np.asarray(rj.feasible))
    np.testing.assert_array_equal(np_of(rt.match_index), np.asarray(rj.match_index))
    _close(rt.path_l, rj.path_l, "path_l")
    for name in ("x", "y", "theta", "kappa"):
        _close(getattr(rt.target, name), getattr(rj.target, name), name,
               rtol=1e-5, atol=2e-4)


def test_full_cycle_without_warm_state_matches_jax(bench_mix):
    """``plan_full_cycle(qp_warm=None)``: both QPs cold."""
    sc = bench_mix
    mi = np.zeros(B, np.int32)
    rj = jax.jit(jax.vmap(lambda g, e, o, m: j_em.plan_full_cycle(g, e, o, m, JC)))(
        sc.global_path, sc.ego0, sc.obstacles, mi)
    rt = t_em.plan_full_cycle(convert.path_from_numpy(sc.global_path),
                              convert.ego_from_numpy(sc.ego0),
                              convert.obstacles_from_numpy(sc.obstacles),
                              torch.zeros(B, dtype=torch.int32), TC)
    assert rt.speed_qp_state is None and rt.path.qp_state is None
    np.testing.assert_array_equal(np_of(rt.segments_dropped), np.asarray(rj.segments_dropped))
    for name in ("speed", "time", "x", "y"):
        _close(getattr(rt.trajectory, name), getattr(rj.trajectory, name), name,
               rtol=1e-5, atol=5e-3)
