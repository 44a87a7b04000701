"""PyTorch port, ops layer: geometry, interpolation, the build-time
constants, and the plain versions of the warm-QP (K1) and path-DP
obstacle-cost (K2) kernels against the JAX package on the CPU. The
kernel-vs-plain checks on the card are in test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.control import lateral as j_lateral
from emplanner_carla_tpu.ops import frenet as j_frenet
from emplanner_carla_tpu.ops import interp as j_interp
from emplanner_carla_tpu.ops import qp as j_qp
from emplanner_carla_tpu.ops import quintic as j_quintic
from emplanner_carla_tpu.planner import path_dp as j_path_dp
from emplanner_carla_tpu.planner import path_qp as j_path_qp
from emplanner_carla_tpu.planner import reference_line as j_refline
from emplanner_carla_tpu.types import Path as JPath
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.control import lateral as t_lateral
from emplanner_carla_tpu_torch.ops import frenet as t_frenet
from emplanner_carla_tpu_torch.ops import interp as t_interp
from emplanner_carla_tpu_torch.ops import qp as t_qp
from emplanner_carla_tpu_torch.ops import quintic as t_quintic
from emplanner_carla_tpu_torch.planner import path_dp as t_path_dp
from emplanner_carla_tpu_torch.planner import path_qp as t_path_qp
from emplanner_carla_tpu_torch.planner import reference_line as t_refline
from torch_port_helpers import assert_qp_close, np_of, t32

JC = JCfg()
TC = convert.config_from_dict(dataclasses.asdict(JC))
N_ST = 25  # path-QP stations of the default config


def test_config_round_trip():
    assert dataclasses.asdict(TC) == dataclasses.asdict(JC)


def _const_pairs():
    return {
        "prefactor_constants": lambda: (
            j_qp.prefactor_constants(*j_path_qp._qp_constants(N_ST, 4.0, JC.path)[:3]),
            t_qp.prefactor_constants(*t_path_qp._qp_constants(N_ST, 4.0, TC.path)[:3]),
        ),
        "lqr_gain_table": lambda: (
            j_lateral.lqr_gain_table(JC.vehicle, JC.control),
            t_lateral.lqr_gain_table(TC.vehicle, TC.control),
        ),
        "transition_geometry": lambda: (
            j_path_dp._transition_geometry(JC.path),
            t_path_dp._transition_geometry(TC.path),
        ),
        "qp_constants": lambda: (
            j_path_qp._qp_constants(N_ST, 4.0, JC.path),
            t_path_qp._qp_constants(N_ST, 4.0, TC.path),
        ),
        "smoother_matrices": lambda: (
            j_refline._smoother_matrices(51, JC.refline),
            t_refline._smoother_matrices(51, TC.refline),
        ),
    }


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _flat(t)]
    return [tree]


@pytest.mark.parametrize("name", sorted(_const_pairs()))
def test_build_time_constants_exact(name):
    """The trace-time NumPy constants are verbatim copies: exact equality."""
    a, b = _const_pairs()[name]()
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        else:
            assert x == y, name


def _curvy_path(rng, B=4, n=60):
    """Random smooth polylines (B, n) and their JAX/torch Paths."""
    s = np.arange(n) * 2.0
    k = 0.01 * np.sin(s[None] / 20.0 + rng.uniform(0, 6, (B, 1)))
    th = np.cumsum(k * 2.0, 1) + rng.uniform(-1, 1, (B, 1))
    x = (np.cumsum(np.cos(th) * 2.0, 1) + rng.uniform(-50, 50, (B, 1))).astype(np.float32)
    y = (np.cumsum(np.sin(th) * 2.0, 1) + rng.uniform(-50, 50, (B, 1))).astype(np.float32)
    jp = jax.vmap(j_frenet.path_from_xy)(jnp.asarray(x), jnp.asarray(y))
    return jp, convert.path_from_numpy(jp)


def test_interp_and_hat_match_jax(rng):
    xp = np.sort(rng.uniform(0, 10, (3, 12)), 1).astype(np.float32)
    fp = rng.normal(size=(3, 12)).astype(np.float32)
    xq = rng.uniform(-1, 11, (3, 7)).astype(np.float32)
    a = jax.vmap(j_interp.interp)(xq, xp, fp)
    b = t_interp.interp(t32(xq), t32(xp), t32(fp))
    np.testing.assert_allclose(np_of(b), np.asarray(a), rtol=1e-6, atol=1e-6)
    tq = rng.uniform(-0.5, 9, (5,)).astype(np.float32)
    a = j_interp.uniform_hat(tq, jnp.float32(0.0), jnp.float32(0.02), 401)
    b = t_interp.uniform_hat(t32(tq), t32(0.0), t32(0.02), 401)
    np.testing.assert_array_equal(np_of(b), np.asarray(a))


def test_quintic_matches_jax(rng):
    args = [rng.normal(size=(6,)).astype(np.float32) for _ in range(6)]
    c_j = j_quintic.hermite_coeffs(*args, 15.0)
    c_t = t_quintic.hermite_coeffs(*[t32(a) for a in args], 15.0)
    np.testing.assert_allclose(np_of(c_t), np.asarray(c_j), rtol=1e-6, atol=1e-6)
    u = np.linspace(0, 1, 9, dtype=np.float32)
    for a, b in zip(j_quintic.eval_with_derivs(c_j[:, None, :], u, 15.0),
                    t_quintic.eval_with_derivs(c_t[:, None, :], t32(u), 15.0)):
        np.testing.assert_allclose(np_of(b), np.asarray(a), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np_of(t_quintic.eval_poly(c_t[:, None, :], t32(u))),
        np.asarray(j_quintic.eval_poly(c_j[:, None, :], u)), rtol=1e-5, atol=1e-6)


def test_frenet_round_trip_matches_jax(rng):
    jp, tp = _curvy_path(rng)
    np.testing.assert_allclose(np_of(tp.theta), np.asarray(jp.theta), atol=2e-6)
    np.testing.assert_allclose(np_of(tp.kappa), np.asarray(jp.kappa), atol=2e-6)
    px = np.asarray(jp.x)[:, 20:26] + rng.normal(size=(4, 6)).astype(np.float32)
    py = np.asarray(jp.y)[:, 20:26] + rng.normal(size=(4, 6)).astype(np.float32)
    ox, oy = np.asarray(jp.x)[:, 5], np.asarray(jp.y)[:, 5]
    # nearest index keeps first-minimum ties
    np.testing.assert_array_equal(
        np_of(t_frenet.nearest_index(t32(px), t32(py), tp)),
        np.asarray(jax.vmap(j_frenet.nearest_index)(px, py, jp)))
    sm_j = jax.vmap(j_frenet.s_map_from_origin)(jp, ox, oy)
    sm_t = t_frenet.s_map_from_origin(tp, t32(ox), t32(oy))
    np.testing.assert_allclose(np_of(sm_t), np.asarray(sm_j), atol=2e-4)
    s_j, l_j = jax.vmap(j_frenet.cartesian_to_sl)(px, py, jp, sm_j)
    s_t, l_t = t_frenet.cartesian_to_sl(t32(px), t32(py), tp, sm_t)
    np.testing.assert_allclose(np_of(s_t), np.asarray(s_j), atol=2e-4)
    np.testing.assert_allclose(np_of(l_t), np.asarray(l_j), atol=2e-5)
    lp = rng.normal(size=(4, 6)).astype(np.float32) * 0.1
    lpp = rng.normal(size=(4, 6)).astype(np.float32) * 0.01
    cj = jax.vmap(j_frenet.frenet_to_cartesian)(s_j, l_j, lp, lpp, jp, sm_j)
    ct = t_frenet.frenet_to_cartesian(s_t, l_t, t32(lp), t32(lpp), tp, sm_t)
    for f in JPath._fields:
        np.testing.assert_allclose(np_of(getattr(ct, f)), np.asarray(getattr(cj, f)),
                                   atol=2e-4, err_msg=f)
    full_j = jax.vmap(j_frenet.cartesian_to_frenet_full)(
        px[:, 0], py[:, 0], lp[:, 0], lpp[:, 0], lp[:, 1], lpp[:, 1], jp, sm_j)
    full_t = t_frenet.cartesian_to_frenet_full(
        t32(px[:, 0]), t32(py[:, 0]), t32(lp[:, 0]), t32(lpp[:, 0]),
        t32(lp[:, 1]), t32(lpp[:, 1]), tp, sm_t)
    for a, b in zip(full_j, full_t):
        np.testing.assert_allclose(np_of(b), np.asarray(a), rtol=1e-4, atol=2e-4)
    center = np.array([0, 10, 30, 55], np.int32)
    np.testing.assert_array_equal(
        np_of(t_frenet.nearest_index_windowed(t32(px[:, 0]), t32(py[:, 0]), tp,
                                              torch.as_tensor(center), 16)),
        np.asarray(jax.vmap(lambda a, b, p, c: j_frenet.nearest_index_windowed(
            a, b, p, c, 16))(px[:, 0], py[:, 0], jp, center)))



def test_nearest_index_valid_mask_matches_jax(rng):
    """``nearest_index(..., valid=)`` at a non-default mask: masked nodes
    never match, and a query whose every node is masked gives index 0 in
    both packages."""
    jp, tp = _curvy_path(rng)
    B, N = np.asarray(jp.x).shape
    px = np.asarray(jp.x)[:, 20:26] + rng.normal(size=(B, 6)).astype(np.float32)
    py = np.asarray(jp.y)[:, 20:26] + rng.normal(size=(B, 6)).astype(np.float32)
    valid = rng.uniform(size=(B, N)) < 0.6
    valid[:, 18:28] = False              # the unmasked nearest nodes are out
    valid[1] = False                     # every node masked
    valid[2, ::2] = False
    # lane 3's query midway between two valid nodes around a masked one
    px[3, 0] = 0.5 * (float(jp.x[3, 31]) + float(jp.x[3, 33]))
    py[3, 0] = 0.5 * (float(jp.y[3, 31]) + float(jp.y[3, 33]))
    valid[3, 29:36] = [False, False, True, False, True, False, False]
    want = jax.vmap(lambda a, b, p, v: j_frenet.nearest_index(a, b, p, v))(
        px, py, jp, valid[:, None, :])
    got = t_frenet.nearest_index(t32(px), t32(py), tp, torch.as_tensor(valid))
    np.testing.assert_array_equal(np_of(got), np.asarray(want))
    assert np.all(valid[np.arange(B)[:, None], np_of(got)] | (np.arange(B) == 1)[:, None])
    # (B,) queries against the same mask
    want1 = jax.vmap(j_frenet.nearest_index)(px[:, 0], py[:, 0], jp, valid)
    got1 = t_frenet.nearest_index(t32(px[:, 0]), t32(py[:, 0]), tp, torch.as_tensor(valid))
    np.testing.assert_array_equal(np_of(got1), np.asarray(want1))


# ---------------- K1: the warm ADMM ladder ----------------

def _qp_problem(seed, B=8, warm_state=True):
    """Path-QP-shaped instances at the real size (25 stations, 15
    iterations per phase): centre-line costs, corridor corner bounds,
    pinned start state, optional random carried state."""
    rng = np.random.default_rng(seed)
    n = N_ST
    P, A, eq, _, _ = j_path_qp._qp_constants(n, 4.0, JC.path)
    nv, m = A.shape[1], A.shape[0]
    q = np.zeros((B, nv), np.float32)
    q[:, 0:3 * n:3] = -500.0 * rng.normal(size=(B, n))
    start = rng.normal(size=(B, 3)) * 0.5
    u = np.concatenate([np.zeros((B, 2 * (n - 1))), rng.uniform(0, 8, (B, 4 * n)),
                        start, np.zeros((B, 3)), np.full((B, n), 1e8)], 1).astype(np.float32)
    l = np.concatenate([np.zeros((B, 2 * (n - 1))), np.full((B, 4 * n), -1e8),
                        start, np.zeros((B, 3)), np.zeros((B, n))], 1).astype(np.float32)
    if warm_state:
        st = tuple(rng.normal(size=(B, k)).astype(np.float32) * 0.1 for k in (nv, m, m))
    else:
        st = tuple(np.zeros((B, k), np.float32) for k in (nv, m, m))
    return (P, A, eq), q, l, u, st


def _j_solver(P, A, eq, **kw):
    n = N_ST
    q_typ = np.zeros(A.shape[1])
    q_typ[0:3 * n:3] = -2.0 * JC.path.w_qp_centre * 2.0
    return j_qp.make_prefactored_qp(
        P, A, eq, q_typical=q_typ, iters_per_phase=80, warm=True,
        warm_iters_per_phase=max(JC.path.warm_admm_iters // 3, 1), **kw)


@pytest.mark.parametrize("warm_state", [False, True])
def test_k1_plain_matches_xla_and_pallas_interpret(warm_state):
    (P, A, eq), q, l, u, st = _qp_problem(3, warm_state=warm_state)
    s_xla = _j_solver(P, A, eq)
    s_pl = _j_solver(P, A, eq, use_pallas=True, pallas_block=8,
                     pallas_interpret=True, kernel_matmul="highest")
    x_j, st_j = jax.vmap(s_xla)(q, l, u, st)
    x_p, st_p = s_pl(jnp.asarray(q), jnp.asarray(l), jnp.asarray(u),
                     tuple(jnp.asarray(a) for a in st))
    solver, _, _ = t_path_qp._solver_for(N_ST, 4.0, TC.path)
    before = t_qp.launches["qp_admm_warm"]
    x_t, st_t = solver(t32(q), t32(l), t32(u), tuple(t32(a) for a in st))
    assert t_qp.launches["qp_admm_warm"] == before  # CPU tensors: plain version
    xs = [np_of(a) for a in st_t]
    assert_qp_close(np_of(x_t), xs, np.asarray(x_j), [np.asarray(a) for a in st_j])
    assert_qp_close(np_of(x_t), xs, np.asarray(x_p), [np.asarray(a) for a in st_p])
    # the carried state gives the same next-cycle solution
    q2 = q * 1.05
    x_j2, _ = jax.vmap(s_xla)(q2, l, u, st_j)
    x_t2, _ = solver(t32(q2), t32(l), t32(u), st_t)
    np.testing.assert_allclose(np_of(x_t2), np.asarray(x_j2), rtol=1e-4, atol=1e-4)


# ---------------- K2: path-DP transition-edge obstacle costs ----------------

def _obs_inputs(seed, B=16, K=8):
    """Obstacles spread over the DP window, some colliding with grid edges,
    some invalid slots carrying garbage (NaN) values."""
    rng = np.random.default_rng(seed)
    ps = rng.uniform(-5, 5, B).astype(np.float32)
    obs_s = (ps[:, None] + rng.uniform(-10, 100, (B, K))).astype(np.float32)
    obs_l = rng.choice([-7.5, -1.5, 0.0, 0.3, 1.5, 4.5, 8.0], (B, K)).astype(np.float32)
    obs_l += rng.normal(size=(B, K)).astype(np.float32) * 0.5
    valid = rng.uniform(size=(B, K)) < 0.7
    obs_s[~valid & (rng.uniform(size=(B, K)) < 0.5)] = np.nan
    return obs_s, obs_l, valid, ps


def test_k2_plain_matches_xla():
    obs_s, obs_l, valid, ps = _obs_inputs(0)
    a = np.asarray(jax.vmap(
        lambda s, l, v, p: j_path_dp._transition_obstacle_costs_xla(s, l, v, p, JC.path)
    )(obs_s, obs_l, valid, ps))
    before = t_path_dp.launches["path_obs_costs"]
    b = np_of(t_path_dp.transition_obstacle_costs(
        t32(obs_s), t32(obs_l), torch.as_tensor(valid), t32(ps), TC.path))
    assert t_path_dp.launches["path_obs_costs"] == before
    assert (a >= JC.path.w_collision).any() and ((a > 0) & (a < 1e6)).any()
    np.testing.assert_array_equal(b >= TC.path.w_collision, a >= JC.path.w_collision)
    # 1e-6 relative: XLA:CPU contracts multiply-adds into FMA, PyTorch does not
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)


def test_path_dp_matches_jax():
    obs_s, obs_l, valid, ps = _obs_inputs(2, B=12)
    obs_s = np.nan_to_num(obs_s)
    rng = np.random.default_rng(2)
    l0, dl0, ddl0 = (rng.normal(size=12).astype(np.float32) * s for s in (1.0, 0.1, 0.01))
    dj = jax.vmap(lambda *a: j_path_dp.path_dp(*a, JC.path))(obs_s, obs_l, valid, ps, l0, dl0, ddl0)
    dt = t_path_dp.path_dp(t32(obs_s), t32(obs_l), torch.as_tensor(valid), t32(ps),
                           t32(l0), t32(dl0), t32(ddl0), TC.path)
    np.testing.assert_allclose(np_of(dt[0]), np.asarray(dj[0]), atol=1e-5)
    np.testing.assert_array_equal(np_of(dt[1]), np.asarray(dj[1]))
    np.testing.assert_array_equal(np_of(dt[2]), np.asarray(dj[2]))
    ej = jax.vmap(lambda *a: j_path_dp.enrich_dp(*a, JC.path))(dj[0], dj[1], ps, l0, dl0, ddl0)
    et = t_path_dp.enrich_dp(dt[0], dt[1], t32(ps), t32(l0), t32(dl0), t32(ddl0), TC.path)
    for a, b in zip(ej, et):
        np.testing.assert_allclose(np_of(b), np.asarray(a), rtol=1e-6, atol=1e-5)


def _rand_psd(rng, n, cond=10.0):
    Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    return (Q * np.linspace(1.0, cond, n)) @ Q.T


def _general_qp(name):
    """``tests/test_qp.py``'s general-QP problems (its seed, 7), as float32
    (P, q, A, l, u, iters); P and q batched (B, ...) for "batch", the rest
    unbatched."""
    rng = np.random.default_rng(7)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    if name == "equality_only":
        n = 8
        return (f32(2 * np.eye(n)), f32(np.zeros(n)), f32(np.ones((1, n))),
                f32([1.0]), f32([1.0]), 200)
    if name == "mixed":
        n, m_in = 10, 6
        P = _rand_psd(rng, n)
        q = rng.normal(size=n)
        A_in = rng.normal(size=(m_in, n))
        b_in = rng.uniform(0.5, 2.0, size=m_in)
        A_eq = rng.normal(size=(2, n))
        b_eq = rng.normal(size=2) * 0.1
        return (f32(P), f32(q), f32(np.concatenate([A_in, A_eq])),
                f32(np.concatenate([np.full(m_in, -1e8), b_eq])),
                f32(np.concatenate([b_in, b_eq])), 500)
    n, B = 6, 32
    Ps = np.stack([_rand_psd(rng, n) for _ in range(B)])
    qs = rng.normal(size=(B, n))
    return f32(Ps), f32(qs), f32(np.eye(n)), f32(-np.ones(n)), f32(np.ones(n)), 150


@pytest.mark.parametrize("name", ["equality_only", "mixed", "batch"])
def test_solve_qp_and_kkt_residuals_match_jax(name):
    P, q, A, l, u, iters = _general_qp(name)
    if name == "batch":
        x_j = jax.vmap(lambda Pi, qi: j_qp.solve_qp(Pi, qi, A, l, u, iters=iters))(P, q)
        Pt, qt = torch.as_tensor(P), torch.as_tensor(q)
    else:
        x_j = j_qp.solve_qp(P, q, A, l, u, iters=iters)[None]
        Pt, qt = torch.as_tensor(P)[None], torch.as_tensor(q)[None]
    At, lt, ut = torch.as_tensor(A), torch.as_tensor(l), torch.as_tensor(u)
    x_t = t_qp.solve_qp(Pt, qt, At, lt, ut, iters=iters)
    assert x_t.shape == qt.shape
    np.testing.assert_allclose(np_of(x_t), np.asarray(x_j), rtol=0, atol=1e-4)
    prim_t, grad_t = t_qp.kkt_residuals(Pt, qt, At, lt, ut, x_t)
    for i in range(qt.shape[0]):
        prim_j, grad_j = j_qp.kkt_residuals(np_of(Pt[i]), np_of(qt[i]), A, l, u,
                                            np_of(x_t[i]))
        np.testing.assert_allclose(float(prim_t[i]), float(prim_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np_of(grad_t[i]), np.asarray(grad_j), rtol=1e-5,
                                   atol=1e-5)
    assert float(prim_t.max()) < 1e-3
