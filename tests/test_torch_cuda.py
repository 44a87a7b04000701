"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version (the tick kernel in every controller / plant instantiation and its
agent-traffic branch, the QP kernel warm and cold at both sites), and the
loops on the GPU against the CPU. Every test here needs
an NVIDIA GPU with nvcc and skips elsewhere. The file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from emplanner_carla_tpu_torch.config import EMConfig
from emplanner_carla_tpu_torch.ops import qp as t_qp
from emplanner_carla_tpu_torch.planner import em_planner, path_dp, path_qp
from emplanner_carla_tpu_torch.planner import speed_planner
from emplanner_carla_tpu_torch.sim import closed_loop, scenario
from emplanner_carla_tpu_torch.control import vehicle
from emplanner_carla_tpu_torch.ops import frenet
from emplanner_carla_tpu_torch.types import STSegments, tree_to
from emplanner_carla_tpu_torch.config import mpc_feedforward_variant
from torch_port_helpers import (  # noqa: F401
    assert_metrics_match, assert_qp_close, assert_tick_bar, assert_traffic_bar,
    assert_within_roundoff, column_depth_bar, cuda_device, first_lanes, np_of, t32,
    tensors_of, warm_ladder_f64,
)

CFG = EMConfig(loop=dataclasses.replace(EMConfig().loop, n_plans=2, plan_every=20))


def _variant(control=None, **plant):
    """CFG with the control fields replaced (``"ff"``: the feedforward MPC
    variant) and the plant fields given."""
    c = mpc_feedforward_variant(CFG.control) if control == "ff" else \
        dataclasses.replace(CFG.control, **(control or {}))
    return dataclasses.replace(CFG, control=c,
                               plant=dataclasses.replace(CFG.plant, **plant))


CONFIG4 = _variant(dict(kind="MPC"), kind="dynamic")
TICK_VARIANTS = {
    "mpc_dynamic": CONFIG4,
    "mpc_kinematic": _variant(dict(kind="MPC")),
    "lqr_dynamic": _variant(kind="dynamic"),
    "mpc_feedforward_dynamic_substeps2": _variant("ff", kind="dynamic", substeps=2),
}
TICK_FIELDS = closed_loop.TickMetrics._fields[:8]


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_card(cuda_device):
    n = 25
    rng = np.random.default_rng(7)
    B = 100  # not a multiple of the kernel's 32-lane tile
    solver, _, _ = path_qp._solver_for(n, 4.0, CFG.path)
    nv, m = solver.n, solver.m
    q = np.zeros((B, nv), np.float32)
    q[:, 0:3 * n:3] = -500.0 * rng.normal(size=(B, n))
    start = rng.normal(size=(B, 3)) * 0.5
    u = np.concatenate([np.zeros((B, 2 * (n - 1))), rng.uniform(0, 8, (B, 4 * n)),
                        start, np.zeros((B, 3)), np.full((B, n), 1e8)], 1)
    l = np.concatenate([np.zeros((B, 2 * (n - 1))), np.full((B, 4 * n), -1e8),
                        start, np.zeros((B, 3)), np.zeros((B, n))], 1)
    st = tuple(t32(rng.normal(size=(B, k)) * 0.1, cuda_device) for k in (nv, m, m))
    args = [t32(a, cuda_device) for a in (q, l, u)]
    x_k, st_k = t_qp.warm_admm_kernel(solver, *args, st)
    x_p, st_p = t_qp.warm_ladder_torch(solver, *args, st)
    torch.cuda.synchronize()
    assert_qp_close(np_of(x_k), [np_of(a) for a in st_k],
                    np_of(x_p), [np_of(a) for a in st_p])


def _path_qp_inputs(solver, B, rng, device, n=25):
    q = np.zeros((B, solver.n), np.float32)
    q[:, 0:3 * n:3] = -500.0 * rng.normal(size=(B, n))
    start = rng.normal(size=(B, 3)) * 0.5
    u = np.concatenate([np.zeros((B, 2 * (n - 1))), rng.uniform(0, 8, (B, 4 * n)),
                        start, np.zeros((B, 3)), np.full((B, n), 1e8)], 1)
    l = np.concatenate([np.zeros((B, 2 * (n - 1))), np.full((B, 4 * n), -1e8),
                        start, np.zeros((B, 3)), np.zeros((B, n))], 1)
    return [t32(a, device) for a in (q, l, u)]


@pytest.mark.cuda
def test_k1_warm_chain_on_card(cuda_device):
    """Three warm path-QP solves in a row, each from the state the previous
    one carried out (the kernel's own on the card, the plain version's on its
    side), with the bounds moving between solves as a replan moves them: the
    K1 bar after every solve."""
    rng = np.random.default_rng(3)
    B = 100
    solver = path_qp._solver_for(25, 4.0, CFG.path)[0]
    st_k = st_p = t_qp.warm_zero_state(solver.n, solver.m, B, cuda_device)
    for _ in range(3):
        q, l, u = _path_qp_inputs(solver, B, rng, cuda_device)
        x_k, st_k = t_qp.warm_admm_kernel(solver, q, l, u, st_k)
        x_p, st_p = t_qp.warm_ladder_torch(solver, q, l, u, st_p)
        torch.cuda.synchronize()
        assert_qp_close(np_of(x_k), [np_of(a) for a in st_k],
                        np_of(x_p), [np_of(a) for a in st_p])


@pytest.mark.cuda
def test_k1_nan_lane_on_card(cuda_device):
    """A NaN in one lane's q: that lane's x comes out all NaN from the kernel,
    as from the plain version, and the other lanes are as without it."""
    rng = np.random.default_rng(11)
    B = 100
    solver = path_qp._solver_for(25, 4.0, CFG.path)[0]
    q, l, u = _path_qp_inputs(solver, B, rng, cuda_device)
    zero = t_qp.warm_zero_state(solver.n, solver.m, B, cuda_device)
    q_nan = q.clone()
    q_nan[3, 5] = float("nan")
    x_k = t_qp.warm_admm_kernel(solver, q, l, u, zero)[0]
    x_kn = t_qp.warm_admm_kernel(solver, q_nan, l, u, zero)[0]
    x_pn = t_qp.warm_ladder_torch(solver, q_nan, l, u, zero)[0]
    torch.cuda.synchronize()
    assert bool(torch.isnan(x_pn[3]).all())
    assert bool(torch.isnan(x_kn[3]).all())
    others = torch.arange(B, device=cuda_device) != 3
    assert torch.equal(x_kn[others], x_k[others])


@pytest.mark.cuda
def test_k1_speed_site_nan_lane_on_card(cuda_device):
    """At the speed site (n 51, m 99), a NaN in one lane's q and a NaN in
    another lane's carried z: those lanes' x come out all NaN from the
    kernel, as from the plain version, and the other lanes are as without
    them."""
    B = 100
    sp = CFG.speed
    seg, v0 = _random_segments(B, 2, cuda_device, seed=4)
    dp = speed_planner._speed_dp_torch(seg, v0, sp)
    path_s = torch.arange(96, device=cuda_device, dtype=torch.float32)[None].expand(B, 96) * 2.0
    bounds = speed_planner.convex_space(dp, seg, path_s, torch.full((B, 96), 0.01,
                                                                     device=cuda_device), sp)
    q, l, u = speed_planner.speed_qp_problem(v0, torch.zeros(B, device=cuda_device),
                                             *bounds, sp)
    solver = speed_planner._speed_solver(sp)
    state = speed_planner.warm_state_init(sp, B, cuda_device)
    q_nan = q.clone()
    q_nan[3, 5] = float("nan")
    z_nan = state[1].clone()
    z_nan[40, 7] = float("nan")
    state_nan = (state[0], z_nan, state[2])
    x_k = t_qp.warm_admm_kernel(solver, q, l, u, state)[0]
    x_kn = t_qp.warm_admm_kernel(solver, q_nan, l, u, state_nan)[0]
    x_pn = t_qp.warm_ladder_torch(solver, q_nan, l, u, state_nan)[0]
    torch.cuda.synchronize()
    for lane in (3, 40):
        assert bool(torch.isnan(x_pn[lane]).all()), lane
        assert bool(torch.isnan(x_kn[lane]).all()), lane
    others = (torch.arange(B, device=cuda_device) != 3) & (torch.arange(B, device=cuda_device) != 40)
    assert torch.equal(x_kn[others], x_k[others])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33])
@pytest.mark.parametrize("site", ["path", "speed"])
def test_k1c_tile_edges_on_card(cuda_device, site, B):
    """The cold ladder with one lane and with one lane past a 32-lane tile:
    the lanes the last block computes on zeros are not stored, the others
    hold the site's K1 bar."""
    rng = np.random.default_rng(B)
    if site == "path":
        solver = path_qp._solver_for(25, 4.0, CFG.path, False)[0]
        q, l, u = _path_qp_inputs(solver, B, rng, cuda_device)
        atol = 1e-4
    else:
        sp = CFG.speed
        solver = speed_planner._speed_solver(sp, warm=False)
        seg, v0 = _random_segments(B, 2, cuda_device, seed=6)
        dp = speed_planner._speed_dp_torch(seg, v0, sp)
        path_s = torch.arange(96, device=cuda_device, dtype=torch.float32)[None].expand(B, 96) * 2.0
        bounds = speed_planner.convex_space(dp, seg, path_s,
                                            torch.full((B, 96), 0.01, device=cuda_device), sp)
        q, l, u = speed_planner.speed_qp_problem(v0, torch.zeros(B, device=cuda_device),
                                                 *bounds, sp)
        atol = 1e-3
    x_k = solver(q, l, u)
    zero = t_qp.warm_zero_state(solver.n, solver.m, B, cuda_device)
    x_p = t_qp.warm_ladder_torch(solver, q, l, u, zero)[0]
    torch.cuda.synchronize()
    assert x_k.shape == (B, solver.n)
    np.testing.assert_allclose(np_of(x_k), np_of(x_p), rtol=1e-4, atol=atol)


@pytest.mark.cuda
def test_k2_kernel_equals_plain_on_card(cuda_device):
    rng = np.random.default_rng(1)
    B, K = 300, 8
    ps = rng.uniform(-5, 5, B)
    obs_s = ps[:, None] + rng.uniform(-10, 100, (B, K))
    obs_l = rng.choice([-7.5, -1.5, 0.0, 0.3, 1.5, 4.5], (B, K)) + rng.normal(size=(B, K)) * 0.5
    valid = rng.uniform(size=(B, K)) < 0.7
    obs_s[~valid & (rng.uniform(size=(B, K)) < 0.5)] = np.nan
    args = (t32(obs_s, cuda_device), t32(obs_l, cuda_device),
            torch.as_tensor(valid, device=cuda_device), t32(ps, cuda_device))
    before = path_dp.launches["path_obs_costs"]
    a = path_dp.transition_obstacle_costs(*args, CFG.path)
    assert path_dp.launches["path_obs_costs"] == before + 1
    b = path_dp._transition_obstacle_costs_torch(*args, CFG.path)
    torch.cuda.synchronize()
    assert bool((a >= CFG.path.w_collision).any())
    assert torch.equal(a, b)  # bit for bit


@pytest.mark.cuda
def test_k2_nan_obstacle_on_a_valid_slot_on_card(cuda_device):
    """Valid slots whose station or lateral offset is NaN or infinite (a
    poisoned reading that reaches the DP): kernel and plain version agree
    bit for bit, and such a slot costs nothing, as if it were invalid."""
    rng = np.random.default_rng(2)
    B, K = 300, 8
    ps = rng.uniform(-5, 5, B)
    obs_s = ps[:, None] + rng.uniform(-10, 60, (B, K))
    obs_l = rng.choice([-1.5, 0.0, 0.3, 1.5], (B, K)) + rng.normal(size=(B, K)) * 0.5
    valid = np.ones((B, K), bool)
    bad = np.zeros((B, K), bool)
    obs_s[::3, 0] = np.nan
    obs_l[1::3, 1] = np.nan
    obs_l[2::3, 2] = np.inf
    obs_s[2::6, 3] = -np.inf
    bad[::3, 0] = bad[1::3, 1] = bad[2::3, 2] = bad[2::6, 3] = True
    dev = cuda_device
    args = (t32(obs_s, dev), t32(obs_l, dev), torch.as_tensor(valid, device=dev), t32(ps, dev))
    a = path_dp.transition_obstacle_costs(*args, CFG.path)
    b = path_dp._transition_obstacle_costs_torch(*args, CFG.path)
    masked = path_dp.transition_obstacle_costs(
        t32(np.where(bad, 0.0, obs_s), dev), t32(np.where(bad, 0.0, obs_l), dev),
        torch.as_tensor(valid & ~bad, device=dev), t32(ps, dev), CFG.path)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(a).all()) and bool((a >= CFG.path.w_collision).any())
    assert torch.equal(a, b)  # bit for bit
    assert torch.equal(a, masked)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_edge_samples,safe_dist", [(12, 10, 6.0), (3, 7, 6.0),
                                                         (12, 10, 3.0)])
def test_k2_all_slots_valid_at_the_window_edges_on_card(cuda_device, rows, n_edge_samples,
                                                        safe_dist):
    """All 8 obstacle slots valid, placed so that their candidate edges fall
    on and just beside the DP window's edges (the first and last transition
    columns, the floor boundaries of (r + safe) / h and the n_lo bound), at
    lateral offsets across the rows: bit for bit against the plain version,
    at the main path's 12 rows and 10 samples, at 3 rows and 7 samples (the
    kernel's instantiation for any sample count, 5 lanes a warp) and with a
    safe distance below the danger distance (an empty band)."""
    pc = dataclasses.replace(CFG.path, rows=rows, n_edge_samples=n_edge_samples,
                             safe_dist=safe_dist)
    h, safe = float(pc.sample_s), float(pc.safe_dist)
    span = h * (pc.n_edge_samples - 1) / pc.n_edge_samples
    rng = np.random.default_rng(3)
    B, K = 257, 8
    ps = rng.uniform(-5, 5, B)
    edges = np.array([h - safe, 2 * h - safe, (pc.cols - 1) * h - safe,
                      pc.cols * h - safe, safe + span, h + safe + span,
                      (pc.cols - 1) * h + safe + span, 0.0])
    jitter = rng.choice([-1e-3, 0.0, 1e-3], (B, K)) * rng.uniform(0.5, 1, (B, K))
    obs_s = ps[:, None] + edges[None, :] + jitter
    obs_l = rng.uniform(-9, 9, (B, K))
    valid = np.ones((B, K), bool)
    args = (t32(obs_s, cuda_device), t32(obs_l, cuda_device),
            torch.as_tensor(valid, device=cuda_device), t32(ps, cuda_device))
    a = path_dp.transition_obstacle_costs(*args, pc)
    b = path_dp._transition_obstacle_costs_torch(*args, pc)
    torch.cuda.synchronize()
    assert bool((a > 0).any()) and bool((a >= pc.w_collision).any())
    assert torch.equal(a, b)  # bit for bit


def _tick_args(device, cfg=CFG, B=64, displace=False):
    """One cycle's tick inputs from the port's own first plan cycle, with
    a bad plan, an arrived lane and a destination within reach; with
    ``displace`` the egos start up to 2.5 m and 0.4 rad off the target, so
    that the MPC saturates in the first ticks."""
    sc = scenario.batch_scenarios(2, B, CFG, device=device, n_path=96)
    gp = sc.global_path
    carry = closed_loop.LoopCarry(
        sc.ego0, vehicle.ControllerState.init(CFG.control, B, device),
        frenet.nearest_index(sc.ego0.x, sc.ego0.y, gp), sc.obstacles,
        torch.zeros(B, dtype=torch.bool, device=device),
        em_planner.warm_init(CFG, B, device),
    )
    res = em_planner.plan_path_cycle(gp, sc.ego0, sc.obstacles, carry.match_index,
                                     CFG, qp_warm=carry.qp_warm[0])
    v, tq = closed_loop._constant_profile(CFG)
    plan_ok = torch.ones(B, dtype=torch.bool, device=device)
    plan_ok[1] = False
    arrived = torch.zeros(B, dtype=torch.bool, device=device)
    arrived[2] = True
    dest_x = gp.x[:, -1].clone()
    dest_y = gp.y[:, -1].clone()
    dest_x[3] = sc.ego0.x[3] + 2.5
    dest_y[3] = sc.ego0.y[3]
    cs = carry.ctrl.rebind()
    ego = sc.ego0
    if displace:
        off = torch.linspace(-2.5, 2.5, B, device=device)
        ego = ego._replace(x=ego.x - off * torch.sin(ego.phi),
                           y=ego.y + off * torch.cos(ego.phi),
                           phi=ego.phi + 0.4 * torch.sin(7.0 * off))
    return (ego, cs.pid.buffer, cs.pid.count, cs.pid.last_error, sc.obstacles,
            torch.full((B, tq.shape[0]), float(v), device=device),
            torch.as_tensor(tq, device=device), closed_loop._sanitize(res.target),
            arrived, res.feasible, plan_ok, dest_x, dest_y, cfg)


@pytest.mark.cuda
def test_k3_kernel_matches_plain_on_card(cuda_device):
    args = _tick_args(cuda_device)
    out_k = closed_loop.run_ticks_kernel(*args)
    out_p = closed_loop._full_ticks_base(*args)
    torch.cuda.synchronize()
    mk = closed_loop.TickMetrics(*out_k[6], None)
    mp = closed_loop.TickMetrics(*[np_of(a) for a in out_p[6]], None)
    assert_metrics_match(mk, mp, TICK_FIELDS, "kernel.")
    assert bool(out_k[6][6][3].any()) and not bool(out_k[6][7][1].any())
    assert torch.equal(out_k[2], out_p[2])
    np.testing.assert_allclose(np_of(out_k[1]), np_of(out_p[1]), atol=5e-3)


@pytest.mark.cuda
def test_simulate_on_card_matches_cpu(cuda_device):
    sc = scenario.batch_scenarios(5, 16, CFG, device="cpu", n_path=96)
    counts = (t_qp.launches["qp_admm_warm"], path_dp.launches["path_obs_costs"],
              closed_loop.launches["tick_lqr"])
    _, m_gpu = closed_loop.simulate(*sc, CFG, device=cuda_device)
    after = (t_qp.launches["qp_admm_warm"], path_dp.launches["path_obs_costs"],
             closed_loop.launches["tick_lqr"])
    assert [b - a for a, b in zip(counts, after)] == [CFG.loop.n_plans] * 3
    _, m_cpu = closed_loop.simulate(*sc, CFG, device="cpu")
    m_cpu_np = closed_loop.TickMetrics(*[np_of(a) for a in m_cpu])
    assert_metrics_match(tree_to(m_gpu, "cpu"), m_cpu_np,
                         closed_loop.TickMetrics._fields, "simulate.")


def _random_segments(B, K, device, seed=3):
    rng = np.random.default_rng(seed)
    s_in = rng.uniform(5, 40, (B, K))
    t_in = rng.uniform(0, 4, (B, K))
    seg = STSegments(
        t32(s_in, device), t32(s_in + rng.uniform(1, 10, (B, K)), device),
        t32(t_in, device), t32(t_in + rng.uniform(0.3, 3, (B, K)), device),
        torch.as_tensor(rng.uniform(size=(B, K)) < 0.6, device=device),
    )
    return seg, t32(rng.uniform(3, 14, B), device)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 4])
def test_k4_kernel_equals_plain_on_card(cuda_device, K):
    B = 203  # any batch: the kernel holds one lane a block
    seg, v0 = _random_segments(B, K, cuda_device)
    sp = CFG.speed
    before = speed_planner.launches["speed_dp"]
    out_k = speed_planner.speed_dp(seg, v0, sp)
    assert speed_planner.launches["speed_dp"] == before + 1
    out_p = speed_planner._speed_dp_torch(seg, v0, sp)
    torch.cuda.synchronize()
    assert torch.equal(out_k.end_index, out_p.end_index.to(torch.int32))
    assert torch.equal(out_k.valid, out_p.valid)
    assert torch.equal(out_k.s, out_p.s)
    ends = out_k.end_index
    assert bool((ends < sp.n_t - 1).any()) and bool((ends == sp.n_t - 1).any())


def _assert_dp_equal(out_k, out_p):
    assert torch.equal(out_k.end_index, out_p.end_index.to(torch.int32))
    assert torch.equal(out_k.valid, out_p.valid)
    assert torch.equal(out_k.s, out_p.s)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4097])
def test_k4_kernel_any_batch_on_card(cuda_device, B):
    """One lane alone and a batch of 4096 + 1 lanes: the lanes of the larger
    batch give the bits of the same lanes run as a batch of 203."""
    seg, v0 = _random_segments(B, 2, cuda_device, seed=11)
    out_k = speed_planner.speed_dp(seg, v0, CFG.speed)
    _assert_dp_equal(out_k, speed_planner._speed_dp_torch(seg, v0, CFG.speed))
    n = min(B, 203)
    sub = STSegments(*(a[:n].contiguous() for a in seg))
    out_n = speed_planner.speed_dp(sub, v0[:n].contiguous(), CFG.speed)
    torch.cuda.synchronize()
    assert torch.equal(out_n.s, out_k.s[:n]) and torch.equal(out_n.end_index, out_k.end_index[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [False, True])
def test_k4_ties_go_to_the_lowest_predecessor_on_card(cuda_device, blocked):
    """Without reference-speed and acceleration weights every forward edge of
    an obstacle-free column costs the same, so each station's totals tie
    across every slice of its thread group: the first minimum, the lowest
    predecessor, must win (k = 0, or with a segment standing on the first
    stations, the lowest station past its window), as in the plain version."""
    sp = dataclasses.replace(CFG.speed, w_ref_speed=0.0, w_accel=0.0)
    B = 64
    rng = np.random.default_rng(5)
    if blocked:
        s_in = np.zeros((B, 2))
        s_out = s_in + rng.uniform(0.0, 0.5, (B, 2))
        t_in, t_out = np.zeros((B, 2)), np.full((B, 2), 8.0)
        valid = np.tile([True, False], (B, 1))
    else:
        s_in = s_out = t_in = t_out = np.zeros((B, 2))
        valid = np.zeros((B, 2), bool)
    seg = STSegments(*(t32(a, cuda_device) for a in (s_in, s_out, t_in, t_out)),
                     torch.as_tensor(valid, device=cuda_device))
    v0 = t32(rng.uniform(3, 14, B), cuda_device)
    out_k = speed_planner.speed_dp(seg, v0, sp)
    out_p = speed_planner._speed_dp_torch(seg, v0, sp)
    torch.cuda.synchronize()
    _assert_dp_equal(out_k, out_p)
    s = out_k.s[:, :-1]
    if blocked:
        # the lowest station past the segment's window, in a later slice than
        # the stations that tie with it
        assert bool((s > 2.0).all()) and bool((s == s[:, :1]).all())
    else:
        # station 0 in every column, then the s_max row's tie at the last
        assert bool((s == 0.0).all()) and bool((out_k.s[:, -1] == sp.s_grid[-1]).all())


@pytest.mark.cuda
def test_k4_nan_and_inf_lanes_on_card(cuda_device):
    """Lanes whose plan-start speed is NaN (every total NaN: k 0 stays) or
    +-inf (every total +inf: the lowest k), and lanes with a NaN, an infinite
    or a point segment, against the plain version."""
    seg, v0 = _random_segments(64, 2, cuda_device, seed=7)
    v0 = v0.clone()
    v0[::4] = float("nan")
    v0[1::4] = float("inf")
    v0[2::4] = -float("inf")
    seg = STSegments(*(a.clone() for a in seg))
    seg.s_in[3::8, 0] = float("nan")
    seg.t_out[5::8, 1] = float("inf")
    seg.s_out[7::8, 0] = seg.s_in[7::8, 0]
    seg.t_out[7::8, 0] = seg.t_in[7::8, 0]
    seg.valid[3::8, 0] = seg.valid[5::8, 1] = seg.valid[7::8, 0] = True
    out_k = speed_planner.speed_dp(seg, v0, CFG.speed)
    out_p = speed_planner._speed_dp_torch(seg, v0, CFG.speed)
    torch.cuda.synchronize()
    _assert_dp_equal(out_k, out_p)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 4])
def test_k4_nan_segment_times_on_card(cuda_device, K):
    """Valid segments whose entry or exit time is NaN (the pure-time gap of
    the live mask is then NaN, torch.maximum's, and the segment is live in
    no column) or whose station is NaN: kernel and plain version agree bit
    for bit, on the fixed instantiation (K 2) and the generic one (K 4)."""
    seg, v0 = _random_segments(96, K, cuda_device, seed=9)
    seg = STSegments(*(a.clone() for a in seg))
    seg.t_in[::4, 0] = float("nan")
    seg.t_out[1::4, 1] = float("nan")
    seg.s_out[2::4, 0] = float("nan")
    seg.valid[::4, 0] = seg.valid[1::4, 1] = seg.valid[2::4, 0] = True
    out_k = speed_planner.speed_dp(seg, v0, CFG.speed)
    out_p = speed_planner._speed_dp_torch(seg, v0, CFG.speed)
    torch.cuda.synchronize()
    _assert_dp_equal(out_k, out_p)


_ARGMIN_SRC = r"""
#include "{src}"
// each block: one case of n totals, one thread group of the speed-DP
// kernel's width running its first-minimum step and group combine
__global__ void cases(const float* totals, int n, float* v, int* k) {
  const int t = threadIdx.x;
  float best = INFINITY;
  int bk = NO_K;
  for (int i = 0; t + G * i < n; ++i)
    first_min_step(totals[blockIdx.x * n + t + G * i], t + G * i, i == 0 && t == 0, best, bk);
  group_argmin(best, bk, G);
  if (t == 0) { v[blockIdx.x] = best; k[blockIdx.x] = bk; }
}
extern "C" int first_minima(const float* totals, int n_cases, int n, float* v, int* k) {
  cases<<<n_cases, G>>>(totals, n, v, k);
  return (int)cudaDeviceSynchronize();
}
"""


def _serial_first_min(row):
    """The plain rule over ascending k: take k if k == 0 or total < best."""
    best, bk = row[0], 0
    for k in range(1, len(row)):
        if row[k] < best:
            best, bk = row[k], k
    return best, bk


@pytest.mark.cuda
def test_k4_group_first_minimum_equals_the_serial_rule_on_card(cuda_device, tmp_path):
    """The speed-DP kernel's per-thread first-minimum step and its group
    combine (built from csrc/speed_dp.cu with its flags) against the serial
    rule, on 40 totals a case: ties across and within slices, NaN at k = 0
    (it stays) and at k > 0 (never taken), +inf and -0 / +0."""
    import ctypes
    import subprocess

    from emplanner_carla_tpu_torch import cuda as kbuild

    rng = np.random.default_rng(13)
    n, rows = 40, []
    for _ in range(4000):
        row = rng.choice([0.0, 1.0, 2.0, 3.0, 4.0], n).astype(np.float32)
        kind = rng.integers(0, 6)
        if kind == 1:
            row[0] = np.nan
        elif kind == 2:
            row[rng.integers(1, n, 3)] = np.nan
        elif kind == 3:
            row[:] = np.inf
            row[rng.integers(0, n, 2)] = rng.choice([np.inf, 5.0], 2)
        elif kind == 4:
            row[rng.integers(0, n, 5)] = -0.0
        elif kind == 5:
            row[0] = np.nan
            row[rng.integers(1, n, 3)] = -1.0
        rows.append(row)
    totals = np.stack(rows)
    src, lib = tmp_path / "argmin.cu", tmp_path / "libargmin.so"
    src.write_text(_ARGMIN_SRC.replace("{src}", str(kbuild.CSRC / "speed_dp.cu")))
    subprocess.run([kbuild._nvcc(), *kbuild._BASE_FLAGS, *kbuild.SOURCES["speed_dp"][1],
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).first_minima
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    t = torch.as_tensor(totals, device=cuda_device)
    v = torch.empty(len(rows), device=cuda_device)
    k = torch.empty(len(rows), dtype=torch.int32, device=cuda_device)
    assert fn(t.data_ptr(), len(rows), n, v.data_ptr(), k.data_ptr()) == 0
    want = [_serial_first_min(r) for r in rows]
    np.testing.assert_array_equal(np_of(k), [w[1] for w in want])
    got_v = np_of(v)
    want_v = np.array([w[0] for w in want], np.float32)
    assert np.array_equal(got_v.view(np.uint32), want_v.view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("K,n_edge_samples,n_t,t_step", [
    (1, 2, 16, 0.5), (1, 10, 16, 0.5), (8, 2, 16, 0.5), (8, 7, 16, 0.5),
    (2, 5, 2, 0.5), (2, 5, 32, 0.25), (2, 5, 16, 0.3), (4, 5, 16, 0.3)])
def test_k4_generic_instantiation_at_the_limits_on_card(cuda_device, K, n_edge_samples,
                                                         n_t, t_step):
    """Shapes at the edges of ``check_dp_kernel_limits`` (1 and 8 segment
    slots, 0 and 8 interior samples, 2 and 32 columns; 8 slots take at most
    5 interior samples at 40 stations) and the main shapes with an inexact
    1 / t_step (0.3: the IEEE division) run the kernel's generic
    instantiation; bit for bit against the plain version."""
    sp = dataclasses.replace(CFG.speed, n_edge_samples=n_edge_samples, n_t=n_t,
                             t_step=t_step)
    speed_planner.check_dp_kernel_limits(K, sp)
    assert speed_planner._exact_reciprocal(t_step) == (t_step != 0.3)
    seg, v0 = _random_segments(97, K, cuda_device, seed=17)
    out_k = speed_planner.speed_dp(seg, v0, sp)
    out_p = speed_planner._speed_dp_torch(seg, v0, sp)
    torch.cuda.synchronize()
    _assert_dp_equal(out_k, out_p)


@pytest.mark.cuda
def test_k1_speed_site_kernel_matches_plain_on_card(cuda_device):
    """K1 at n 51, m 99 (the speed QP) on bounds from the convex space of
    random segments: x, x_s and z at the speed site's bar (atol 1e-3, as
    ``chip_smoke.py`` holds it) and no farther from the exact (float64)
    ladder than twice the plain float32 ladder's own round-off, on the card
    and on the CPU; the equality rows' dual is held by the next solve."""
    B = 100
    sp = CFG.speed
    seg, v0 = _random_segments(B, 2, cuda_device, seed=4)
    dp = speed_planner._speed_dp_torch(seg, v0, sp)
    path_s = torch.arange(96, device=cuda_device, dtype=torch.float32)[None].expand(B, 96) * 2.0
    kappa = torch.full((B, 96), 0.01, device=cuda_device)
    bounds = speed_planner.convex_space(dp, seg, path_s, kappa, sp)
    a0 = torch.zeros(B, device=cuda_device)
    solver = speed_planner._speed_solver(sp)
    assert (solver.n, solver.m) == (51, 99)
    state = speed_planner.warm_state_init(sp, B, cuda_device)
    before = t_qp.launches["qp_admm_speed"]
    speed_planner.speed_qp(v0, a0, *bounds, sp, warm_state=state)
    assert t_qp.launches["qp_admm_speed"] == before + 1
    q, l, u = speed_planner.speed_qp_problem(v0, a0, *bounds, sp)
    x_p, st_p = t_qp.warm_ladder_torch(solver, q, l, u, state)
    xk, stk = t_qp.warm_admm_kernel(solver, q, l, u, state)
    torch.cuda.synchronize()
    eq = speed_planner._speed_qp_constants(sp)[2]
    assert_qp_close(np_of(xk), [np_of(a) for a in stk], np_of(x_p),
                    [np_of(a) for a in st_p], atol=1e-3, y_rows=~eq)
    # at atol 1e-4 this input sits at float32's round-off, which the rho
    # ladder amplifies: the plain ladder on the card is itself more than 1e-4
    # from the exact result, and the plain ladder on the CPU more than 1e-4
    # from the card's; the kernel is held to that round-off instead
    cpu = t_qp.warm_ladder_torch(solver, q.cpu(), l.cpu(), u.cpu(),
                                 tuple(a.cpu() for a in state))
    assert_within_roundoff((xk, stk), [(x_p, st_p), cpu],
                           warm_ladder_f64(solver, q, l, u, state))
    xk2, stk2 = t_qp.warm_admm_kernel(solver, q, l, u, stk)
    xp2, stp2 = t_qp.warm_ladder_torch(solver, q, l, u, st_p)
    torch.cuda.synchronize()
    # the functional bar of the JAX package's own warm-state test
    # (tests/test_qp_pallas.py): the next solve agrees within 5e-3
    assert_qp_close(np_of(xk2), [np_of(a) for a in stk2], np_of(xp2),
                    [np_of(a) for a in stp2], atol=5e-3, y_rows=~eq)


@pytest.mark.cuda
def test_k3l_kernel_matches_plain_on_card(cuda_device):
    """The tick kernel's lights branch: red, green and switching lanes."""
    args = _tick_args(cuda_device)
    B = args[0].x.shape[0]
    offsets = torch.linspace(0.0, 12.0, B + 1, device=cuda_device)[:B, None].expand(B, 2)
    lights = scenario.lights_on_path(args[7], (11.0, 41.0), period=12.0,
                                     green_frac=0.5, offsets=offsets,
                                     device=cuda_device)
    t0 = torch.full((B,), 2.0, device=cuda_device)
    out_k = closed_loop.run_ticks_kernel(*args, lights=lights, t0=t0)
    out_p = closed_loop._full_ticks_base(*args, lights=lights, t0=t0)
    torch.cuda.synchronize()
    mk = closed_loop.TickMetrics(*out_k[6], None)
    mp = closed_loop.TickMetrics(*[np_of(a) for a in out_p[6]], None)
    assert_metrics_match(mk, mp, TICK_FIELDS, "kernel+lights.")
    free = closed_loop.run_ticks_kernel(*args)
    slower = out_k[6][2][:, -1] < free[6][2][:, -1] - 1.0
    assert bool(slower.any()) and not bool(slower.all())
    # with no valid light the lights branch reproduces the lights-free loop
    none = closed_loop.run_ticks_kernel(
        *args, lights=closed_loop.traffic_light.TrafficLights.none(B, 2, cuda_device),
        t0=t0)
    for a, b in zip(none[6], free[6]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_simulate_full_on_card_matches_cpu(cuda_device):
    sc = scenario.batch_scenarios(5, 16, CFG, device="cpu", n_path=96)
    lights = scenario.lights_on_path(sc.global_path, (11.0, 41.0), period=12.0,
                                     offsets=torch.linspace(0, 11, 16)[:, None].expand(16, 2),
                                     device="cpu")
    for tl in (None, lights):
        before = dict(t_qp.launches), speed_planner.launches["speed_dp"]
        _, m_gpu = closed_loop.simulate_full(*sc, CFG, lights=tl, device=cuda_device)
        n = CFG.loop.n_plans
        assert t_qp.launches["qp_admm_warm"] - before[0]["qp_admm_warm"] == n
        assert t_qp.launches["qp_admm_speed"] - before[0]["qp_admm_speed"] == n
        assert speed_planner.launches["speed_dp"] - before[1] == n
        _, m_cpu = closed_loop.simulate_full(*sc, CFG, lights=tl, device="cpu")
        m_cpu_np = closed_loop.TickMetrics(*[np_of(a) for a in m_cpu])
        assert_metrics_match(tree_to(m_gpu, "cpu"), m_cpu_np,
                             closed_loop.TickMetrics._fields, "simulate_full.")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TICK_VARIANTS))
def test_k5_k6_kernel_matches_plain_on_card(cuda_device, name):
    """The tick kernel's other instantiations (K5: MPC, K6: dynamic plant,
    with sub-steps and the raw heading error) at 128 lanes against the plain
    loop, at the JAX package's kernel-vs-scan bar."""
    cfg = TICK_VARIANTS[name]
    args = _tick_args(cuda_device, cfg, B=128, displace=True)
    key = closed_loop.tick_kernel_name(cfg)
    assert key != "tick_lqr"
    before = closed_loop.launches[key]
    out_k = closed_loop.run_ticks_kernel(*args)
    assert closed_loop.launches[key] == before + 1
    out_p = closed_loop._full_ticks_base(*args)
    torch.cuda.synchronize()
    assert_tick_bar(out_k, out_p)
    if cfg.control.kind == "MPC":
        mk, mp = out_k[7], out_p[7]
        assert int(mk.admm_ticks.sum()) > 0
        assert abs(int(mk.admm_ticks.sum()) - int(mp.admm_ticks.sum())) <= 2
        np.testing.assert_allclose(np_of(mk.z), np_of(mp.z), rtol=1e-3, atol=1e-3)
    else:
        assert out_k[7] is None and out_p[7] is None


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["path", "speed"])
def test_k1c_kernel_matches_plain_on_card(cuda_device, site):
    """The cold QP (K1c): the QP kernel from the zero state with the cold
    count against the plain ladder from zeros, at the K1 bar of the site."""
    B = 100
    rng = np.random.default_rng(11)
    if site == "path":
        n = 25
        solver = path_qp._solver_for(n, 4.0, CFG.path, False)[0]
        q = np.zeros((B, solver.n), np.float32)
        q[:, 0:3 * n:3] = -500.0 * rng.normal(size=(B, n))
        start = rng.normal(size=(B, 3)) * 0.5
        u = np.concatenate([np.zeros((B, 2 * (n - 1))), rng.uniform(0, 8, (B, 4 * n)),
                            start, np.zeros((B, 3)), np.full((B, n), 1e8)], 1)
        l = np.concatenate([np.zeros((B, 2 * (n - 1))), np.full((B, 4 * n), -1e8),
                            start, np.zeros((B, 3)), np.zeros((B, n))], 1)
        q, l, u = (t32(a, cuda_device) for a in (q, l, u))
        atol = 1e-4
    else:
        sp = CFG.speed
        solver = speed_planner._speed_solver(sp, warm=False)
        seg, v0 = _random_segments(B, 2, cuda_device, seed=6)
        dp = speed_planner._speed_dp_torch(seg, v0, sp)
        path_s = torch.arange(96, device=cuda_device, dtype=torch.float32)[None].expand(B, 96) * 2.0
        bounds = speed_planner.convex_space(dp, seg, path_s,
                                            torch.full((B, 96), 0.01, device=cuda_device), sp)
        q, l, u = speed_planner.speed_qp_problem(v0, torch.zeros(B, device=cuda_device),
                                                 *bounds, sp)
        atol = 1e-3
    assert solver.iters == 80 and not solver.warm
    before = t_qp.launches[solver.name]
    x_k = solver(q, l, u)
    assert t_qp.launches[solver.name] == before + 1
    zero = t_qp.warm_zero_state(solver.n, solver.m, B, cuda_device)
    x_p = t_qp.warm_ladder_torch(solver, q, l, u, zero)[0]
    torch.cuda.synchronize()
    np.testing.assert_allclose(np_of(x_k), np_of(x_p), rtol=1e-4, atol=atol)


@pytest.mark.cuda
def test_simulate_full_config4_on_card_matches_cpu(cuda_device):
    sc = scenario.batch_scenarios(5, 16, CONFIG4, device="cpu", n_path=96)
    before = closed_loop.launches["tick_mpc_dynamic"]
    _, m_gpu = closed_loop.simulate_full(*sc, CONFIG4, device=cuda_device)
    assert closed_loop.launches["tick_mpc_dynamic"] - before == CONFIG4.loop.n_plans
    _, m_cpu = closed_loop.simulate_full(*sc, CONFIG4, device="cpu")
    m_cpu_np = closed_loop.TickMetrics(*[np_of(a) for a in m_cpu])
    assert_metrics_match(tree_to(m_gpu, "cpu"), m_cpu_np,
                         closed_loop.TickMetrics._fields, "config4.")


def _traffic_args(device, cfg=CFG, B=96):
    """One agent-traffic cycle's tick inputs from the port's own first full
    EM plan on the bench mix with its walker: odd lanes start with their
    agent mid lane change, and every third lane's walker slot becomes a
    second agent 12 m behind the first and 30 % faster (two agents in one
    lane, which shows a non-simultaneous update). Returns (args, kw) of
    ``run_traffic_ticks_kernel`` without lights."""
    sc = scenario.batch_scenarios(3, B, CFG, device=device, n_path=96, with_walker=True)
    gp, obs = sc.global_path, sc.obstacles
    K, d0 = obs.x.shape[1], CFG.n_static_obs
    two = torch.arange(B, device=device) % 3 == 0
    x, y, vx, vy = (a.clone() for a in (obs.x, obs.y, obs.vx, obs.vy))
    head = torch.atan2(obs.vy[:, d0], obs.vx[:, d0])
    x[two, d0 + 1] = (obs.x[:, d0] - 12.0 * torch.cos(head))[two]
    y[two, d0 + 1] = (obs.y[:, d0] - 12.0 * torch.sin(head))[two]
    vx[two, d0 + 1] = 1.3 * obs.vx[two, d0]
    vy[two, d0 + 1] = 1.3 * obs.vy[two, d0]
    obs = obs._replace(x=x, y=y, vx=vx, vy=vy)
    mi = frenet.nearest_index(sc.ego0.x, sc.ego0.y, gp)
    res = em_planner.plan_full_cycle(gp, sc.ego0, obs, mi, CFG,
                                     qp_warm=em_planner.warm_init(CFG, B, device, full=True))
    agent = (torch.arange(K, device=device) >= d0) & (torch.hypot(obs.vx, obs.vy) > 2.5)
    mid = (torch.arange(B, device=device) % 2 == 1)[:, None] & agent
    lane_tgt = torch.where(mid, 3.5, 0.0)
    lane_off = torch.where(mid, torch.linspace(0.2, 3.3, B, device=device)[:, None], 0.0)
    cs = vehicle.ControllerState.init(CFG.control, B, device)
    traffic = closed_loop.TrafficInputs(gp, frenet.nearest_index(obs.x, obs.y, gp), lane_off,
                                        lane_tgt, agent, "normal")
    args = (sc.ego0, cs.pid.buffer, cs.pid.count, cs.pid.last_error, obs,
            torch.nan_to_num(res.trajectory.speed).contiguous(),
            torch.nan_to_num(res.trajectory.time[0]).contiguous(),
            closed_loop._sanitize(res.path.target), torch.zeros(B, dtype=torch.bool, device=device),
            res.path.feasible, torch.ones(B, dtype=torch.bool, device=device),
            gp.x[:, -1].contiguous(), gp.y[:, -1].contiguous(), cfg)
    return args, {"traffic": traffic}


TRAFFIC_VARIANTS = {
    "lqr_kinematic": (CFG, False), "lqr_kinematic_lights": (CFG, True),
    "mpc_dynamic": (CONFIG4, False), "mpc_kinematic": (TICK_VARIANTS["mpc_kinematic"], True),
    "lqr_dynamic": (TICK_VARIANTS["lqr_dynamic"], False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TRAFFIC_VARIANTS))
def test_k7_kernel_matches_plain_on_card(cuda_device, name):
    """The tick kernel's agent-traffic branch (K7) against its plain loop,
    every controller / plant pair, with and without lights."""
    cfg, with_lights = TRAFFIC_VARIANTS[name]
    args, kw = _traffic_args(cuda_device, cfg)
    args = args[:-1] + (cfg,)
    B = args[0].x.shape[0]
    if with_lights:
        kw["lights"] = scenario.lights_on_path(
            kw["traffic"].global_path, (25.0, 51.0), period=12.0, green_frac=0.5,
            offsets=torch.linspace(0.0, 12.0, B + 1, device=cuda_device)[:B, None].expand(B, 2),
            device=cuda_device)
        kw["t0"] = torch.full((B,), 2.0, device=cuda_device)
    key = closed_loop.tick_kernel_name(cfg, kw.get("lights"), traffic=True)
    before = closed_loop.launches[key]
    out_k = closed_loop.run_traffic_ticks(*args, **kw)
    assert closed_loop.launches[key] == before + 1
    out_p = closed_loop._traffic_ticks_base(*args, **kw)
    torch.cuda.synchronize()
    assert_traffic_bar(out_k, out_p)
    assert bool((out_k[8] != kw["traffic"].npc_idx).any())
    assert bool((out_k[10] != kw["traffic"].lane_tgt).any())


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
def test_simulate_traffic_on_card_matches_cpu(cuda_device, full):
    sc = scenario.batch_scenarios(5, 16, CFG, device="cpu", n_path=96, with_walker=True)
    lights = scenario.lights_on_path(sc.global_path, (25.0, 51.0), period=12.0,
                                     offsets=torch.linspace(0, 11, 16)[:, None].expand(16, 2),
                                     device="cpu") if full else None
    key = "tick_traffic_lights" if full else "tick_traffic"
    before = closed_loop.launches[key]
    c_gpu, m_gpu = closed_loop.simulate_traffic(*sc, CFG, full=full, lights=lights,
                                                device=cuda_device)
    assert closed_loop.launches[key] - before == CFG.loop.n_plans
    c_cpu, m_cpu = closed_loop.simulate_traffic(*sc, CFG, full=full, lights=lights,
                                                device="cpu")
    m_cpu_np = closed_loop.TickMetrics(*[np_of(a) for a in m_cpu])
    assert_metrics_match(tree_to(m_gpu, "cpu"), m_cpu_np,
                         closed_loop.TickMetrics._fields, "traffic.")
    assert torch.equal(c_gpu.npc_path_index.cpu(), c_cpu.npc_path_index)
    assert torch.equal(c_gpu.npc_lane.target.cpu(), c_cpu.npc_lane.target)


def _tick_case(kind, device, cfg=CFG, B=64):
    """(wrapper, plain loop, args, kw) of one tick-loop cycle: the
    constant-velocity obstacles' (``_tick_args``) or the agents'
    (``_traffic_args``), under ``cfg``."""
    if kind == "ticks":
        return (closed_loop.run_ticks_kernel, closed_loop._full_ticks_base,
                _tick_args(device, cfg, B=B), {})
    args, kw = _traffic_args(device, cfg, B=B)
    return (closed_loop.run_traffic_ticks_kernel, closed_loop._traffic_ticks_base,
            args[:-1] + (cfg,), kw)


def _pairs(path, turn=0.0):
    """The path with its nodes in identical (x, y) pairs (2m, 2m + 1), node
    2m + 1's heading turned by ``turn``: every nearest-node query ties."""
    n = path.x.shape[1]
    even = (torch.arange(n, device=path.x.device) // 2) * 2
    odd = (torch.arange(n, device=path.x.device) % 2).to(path.theta.dtype)
    return path._replace(x=path.x[:, even].contiguous(), y=path.y[:, even].contiguous(),
                         theta=(path.theta + turn * odd).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ticks", "traffic"])
def test_tick_matches_break_exact_ties_to_the_lowest_index_on_card(cuda_device, kind):
    """Exact ties in both first-minimum matches: a target path whose nodes
    come in identical (x, y) pairs, the odd node of each pair turned by 0.3
    rad (a match that took it would steer and measure otherwise), and, with
    agents, a global path whose rows come in pairs too, so that every row of
    an agent's window ties with its twin. The kernel's lane-group argmin
    keeps the lowest index, as the plain version's first minimum does."""
    run, plain, args, kw = _tick_case(kind, cuda_device)
    args = list(args)
    args[7] = _pairs(args[7], turn=0.3)
    if kind == "traffic":
        tr = kw["traffic"]
        kw["traffic"] = tr._replace(global_path=_pairs(tr.global_path))
    out_k = run(*args, **kw)
    out_p = plain(*args, **kw)
    torch.cuda.synchronize()
    assert_metrics_match(closed_loop.TickMetrics(*out_k[6], None),
                         closed_loop.TickMetrics(*[np_of(a) for a in out_p[6]], None),
                         TICK_FIELDS, "ties.")
    if kind == "traffic":
        assert_traffic_bar(out_k, out_p)
        moved = out_k[8] != kw["traffic"].npc_idx
        assert bool(moved.any()) and bool((out_k[8][moved] % 2 == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ticks", "traffic"])
def test_tick_kernel_partial_last_block_on_card(cuda_device, kind):
    """A batch that does not fill the kernel's last block of 32 lanes
    (4096 + 7) gives, on its first 4096 lanes, the bits the 4096-lane
    launch gives, and the plain version's result on all of them."""
    B, n = 4096 + 7, 4096
    run, plain, args, kw = _tick_case(kind, cuda_device, B=B)
    out = run(*args, **kw)
    out_n = run(*first_lanes(args, B, n), **first_lanes(kw, B, n))
    out_p = plain(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(tensors_of(out), tensors_of(out_n)):
        assert torch.equal(a[:n], b)
    (assert_tick_bar if kind == "ticks" else assert_traffic_bar)(out, out_p)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ticks", "traffic"])
def test_tick_kernel_pid_window_and_derivative_on_card(cuda_device, kind):
    """ki and kd nonzero, from a half-full PID buffer, a planned speed 0.1
    m/s above each ego's (so that the throttle does not saturate) and a
    separation threshold of 5 km/h: the kernel sums its error ring oldest
    first, the plain version with ``buffer.sum``, so the bar is the float
    one (rtol 1e-5 / atol 5 mm, decisions and PID counts identical). The
    window and the derivative change the run."""
    cfg = dataclasses.replace(CFG, control=dataclasses.replace(
        CFG.control, ki=0.5, kd=0.05, integral_sep_threshold=5.0))
    run, plain, args, kw = _tick_case(kind, cuda_device, cfg)
    B, NB = args[1].shape
    rng = np.random.default_rng(5)
    args = list(args)
    args[5] = (torch.hypot(args[0].vx, args[0].vy) + 0.1)[:, None].expand_as(
        args[5]).contiguous()
    args[1] = t32(rng.uniform(-0.8, 0.8, (B, NB)), cuda_device)
    args[2] = torch.full((B,), NB // 2, dtype=torch.int32, device=cuda_device)
    args[3] = t32(rng.uniform(-0.8, 0.8, B), cuda_device)
    out_k = run(*args, **kw)
    out_p = plain(*args, **kw)
    out_0 = run(*args[:-1], CFG, **kw)
    torch.cuda.synchronize()
    assert_metrics_match(closed_loop.TickMetrics(*out_k[6], None),
                         closed_loop.TickMetrics(*[np_of(a) for a in out_p[6]], None),
                         TICK_FIELDS, "pid.")
    assert torch.equal(out_k[2], out_p[2])
    np.testing.assert_allclose(np_of(out_k[1]), np_of(out_p[1]), atol=5e-3)
    assert not torch.equal(out_k[6][2], out_0[6][2])


# (kind, cfg, lights) of each tick instantiation: K3, K3-L, K5 + K6, K5, K6,
# K7 with LQR, with lights and under MPC + the dynamic bicycle
NAN_TICK_CASES = {
    "tick_lqr": ("ticks", CFG, False),
    "tick_lqr_lights": ("ticks", CFG, True),
    "tick_mpc_dynamic": ("ticks", CONFIG4, False),
    "tick_mpc_kinematic": ("ticks", TICK_VARIANTS["mpc_kinematic"], False),
    "tick_lqr_dynamic": ("ticks", TICK_VARIANTS["lqr_dynamic"], False),
    "tick_traffic": ("traffic", CFG, False),
    "tick_traffic_lights": ("traffic", CFG, True),
    "tick_traffic_mpc_dynamic": ("traffic", CONFIG4, False),
}
# poisoned lanes: ego vx NaN, heading NaN, vx +inf, x +inf; the lead's x
# NaN, the lead's and a parked car's y +inf; a NaN light period. The plan
# (target path, speed profile, times) stays finite: the kernel requires it,
# and every entry point sanitises it (test_torch_containment.py's
# test_tick_loops_get_a_finite_plan_on_poisoned_lanes)
NAN_LANES = (5, 6, 7, 8, 10, 11, 16)


def _poisoned(args, kw):
    """A copy of one tick-loop cycle's (args, kw) with :data:`NAN_LANES`
    poisoned."""
    args, kw = list(args), dict(kw)
    nan, inf = float("nan"), float("inf")
    ego = [a.clone() for a in args[0]]
    ego[3][5] = nan
    ego[2][6] = nan
    ego[3][7] = inf
    ego[0][8] = inf
    args[0] = type(args[0])(*ego)
    obs = args[4]
    x, y = obs.x.clone(), obs.y.clone()
    d0 = CFG.n_static_obs                # the lead NPC's slot, valid (an agent in K7)
    x[10, d0] = nan
    y[11, d0] = inf
    y[11, 0] = inf                       # a parked car's
    args[4] = obs._replace(x=x, y=y)
    if "lights" in kw:
        period = kw["lights"].period.clone()
        period[16, 0] = nan
        kw["lights"] = kw["lights"]._replace(period=period)
    return tuple(args), kw


def nan_case(name, device):
    """(wrapper, plain loop, args, kw, poisoned args, poisoned kw) of
    NAN_TICK_CASES[name]: one cycle's tick-loop inputs (``_tick_case``), with
    its traffic lights, and their copy with :data:`NAN_LANES` poisoned."""
    kind, cfg, with_lights = NAN_TICK_CASES[name]
    run, plain, args, kw = _tick_case(kind, device, cfg)
    B = args[0].x.shape[0]
    if with_lights:
        path = kw["traffic"].global_path if kind == "traffic" else args[7]
        kw["lights"] = scenario.lights_on_path(
            path, (11.0, 41.0), period=12.0, green_frac=0.5,
            offsets=torch.linspace(0.0, 12.0, B + 1, device=device)[:B, None].expand(B, 2),
            device=device)
        kw["t0"] = torch.full((B,), 2.0, device=device)
    return (run, plain, args, kw, *_poisoned(args, kw))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(NAN_TICK_CASES))
def test_tick_kernel_nan_and_inf_lanes_on_card(cuda_device, name):
    """Every tick instantiation on a batch with poisoned lanes
    (:data:`NAN_LANES`) against its plain loop: NaN and inf at the same
    places of every output, the decisions and the PID counts identical, the
    numbers at the loop's kernel-vs-scan bar; the healthy lanes bit for bit
    as in the same launch without the poisoned ones."""
    kind = NAN_TICK_CASES[name][0]
    run, plain, args, kw, p_args, p_kw = nan_case(name, cuda_device)
    B = args[0].x.shape[0]
    before = closed_loop.launches[name]
    out_k = run(*p_args, **p_kw)
    assert closed_loop.launches[name] == before + 1
    out_p = plain(*p_args, **p_kw)
    clean = run(*args, **kw)
    torch.cuda.synchronize()
    outs_k, outs_p, outs_c = (list(tensors_of(o)) for o in (out_k, out_p, clean))
    assert len(outs_k) == len(outs_p) == len(outs_c)
    for i, (a, b) in enumerate(zip(outs_k, outs_p)):
        if a.dtype.is_floating_point:
            assert torch.equal(torch.isnan(a), torch.isnan(b)), f"output {i}: NaN places"
            assert torch.equal(torch.isinf(a) & (a > 0), torch.isinf(b) & (b > 0)), i
            assert torch.equal(torch.isinf(a) & (a < 0), torch.isinf(b) & (b < 0)), i
        else:
            assert torch.equal(a, b), f"output {i}"
    (assert_tick_bar if kind == "ticks" else assert_traffic_bar)(out_k, out_p)
    healthy = torch.ones(B, dtype=torch.bool, device=cuda_device)
    healthy[list(NAN_LANES)] = False
    for a, c in zip(outs_k, outs_c):
        assert torch.equal(a[healthy], c[healthy])
    # the poison reached the state: the NaN-speed lane's position is NaN and
    # the NaN-heading lane's too; the healthy lanes stay finite
    ego = out_k[0]
    assert bool(torch.isnan(ego.x[5])) and bool(torch.isnan(ego.x[6]))
    assert bool(torch.isfinite(ego.x[healthy]).all())


_HYPOT_SRC = r"""
#include "{src}"
__global__ void hyp(const float* a, const float* b, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = hypot_j(a[i], b[i]);
}
extern "C" int hypots(const float* a, const float* b, float* out, int n) {
  hyp<<<(n + 255) / 256, 256>>>(a, b, out, n);
  return (int)cudaDeviceSynchronize();
}
"""


@pytest.mark.cuda
def test_hypot_j_equals_types_hypot_on_card(cuda_device, tmp_path):
    """The tick kernel's hypot_j (built from csrc/tick_lqr.cu with its
    flags) against ``types.hypot`` on the card, over every pair of NaN,
    +-inf, +-0, subnormal, normal and near-overflow values and over random
    pairs around its min <= max * 2^-13 shortcut: the same bits, NaN at the
    same places. Against ``types.hypot`` on the CPU: NaN and inf at the same
    places, the numbers within an ulp (the CPU's vectorised square root is
    not always correctly rounded)."""
    import ctypes
    import subprocess

    from emplanner_carla_tpu_torch import cuda as kbuild
    from emplanner_carla_tpu_torch.types import hypot

    vals = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, 1e-40, 1.1754944e-38,
                     1e-20, 1e-4, 0.5, 1.0, -2.5, 3.0, 8192.0, 1e10, 1.8e19, 3e38, -3.4e38],
                     np.float32)
    a, b = (g.ravel() for g in np.meshgrid(vals, vals))
    rng = np.random.default_rng(17)
    hi = rng.uniform(0.1, 100.0, 20000).astype(np.float32)
    lo = (hi * 2.0 ** -13 * rng.uniform(0.99, 1.01, 20000)).astype(np.float32)
    flip = rng.uniform(size=20000) < 0.5
    a = np.concatenate([a, np.where(flip, hi, lo), rng.normal(size=5000).astype(np.float32)])
    b = np.concatenate([b, np.where(flip, lo, hi), rng.normal(size=5000).astype(np.float32)])
    src, lib = tmp_path / "hypot.cu", tmp_path / "libhypot.so"
    src.write_text(_HYPOT_SRC.replace("{src}", str(kbuild.CSRC / "tick_lqr.cu")))
    subprocess.run([kbuild._nvcc(), *kbuild._BASE_FLAGS, *kbuild.SOURCES["tick_lqr"][1],
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).hypots
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    ta, tb = t32(a, cuda_device), t32(b, cuda_device)
    out = torch.empty_like(ta)
    assert fn(ta.data_ptr(), tb.data_ptr(), out.data_ptr(), a.size) == 0
    got = np_of(out)
    want, cpu = np_of(hypot(ta, tb)), np_of(hypot(t32(a), t32(b)))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    num = ~np.isnan(got)
    assert np.array_equal(got[num].view(np.uint32), want[num].view(np.uint32))
    assert np.array_equal(np.isnan(got), np.isnan(cpu))
    assert np.array_equal(np.isinf(got), np.isinf(cpu))
    np.testing.assert_allclose(got[num], cpu[num], rtol=2.4e-7, atol=0)
    assert np.isnan(got).any() and np.isinf(got).any()


_SINCOS_SRC = r"""
#include <cuda_runtime.h>
#include <math.h>
__device__ __noinline__ float ref_sin(float x) { return sinf(x); }
__device__ __noinline__ float ref_cos(float x) { return cosf(x); }
__device__ __noinline__ void pair(float x, float* s, float* c) { sincosf(x, s, c); }
// every float of magnitude bits below `n` (both signs): sincosf against sinf
// and cosf, bit for bit
__global__ void count(unsigned n, unsigned long long* bad) {
  unsigned long long local = 0;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    for (unsigned sign = 0; sign < 2; ++sign) {
      const float x = __uint_as_float(i | (sign << 31));
      float s, c;
      pair(x, &s, &c);
      local += (__float_as_uint(s) != __float_as_uint(ref_sin(x))) +
               (__float_as_uint(c) != __float_as_uint(ref_cos(x)));
    }
  }
  atomicAdd(bad, local);
}
extern "C" int sincos_mismatches(unsigned n, unsigned long long* bad) {
  count<<<1024, 256>>>(n, bad);
  return (int)cudaDeviceSynchronize();
}
"""


@pytest.mark.cuda
def test_sincosf_equals_sinf_cosf_on_card(cuda_device, tmp_path):
    """The tick kernel takes the sine and cosine of one angle with sincosf;
    the plain version takes them with torch.sin and torch.cos (sinf and
    cosf). Built with the tick kernel's flags, sincosf gives the bits of sinf
    and cosf for every float32 of magnitude up to 105615 (the argument
    reduction's fast range), subnormals and zeros included: every heading,
    path angle and steer angle of a cycle lies in that range."""
    import ctypes
    import subprocess

    from emplanner_carla_tpu_torch import cuda as kbuild

    src, lib = tmp_path / "sincos.cu", tmp_path / "libsincos.so"
    src.write_text(_SINCOS_SRC)
    subprocess.run([kbuild._nvcc(), *kbuild._BASE_FLAGS, *kbuild.SOURCES["tick_lqr"][1],
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).sincos_mismatches
    fn.argtypes = [ctypes.c_uint, ctypes.c_void_p]
    bad = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    limit = int(np.array(105615.0, np.float32).view(np.uint32)) + 1
    assert fn(limit, ctypes.c_void_p(bad.data_ptr())) == 0
    assert int(bad) == 0
    # the angles of a closed-loop cycle lie in the range held above
    sc = scenario.batch_scenarios(5, 16, CFG, device=cuda_device, n_path=96)
    _, m = closed_loop.simulate(*sc, CFG, device=cuda_device)
    for a in (m.heading, sc.global_path.theta):
        assert float(a.abs().max()) <= 105615.0



@pytest.mark.cuda
def test_route_engine_on_card_matches_cpu(cuda_device):
    """The batched device A*, backtracking and stitching on the card:
    parents, found, routes, slot masks, reached, n_valid, options and the
    stitched x / y identical to the CPU run (pad 128 cuts the longest)."""
    from emplanner_carla_tpu_torch.routing import astar, graph

    town = graph.grid_town_curved()
    gen = torch.Generator().manual_seed(3)
    o, d = (torch.randint(0, town.n_nodes, (300,), generator=gen) for _ in range(2))
    d[0] = o[0]

    def run(dev):
        oo, dd = o.to(dev), d.to(dev)
        parent, found = astar.astar_device(town, oo, dd)
        route, valid, reached = astar.route_nodes_device(town, oo, dd)
        return (parent, found, route, valid, reached,
                *astar.stitch_route_device(town, route, valid, 128))

    for a, b in zip(run(cuda_device), run("cpu")):
        assert a.is_cuda and torch.equal(a.cpu(), b)


def _pixel_inputs(B=64, seed=5):
    """A random camera scene a lane: egos and 12 obstacles ahead of them,
    some walkers."""
    from emplanner_carla_tpu_torch.types import EgoState, Obstacles

    rng = np.random.default_rng(seed)
    f32 = np.float32
    ego = EgoState(*(torch.as_tensor(a.astype(f32)) for a in (
        rng.uniform(-5, 5, B), rng.uniform(-5, 5, B), rng.uniform(-np.pi, np.pi, B),
        rng.uniform(0, 10, B), np.zeros(B), rng.uniform(-0.3, 0.3, B), np.zeros(B),
        np.zeros(B), np.zeros(B))))
    r, az = rng.uniform(3, 40, (B, 12)), rng.uniform(-0.9, 0.9, (B, 12))
    phi = ego.phi.numpy()[:, None]
    obs = Obstacles(
        torch.as_tensor((ego.x.numpy()[:, None] + r * np.cos(phi + az)).astype(f32)),
        torch.as_tensor((ego.y.numpy()[:, None] + r * np.sin(phi + az)).astype(f32)),
        torch.as_tensor(rng.uniform(-3, 3, (B, 12)).astype(f32)),
        torch.as_tensor(rng.uniform(-3, 3, (B, 12)).astype(f32)),
        torch.as_tensor(rng.uniform(size=(B, 12)) < 0.7))
    return ego, obs, torch.as_tensor(rng.uniform(size=(B, 12)) < 0.3)


@pytest.mark.cuda
def test_camera_and_detector_on_card_match_cpu(cuda_device):
    """``render_columns`` and both detectors on the card against the CPU:
    column presence and every detection decision identical; the column
    depth within ``column_depth_bar`` (rtol 1e-5 plus the grazing rays'
    conditioning: the two devices' sin / cos differ in the last ulp) and
    within rtol 1e-5 on 95 % of the columns; the frame's classes on 99.9 %
    of the pixels; the detectors, fed the same views and frames, within
    rtol 1e-5 (the frame path on a few lanes)."""
    from emplanner_carla_tpu_torch.sim import camera, detector
    from emplanner_carla_tpu_torch.types import Path

    ego, obs, walk = _pixel_inputs()
    cols = {dev: camera.render_columns(tree_to(ego, dev), tree_to(obs, dev),
                                       is_walker=walk.to(dev))
            for dev in (cuda_device, "cpu")}
    present = np_of(cols["cpu"].col)
    assert np.array_equal(np_of(cols[cuda_device].col), present)
    layout = ([np_of(a) for a in ego], [np_of(a) for a in obs], np_of(walk))
    for c in (0, 1):
        ref = np_of(cols["cpu"].col_d[:, c]).astype(np.float64)
        err = np.abs(np_of(cols[cuda_device].col_d[:, c]) - ref)
        bar = column_depth_bar(*layout, ref, bool(c), camera.CameraConfig())
        p = present[:, c]
        assert np.all(err[p] <= bar[p]) and np.all(err[~p] == 0.0)
        assert np.mean(err[p] <= 1e-5 * ref[p]) >= 0.95
    n = 6
    gp = Path(torch.arange(128.0).expand(n, 128) * 2.0 - 60.0, torch.zeros(n, 128),
              torch.zeros(n, 128), torch.zeros(n, 128))
    ego_n, obs_n = first_lanes(ego, 64, n), first_lanes(obs, 64, n)
    frame = camera.render(ego_n, gp, obs_n, is_walker=walk[:n], road_classes=False)
    on_card = camera.render(tree_to(ego_n, cuda_device), tree_to(gp, cuda_device),
                            tree_to(obs_n, cuda_device), is_walker=walk[:n].to(cuda_device),
                            road_classes=False)
    # silhouette-edge pixels decided by a last ulp: a few of a frame at most
    assert float((on_card.semantic.cpu() == frame.semantic).float().mean()) > 0.999
    for name, fn in (
        ("columns", lambda dev: detector.detect_from_columns(
            camera.ColumnView(*tree_to(cols["cpu"], dev)), tree_to(ego, dev))),
        ("frame", lambda dev: detector.detect(
            camera.CameraFrame(*tree_to(frame, dev)), tree_to(ego_n, dev))),
    ):
        a, b = fn(cuda_device), fn("cpu")
        for field, x, y in zip(a._fields, a, b):
            x = x.cpu()
            if x.dtype in (torch.bool, torch.int32):
                assert torch.equal(x, y), f"{name} {field}"
            else:
                assert torch.allclose(x, y, rtol=1e-5, atol=1e-5), f"{name} {field}"
        assert bool(b.valid.any())


@pytest.mark.cuda
def test_simulate_pixels_runs_the_tick_kernel(cuda_device, monkeypatch):
    """The pixel loop on the card launches ``tick_lqr`` once a plan (its
    counter rises by n_plans) and never runs the plain tick loop, which is
    made to raise; its metrics match the CPU run."""
    from emplanner_carla_tpu_torch.sim import pixel_loop

    sc = scenario.batch_scenarios(2, 8, CFG, device="cpu", n_path=96)
    _, m_cpu = pixel_loop.simulate_pixels(*sc, CFG, device="cpu")

    def refuse(*_a, **_k):
        raise AssertionError("the plain tick loop ran on the card's path")

    monkeypatch.setattr(closed_loop, "_full_ticks_base", refuse)
    before = closed_loop.launches["tick_lqr"]
    _, m_gpu = pixel_loop.simulate_pixels(*sc, CFG, device="cuda")
    torch.cuda.synchronize()
    assert closed_loop.launches["tick_lqr"] - before == CFG.loop.n_plans
    assert_metrics_match(tree_to(m_gpu.ticks, "cpu"), m_cpu.ticks, TICK_FIELDS, "pixels.")
    assert torch.equal(m_gpu.n_tracked.cpu(), m_cpu.n_tracked)


@pytest.mark.cuda
def test_fleet_one_nccl_rank_matches_simulate_full_on_card(cuda_device):
    """``fleet_simulate`` over the one-rank NCCL group that ``make_mesh``
    starts on the card: the same per-scenario metrics as ``simulate_full``
    on the same batch, the aggregates those of a float64 host reduction."""
    import torch.distributed as dist

    from emplanner_carla_tpu_torch.parallel import fleet

    sc = scenario.batch_scenarios(5, 64, CFG, device=cuda_device, n_path=96)
    _, m_ref = closed_loop.simulate_full(*sc, CFG, device=cuda_device)
    assert not dist.is_initialized()
    mesh = fleet.make_mesh()
    try:
        assert (mesh.backend, mesh.world, mesh.device.type) == ("nccl", 1, "cuda")
        local = fleet.shard_scenarios(sc, mesh)
        m, agg = fleet.fleet_simulate(local, CFG, mesh, full=True)
    finally:
        dist.destroy_process_group()
    ref_np = closed_loop.TickMetrics(*[np_of(a) for a in m_ref])
    assert_metrics_match(tree_to(m, "cpu"), ref_np, closed_loop.TickMetrics._fields,
                         "fleet vs simulate_full.")
    assert all(a.device.type == "cuda" for a in agg.values())
    lat = ref_np.lateral_err.astype(np.float64)
    assert float(agg["n_scenarios"]) == 64
    np.testing.assert_allclose(float(agg["lateral_rmse"]), np.sqrt(np.mean(lat**2)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(agg["mean_speed_kmh"]),
                               ref_np.speed_kmh.astype(np.float64).mean(), rtol=1e-5)
    assert float(agg["collisions"]) == ref_np.collided.reshape(64, -1).any(1).sum()


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    """A full-EM LoopCarry and its metrics saved from the card and restored
    onto it bit for bit; the resume runs the kernels on the card."""
    from emplanner_carla_tpu_torch.utils import checkpoint

    sc = scenario.batch_scenarios(6, 32, CFG, device=cuda_device, n_path=96)
    carry, m = closed_loop.simulate_full(*sc, CFG, device=cuda_device)
    checkpoint.save(str(tmp_path), carry, m)
    restored, m2 = checkpoint.restore(str(tmp_path), carry, m)
    pairs = list(zip(tensors_of((restored, m2)), tensors_of((carry, m))))
    assert len(pairs) == len(list(tensors_of((carry, m))))
    for a, b in pairs:
        assert a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
    before = closed_loop.launches["tick_lqr"]
    _, m3 = checkpoint.resume_simulation(sc.global_path, restored, CFG, n_plans=1,
                                         full=True)
    assert closed_loop.launches["tick_lqr"] == before + 1
    assert m3.x.device.type == "cuda" and bool(torch.isfinite(m3.x).all())
