"""PyTorch port, S-T speed planning: each stage of the port's speed planner
against ``jax.vmap`` of its JAX function on the same inputs.

The stage inputs come from one JAX full EM cycle on the three-crosser
scenario (ST graph non-empty, more valid segments than st_top_m keeps),
tiled to a small batch with the crossers' speeds varied per lane. The speed
DP's plain version (the CPU side of kernel K4) is also held against the JAX
DP on the JAX package's own random segment sets and on bench config 1's
fixed set.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.ops import frenet as j_frenet
from emplanner_carla_tpu.planner import em_planner as j_em
from emplanner_carla_tpu.planner import speed_planner as j_sp
from emplanner_carla_tpu.planner import trajectory as j_traj
from emplanner_carla_tpu.sim import perception as j_perc
from emplanner_carla_tpu.types import STSegments as JSeg
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.ops import frenet as t_frenet
from emplanner_carla_tpu_torch.planner import speed_planner as t_sp
from emplanner_carla_tpu_torch.planner import trajectory as t_traj
from emplanner_carla_tpu_torch.types import STSegments
from test_fidelity import _three_crosser_scenario
from torch_port_helpers import assert_qp_close, np_of, t32

JC = JCfg()
TC = convert.config_from_dict(dataclasses.asdict(JC))
SP_J, SP_T = JC.speed, TC.speed
B = 6


def crosser_batch(batch=B, seed=0):
    """``_three_crosser_scenario`` tiled to ``batch`` lanes, the crossers'
    lateral speeds scaled per lane (numpy, seeded): every lane has three
    crossers inside the perception range at cycle 0."""
    sc = _three_crosser_scenario(JC)
    tiled = jax.tree.map(lambda a: np.repeat(np.asarray(a)[None], batch, 0), sc)
    rng = np.random.default_rng(seed)
    ovy = tiled.obstacles.vy.copy()
    d0 = JC.n_static_obs
    ovy[:, d0:d0 + 3] *= rng.uniform(0.8, 1.25, (batch, 3)).astype(np.float32)
    return tiled._replace(obstacles=tiled.obstacles._replace(vy=ovy))


def _jax_speed_stages(g, e, o, mi):
    """One JAX full EM cycle, unbatched, returning every speed stage's
    inputs and outputs (the body of em_planner.plan_full_cycle)."""
    path_warm, speed_warm = j_em.warm_init(JC, full=True)
    res = j_em.plan_path_cycle(g, e, o, mi, JC, qp_warm=path_warm)
    target = res.target
    vx_w, vy_w = e.v_world
    s_dot0, s_ddot0 = j_sp.speed_plan_start(vx_w, vy_w, e.ax, e.ay, target.theta[0])
    s_dot0 = jnp.maximum(s_dot0, 0.0)
    path_arc = j_traj.path_arc_length(target)
    _, dyn_mask, _ = j_perc.perceive(e, o, JC.loop)
    d0 = JC.n_static_obs
    fr = j_frenet.dynamic_obs_frenet(o.x[d0:], o.y[d0:], o.vx[d0:], o.vy[d0:],
                                     target, path_arc)
    seg_all = j_sp.st_graph(*fr, dyn_mask[d0:], SP_J)
    order = jnp.argsort(jnp.where(seg_all.valid, seg_all.t_in, jnp.inf))[:SP_J.st_top_m]
    seg = jax.tree.map(lambda a: a[order], seg_all)
    dp = j_sp.speed_dp(seg, s_dot0, SP_J)
    bounds = j_sp.convex_space(dp, seg, path_arc, target.kappa, SP_J)
    qs, qv, qa, qt, st1 = j_sp.speed_qp(s_dot0, s_ddot0, *bounds, SP_J,
                                        warm_state=speed_warm)
    # a second solve from the first one's (non-zero) state
    _, _, _, _, st2 = j_sp.speed_qp(s_dot0, s_ddot0, *bounds, SP_J, warm_state=st1)
    dense = j_sp.densify_speed(qs, qv, qa, qt, SP_J)
    traj = j_traj.merge(target, *dense)
    return dict(target=target, path_arc=path_arc, dyn_mask=dyn_mask[d0:],
                fr=fr, seg_all=seg_all, seg=seg, s_dot0=s_dot0, s_ddot0=s_ddot0,
                dp=dp, bounds=bounds, qp=(qs, qv, qa, qt), st1=st1, st2=st2,
                dense=dense, traj=traj)


@pytest.fixture(scope="module")
def stages():
    sc = crosser_batch()
    mi = jax.vmap(lambda e, g: j_frenet.nearest_index(e.x, e.y, g))(sc.ego0, sc.global_path)
    out = jax.jit(jax.vmap(_jax_speed_stages))(sc.global_path, sc.ego0, sc.obstacles, mi)
    return jax.tree.map(np.asarray, out)


def _seg_t(seg):
    return STSegments(*(t32(a) for a in seg[:4]), torch.as_tensor(np.array(seg[4])))


def _close(a, b, err_msg="", rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def test_speed_qp_constants_equal_jax():
    for a, b in zip(t_sp._speed_qp_constants(SP_T), j_sp._speed_qp_constants(SP_J)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert t_sp.qp_dims(SP_T) == (51, 99)


def test_dynamic_frenet_and_st_graph_match_jax(stages):
    o = crosser_batch().obstacles
    d0 = JC.n_static_obs
    target = convert.path_from_numpy(stages["target"])
    fr = t_frenet.dynamic_obs_frenet(
        *(t32(np.asarray(a)[:, d0:]) for a in (o.x, o.y, o.vx, o.vy)),
        target, t32(stages["path_arc"]))
    for name, a, b in zip(("s", "l", "s_dot", "l_dot"), fr, stages["fr"]):
        _close(a, b, name, atol=1e-4)
    seg = t_sp.st_graph(*(t32(a) for a in stages["fr"]),
                        torch.as_tensor(np.array(stages["dyn_mask"])), SP_T)
    ref = stages["seg_all"]
    np.testing.assert_array_equal(np_of(seg.valid), ref.valid)
    assert ref.valid.sum(1).min() == 3          # three crossers in every lane
    for name in ("s_in", "s_out", "t_in", "t_out"):
        _close(getattr(seg, name), getattr(ref, name), name, atol=1e-5)


def _random_segments(K, seed=0, batch=16):
    """The random segment sets of the JAX package's test_speed_dp_pallas."""
    rng = np.random.default_rng(seed)
    s_in = rng.uniform(5, 40, (batch, K)).astype(np.float32)
    s_out = s_in + rng.uniform(1, 10, (batch, K)).astype(np.float32)
    t_in = rng.uniform(0, 4, (batch, K)).astype(np.float32)
    t_out = rng.uniform(0.5, 7, (batch, K)).astype(np.float32)
    valid = rng.uniform(size=(batch, K)) < 0.5
    t_out = t_in + np.abs(t_out - t_in) + np.float32(0.3)
    v0 = rng.uniform(3, 14, (batch,)).astype(np.float32)
    return (s_in, s_out, t_in, t_out, valid), v0


def _bench_config1_segments(batch=16):
    """bench_all.py config 1's fixed two-segment set (K = 4, two valid)."""
    rows = ([20.0, 35.0, 0, 0], [25.0, 38.0, 0, 0], [2.0, 4.0, 0, 0],
            [5.0, 6.5, 0, 0])
    fields = [np.tile(np.asarray(r, np.float32), (batch, 1)) for r in rows]
    valid = np.tile(np.asarray([True, True, False, False]), (batch, 1))
    v0 = np.linspace(3.0, 14.0, batch).astype(np.float32)
    return (*fields, valid), v0


@pytest.mark.parametrize("case", ["random_k2", "random_k4", "bench_config1"])
def test_k4_plain_matches_jax_speed_dp(case):
    if case == "bench_config1":
        seg, v0 = _bench_config1_segments()
    else:
        seg, v0 = _random_segments(int(case[-1]), seed=0 if case == "random_k4" else 1)
    ref = jax.jit(jax.vmap(lambda s, v: j_sp.speed_dp(s, v, SP_J)))(JSeg(*seg), v0)
    before = t_sp.launches["speed_dp"]
    out = t_sp.speed_dp(_seg_t(seg), t32(v0), SP_T)
    assert t_sp.launches["speed_dp"] == before   # CPU tensors: plain version
    np.testing.assert_array_equal(np_of(out.end_index), np.asarray(ref.end_index))
    np.testing.assert_array_equal(np_of(out.valid), np.asarray(ref.valid))
    np.testing.assert_allclose(np_of(out.s), np.asarray(ref.s), atol=1e-4)
    np.testing.assert_array_equal(np_of(out.t), np.asarray(ref.t))
    # the set exercises both terminals: an early end on the s_max row and
    # the right column
    if case == "random_k4":
        ends = np_of(out.end_index)
        assert (ends < SP_T.n_t - 1).any() and (ends == SP_T.n_t - 1).any()


def test_k4_plain_on_the_cycles_segments(stages):
    dp = t_sp.speed_dp(_seg_t(stages["seg"]), t32(stages["s_dot0"]), SP_T)
    ref = stages["dp"]
    assert stages["seg"].valid.any()
    np.testing.assert_array_equal(np_of(dp.end_index), ref.end_index)
    np.testing.assert_array_equal(np_of(dp.valid), ref.valid)
    np.testing.assert_allclose(np_of(dp.s), ref.s, atol=1e-4)


def test_convex_space_matches_jax(stages):
    dp_ref = stages["dp"]
    dp = t_sp.SpeedDPResult(t32(dp_ref.s), t32(dp_ref.t),
                            torch.as_tensor(np.array(dp_ref.valid)),
                            torch.as_tensor(np.array(dp_ref.end_index)))
    out = t_sp.convex_space(dp, _seg_t(stages["seg"]), t32(stages["path_arc"]),
                            t32(stages["target"].kappa), SP_T)
    for name, a, b in zip(("s_lb", "s_ub", "s_dot_lb", "s_dot_ub"), out,
                          stages["bounds"]):
        _close(a, b, name)
    # some lane yields or overtakes a segment: a bound is active
    assert (np.asarray(stages["bounds"][1]) < t_sp.BIG).any()


@pytest.mark.parametrize("warm", ["zero_state", "carried_state"])
def test_k1_speed_site_matches_jax_warm_qp(stages, warm):
    """The warm speed QP (the K1 kernel's speed site; its plain ladder on
    the CPU) against the JAX warm speed_qp, from the zero state and from
    the state the first solve carried out.

    K1 bar on x, x_s, z and on the inequality rows' dual. The equality
    rows' dual (continuity and start pin, rho scaled by 1e3) random-walks
    over the site's 3 x 40 iterations by up to ~4% of |y| between the two
    operation orders, while its effect on x is 1e-3 of that; so it is held
    by what it does, as the JAX package's own warm-state test holds it: the
    next solve from the port's carried state and from JAX's carried state
    agree at the K1 bar."""
    bounds = [t32(a) for a in stages["bounds"]]
    s_dot0, s_ddot0 = t32(stages["s_dot0"]), t32(stages["s_ddot0"])
    nv, m = t_sp.qp_dims(SP_T)
    if warm == "zero_state":
        state = t_sp.warm_state_init(SP_T, B)
        ref_x, ref_state = stages["qp"], stages["st1"]
    else:
        state = tuple(t32(a) for a in stages["st1"])
        ref_x, ref_state = None, stages["st2"]
    before = dict(t_sp.qp.launches)
    qs, qv, qa, qt, new = t_sp.speed_qp(s_dot0, s_ddot0, *bounds, SP_T,
                                        warm_state=state)
    assert t_sp.qp.launches == before
    assert tuple(new[0].shape) == (B, nv) and tuple(new[1].shape) == (B, m)
    if ref_x is not None:
        x_t = np.stack([np_of(qs), np_of(qv), np_of(qa)], -1).reshape(B, -1)
        x_j = np.stack([np.asarray(a) for a in ref_x[:3]], -1).reshape(B, -1)
        np.testing.assert_array_equal(np_of(qt), ref_x[3][0])
    else:
        x_t = x_j = np.zeros(1)
    eq = t_sp._speed_qp_constants(SP_T)[2]
    assert_qp_close(x_t, [np_of(a) for a in new], x_j,
                    [np.asarray(a) for a in ref_state], y_rows=~eq)
    nxt_t = t_sp.speed_qp(s_dot0, s_ddot0, *bounds, SP_T, warm_state=new)
    nxt_j = t_sp.speed_qp(s_dot0, s_ddot0, *bounds, SP_T,
                          warm_state=tuple(t32(a) for a in ref_state))
    x_of = lambda r: np.stack([np_of(a) for a in r[:3]], -1).reshape(B, -1)  # noqa: E731
    assert_qp_close(x_of(nxt_t), [np_of(a) for a in nxt_t[4]], x_of(nxt_j),
                    [np_of(a) for a in nxt_j[4]], y_rows=~eq)


def test_densify_merge_and_speed_at_match_jax(stages):
    qs, qv, qa, qt = stages["qp"]
    dense = t_sp.densify_speed(t32(qs), t32(qv), t32(qa), t32(qt[0]), SP_T)
    for name, a, b in zip(("s", "v", "a"), dense[:3], stages["dense"][:3]):
        _close(a, b, name, atol=1e-5)
    np.testing.assert_array_equal(np_of(dense[3]), stages["dense"][3][0])
    # merge on JAX's dense profile and target path
    s_d, v_d, a_d, t_d = (t32(a) for a in stages["dense"])
    traj = t_traj.merge(convert.path_from_numpy(stages["target"]), s_d, v_d, a_d,
                        t_d[0])
    for name in ("x", "y", "theta", "kappa", "speed", "accel", "time"):
        _close(getattr(traj, name), getattr(stages["traj"], name), name, atol=1e-5)
    np.testing.assert_array_equal(np_of(traj.valid), stages["traj"].valid)
    jt = stages["traj"]
    for t in (0.0, 0.37, 3.0, 100.0):
        ref = jax.vmap(lambda tr: j_traj.speed_at(tr, jnp.float32(t)))(
            jax.tree.map(jnp.asarray, jt))
        _close(t_traj.speed_at(traj, t), ref, f"speed_at({t})", atol=1e-5)


def test_st_gate_skips_only_exact_zeros():
    """``st_sample_skipped`` on 300k seeded (sample, segment) pairs: segments
    of every orientation and scale, short, vertical, horizontal and point
    ones, samples over the DP's range and within 1e-4 of the window's edges.
    Every skipped pair's plain obstacle cost is exactly 0, by both distance
    forms the DP uses (``_seg_distance`` and the hoisted interior form);
    a segment shorter than the margin skips nothing, nor does a NaN one."""
    rng = np.random.default_rng(0)
    n = 300_000
    f32 = np.float32
    kind = rng.integers(0, 6, n)
    si = rng.uniform(-100, 300, n).astype(f32)
    ds = np.select([kind == 0, kind == 1], [0.0, rng.uniform(-1e-3, 1e-3, n)],
                   rng.uniform(-40, 40, n))
    ti = rng.uniform(-3, 10, n).astype(f32)
    dtt = np.select([kind == 2, kind == 1], [0.0, rng.uniform(-1e-3, 1e-3, n)],
                    rng.uniform(0, 8, n))
    seg = STSegments(*(torch.as_tensor(a) for a in (si, (si + ds).astype(f32), ti,
                                                    (ti + dtt).astype(f32))),
                     torch.ones(n, dtype=torch.bool))
    lo, hi = t_sp.st_gate_window(seg, SP_T)
    edge = rng.integers(0, 3, n)
    near = rng.uniform(-1e-4, 1e-4, n)
    s = np.where(edge == 1, np_of(lo) + near,
                 np.where(edge == 2, np_of(hi) + near, rng.uniform(0, 54.5, n)))
    s = torch.as_tensor(np.clip(s, 0.0, 54.5).astype(f32))
    t = torch.as_tensor(rng.uniform(0.0, 8.0, n).astype(f32))
    skip = t_sp.st_sample_skipped(s, lo, hi)
    v3s, v3t = seg.s_out - seg.s_in, seg.t_out - seg.t_in
    nrm = (v3s * v3s + v3t * v3t) + 1e-24
    v1t, v2t = seg.t_in - t, seg.t_out - t
    forms = {
        "direct": t_sp._seg_distance(s, t, seg.s_in, seg.s_out, seg.t_in, seg.t_out),
        "interior": t_sp._interior_distance(seg.s_in - s, v1t * v1t, v2t * v2t, v1t * v3s,
                                            v1t * v3t, v3s, v3t, nrm,
                                            torch.full_like(nrm, 1.0) / nrm),
    }
    for name, d in forms.items():
        cost = t_sp._collision_cost(d, SP_T)
        assert not bool((skip & (cost != 0)).any()), name
        assert float(d[skip].min()) >= SP_T.obs_danger_dist, name
    assert int(skip.sum()) > n // 2
    assert int((skip & torch.as_tensor(edge > 0)).sum()) > n // 10
    short = (v3s * v3s + v3t * v3t) < (1e-4 * 55.5) ** 2
    assert bool(short.any()) and not bool(skip[short].any())
    nan_seg = STSegments(*(torch.tensor([x]) for x in (float("nan"), 10.0, 1.0, 2.0)),
                         torch.tensor([True]))
    lo_n, hi_n = t_sp.st_gate_window(nan_seg, SP_T)
    assert not bool(t_sp.st_sample_skipped(torch.tensor([0.0, 54.5]), lo_n, hi_n).any())


@pytest.mark.parametrize("dt", [0.5, 0.25, 1.0, 2.0, 0.125, 2.0 ** -20, 0.3])
def test_exact_reciprocal_check(dt):
    """The speed-DP kernel multiplies by 1 / t_step where the host finds it
    exact: for a power-of-two t_step x * (1 / dt) == x / dt on random
    float32 x (subnormal, huge and signed ones too); 0.3 is refused."""
    exact = t_sp._exact_reciprocal(dt)
    assert exact == (dt != 0.3)
    if not exact:
        return
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64).astype(np.uint32)
    x = torch.as_tensor(bits.view(np.float32))
    x = x[torch.isfinite(x)]
    d = torch.full_like(x, dt)
    prod = x * (torch.ones_like(x) / d)
    quot = x / d
    assert torch.equal(prod.view(torch.int32), quot.view(torch.int32))


@pytest.mark.parametrize("d", [0.5, 1.5, 0.3, 2.7])
def test_sqrt_threshold_orders_like_the_root(d):
    """``sqrt(x) < d`` equals ``x < _sqrt_threshold(d)`` for float32 x >= 0 and
    NaN: the kernel compares squared distances with the collision and danger
    thresholds this way."""
    thr = np.float32(t_sp._sqrt_threshold(d))
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.uniform(0, 4 * d * d, 100_000),
                        float(thr) * (1 + rng.uniform(-1e-6, 1e-6, 10_000)),
                        [0.0, float(thr), np.nan, np.inf]]).astype(np.float32)
    x = np.concatenate([x, np.nextafter(thr, np.float32(0)) + np.zeros(1, np.float32)])
    got = torch.as_tensor(x) < float(thr)
    want = torch.sqrt(torch.as_tensor(x)) < float(np.float32(d))
    assert torch.equal(got, want)
