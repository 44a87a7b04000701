"""PyTorch port, control and plant variants: the condensed MPC (tables,
table path cold and warm, the per-tick exact QP), the raw heading error,
the dynamic bicycle and plant sub-steps against the JAX package; the plain
tick loop (the plain version of kernels K5 and K6) against
``jax.vmap(_full_ticks_base)`` for each controller/plant pair; and
``simulate_full`` at BASELINE config 4 (MPC + dynamic bicycle) against the
JAX package and ``simulate`` there against the float64 oracle.

Bars: tables bit for bit; single control steps and plant steps within
float32 operation-order differences; the tick loop at the JAX package's
own kernel-vs-scan bar (``tests/test_tick_pallas.py``: positions and speed
1 mm, heading 5e-4, lateral error 2 mm, decisions and PID count
identical); the loop at ``assert_metrics_match``'s bar; the oracle at
5 cm lateral RMSE.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emplanner_carla_tpu import config as j_config
from emplanner_carla_tpu.control import lateral as j_lat
from emplanner_carla_tpu.control import pid as j_pid
from emplanner_carla_tpu.control import vehicle as j_vehicle
from emplanner_carla_tpu.oracle import closed_loop_np
from emplanner_carla_tpu.sim import closed_loop as j_cl
from emplanner_carla_tpu.sim import plant as j_plant
from emplanner_carla_tpu.sim import scenario as j_sc
from emplanner_carla_tpu.sim.traffic_light import TrafficLights
from emplanner_carla_tpu.types import EgoState as JEgo
from emplanner_carla_tpu_torch import config as t_config
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.control import lateral as t_lat
from emplanner_carla_tpu_torch.control import pid as t_pid
from emplanner_carla_tpu_torch.control import vehicle
from emplanner_carla_tpu_torch.sim import closed_loop as t_cl
from emplanner_carla_tpu_torch.sim import plant as t_plant
from test_fidelity import N_PLANS, lateral_rmse, unpack_scenario
from test_torch_loop import _tick_args_torch, _tick_inputs
from torch_port_helpers import (
    assert_metrics_match, assert_tick_bar, np_of, run_single_threaded, t32,
)

JC = j_config.EMConfig(loop=dataclasses.replace(j_config.EMConfig().loop,
                                                n_plans=2, plan_every=20))
B = 8


def _variant(control=None, plant=None):
    """(JAX config, port config) of JC with the control / plant fields
    replaced; ``control="ff"`` takes the feedforward MPC variant."""
    c = JC.control
    if control == "ff":
        c = j_config.mpc_feedforward_variant(c)
    elif control:
        c = dataclasses.replace(c, **control)
    p = dataclasses.replace(JC.plant, **(plant or {}))
    jc = dataclasses.replace(JC, control=c, plant=p)
    return jc, convert.config_from_dict(dataclasses.asdict(jc))


CONFIG4 = _variant(dict(kind="MPC"), dict(kind="dynamic"))
TICK_VARIANTS = {
    "lqr_dynamic": _variant(None, dict(kind="dynamic")),
    "mpc_kinematic": _variant(dict(kind="MPC")),
    "mpc_dynamic": CONFIG4,
    "mpc_feedforward": _variant("ff"),
    "mpc_dynamic_substeps2": _variant(dict(kind="MPC"), dict(kind="dynamic", substeps=2)),
}


@pytest.mark.parametrize("variant", ["default", "feedforward"])
def test_mpc_tables_equal_jax(variant):
    jc, tc = CONFIG4 if variant == "default" else TICK_VARIANTS["mpc_feedforward"]
    pairs = list(zip(t_lat.mpc_tables(tc.vehicle, tc.control),
                     j_lat.mpc_tables(jc.vehicle, jc.control)))
    pairs += list(zip(t_lat._ustar_tables(tc.vehicle, tc.control),
                      j_lat._ustar_tables(jc.vehicle, jc.control)))
    assert len(pairs) == 7
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    nu = jc.control.mpc_n * jc.control.mpc_p
    assert pairs[1][0].shape == (64, nu, nu)
    packed = t_lat.mpc_kernel_table(tc.vehicle, tc.control)
    assert packed.shape == (64, nu * nu + 10 * nu)


def test_feedforward_variant_config_round_trips():
    jc, tc = TICK_VARIANTS["mpc_feedforward"]
    assert tc.control == t_config.mpc_feedforward_variant(t_config.ControlConfig())
    assert tc.control.mpc_n * tc.control.mpc_p == 8 and tc.control.raw_heading_error
    assert convert.config_from_dict(dataclasses.asdict(jc)) == tc


@pytest.fixture(scope="module")
def tick_inputs():
    return _tick_inputs()


def _control_states(inp, seed=3):
    """The scenarios' egos displaced off the planned target (lateral offset
    up to 2.5 m, heading up to 0.4 rad, lateral speed and yaw rate), so that
    some lanes' MPC optimum leaves the box and some stays inside."""
    sc, target = inp[0], inp[1]
    rng = np.random.default_rng(seed)
    e = jax.tree.map(np.asarray, sc.ego0)
    phi = e.phi + rng.uniform(-0.4, 0.4, B).astype(np.float32)
    off = rng.uniform(-2.5, 2.5, B).astype(np.float32)
    ego = e._replace(
        x=e.x - off * np.sin(e.phi), y=e.y + off * np.cos(e.phi), phi=phi,
        vx=rng.uniform(0.0, 15.0, B).astype(np.float32),
        vy=rng.uniform(-0.5, 0.5, B).astype(np.float32),
        omega=rng.uniform(-0.3, 0.3, B).astype(np.float32))
    return ego, jax.tree.map(np.asarray, target)


@pytest.mark.parametrize("raw", [False, True])
def test_tracking_error_matches_jax(tick_inputs, raw):
    jc, tc = _variant(dict(raw_heading_error=raw))
    ego, target = _control_states(tick_inputs)
    ej, kj, ij = jax.vmap(lambda s, p: j_lat.tracking_error(s, p, jc.control))(ego, target)
    et, kt, it = t_lat.tracking_error(convert.ego_from_numpy(ego),
                                      convert.path_from_numpy(target), tc.control)
    np.testing.assert_array_equal(np_of(it), np.asarray(ij))
    np.testing.assert_allclose(np_of(torch.stack(et, 1)), np.asarray(ej),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np_of(kt), np.asarray(kj), rtol=1e-6)
    if raw:  # the raw error is not the sin of itself where it is large
        assert np.abs(np.asarray(ej)[:, 2]).max() > 0.2


# The box ADMM's x = Minv (z - u_d - f) sums products of |f| up to ~7e3
# (2 G1 e at Q = 250) with Minv entries up to ~0.17, so float32 operation
# order moves x, and with it z, by ~2e-4 (seen on the saturated lanes of
# these inputs), and the dual u_d, which sums x - z over the iterations to
# ~3, by ~3e-4 of itself.
ADMM_ATOL = ADMM_RTOL = 1e-3


@pytest.mark.parametrize("kind", ["cold", "warm", "exact"])
def test_mpc_steer_matches_jax(tick_inputs, kind):
    jc, tc = CONFIG4
    ego, target = _control_states(tick_inputs)
    te, tt = convert.ego_from_numpy(ego), convert.path_from_numpy(target)
    nu = jc.control.mpc_n * jc.control.mpc_p
    rng = np.random.default_rng(5)
    warm = tuple(np.clip(rng.normal(size=(B, nu)), -1, 1).astype(np.float32) * s
                 for s in (1.0, 0.1))
    if kind == "cold":
        sj, ij = jax.vmap(lambda s, p: j_lat.mpc_steer(s, p, jc.vehicle, jc.control))(
            ego, target)
        st, it = t_lat.mpc_steer(te, tt, tc.vehicle, tc.control)
    elif kind == "warm":
        sj, ij, wj = jax.vmap(lambda s, p, w: j_lat.mpc_steer_warm(
            s, p, jc.vehicle, jc.control, w))(ego, target, warm)
        st, it, wt = t_lat.mpc_steer_warm(te, tt, tc.vehicle, tc.control,
                                          tuple(t32(a) for a in warm))
        for a, b in zip(wt, wj):
            np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=ADMM_RTOL,
                                       atol=ADMM_ATOL)
    else:
        sj, ij = jax.vmap(lambda s, p: j_lat.mpc_steer_exact(s, p, jc.vehicle, jc.control))(
            ego, target)
        st, it = t_lat.mpc_steer_exact(te, tt, tc.vehicle, tc.control)
    np.testing.assert_array_equal(np_of(it), np.asarray(ij))
    np.testing.assert_allclose(np_of(st), np.asarray(sj), rtol=0, atol=ADMM_ATOL)
    if kind != "exact":
        # both branches ran: some lanes' u* inside the box, some outside
        _, _, _, ran = t_lat.mpc_steer_table(te, tt, tc.vehicle, tc.control, None, 1)
        assert bool(ran.any()) and not bool(ran.all())


@pytest.mark.parametrize("kind", ["LQR", "MPC"])
def test_run_step_matches_jax(tick_inputs, kind):
    """One control tick of the vehicle facade from a warm controller state
    (the MPC's (z, u_d) and a half-full PID buffer)."""
    jc, tc = _variant(dict(kind=kind))
    ego, target = _control_states(tick_inputs, seed=4)
    rng = np.random.default_rng(9)
    nb, nu = jc.control.pid_buffer, jc.control.mpc_n * jc.control.mpc_p
    buf = np.zeros((B, nb), np.float32)
    buf[:, nb // 2:] = rng.normal(size=(B, nb - nb // 2)) * 0.3
    pid_np = (buf, np.full(B, nb - nb // 2, np.int32), buf[:, -1].copy())
    mpc_np = None
    if kind == "MPC":
        mpc_np = tuple(np.clip(rng.normal(size=(B, nu)), -1, 1).astype(np.float32) * s
                       for s in (1.0, 0.1))
    target_kmh = rng.uniform(0, 40, B).astype(np.float32)
    out_j = jax.vmap(lambda e, p, b, c, l, m, v: j_vehicle.run_step(
        e, p, j_vehicle.ControllerState(j_pid.PIDState(b, c, l), m), v,
        jc.vehicle, jc.control))(ego, target, *pid_np, mpc_np, target_kmh)
    cs = vehicle.ControllerState(
        t_pid.PIDState(t32(pid_np[0]), torch.as_tensor(pid_np[1]), t32(pid_np[2])),
        None if mpc_np is None else tuple(t32(a) for a in mpc_np))
    out_t = vehicle.run_step(convert.ego_from_numpy(ego), convert.path_from_numpy(target),
                             cs, t32(target_kmh), tc.vehicle, tc.control)
    for name, a, b in zip(("steer", "throttle", "brake"), out_t[:3], out_j[:3]):
        np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=0, atol=ADMM_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(np_of(out_t[3].pid.buffer), np.asarray(out_j[3].pid.buffer),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(np_of(out_t[3].pid.count), np.asarray(out_j[3].pid.count))
    if kind == "MPC":
        for a, b in zip(out_t[3].mpc, out_j[3].mpc):
            np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=ADMM_RTOL,
                                       atol=ADMM_ATOL)
    else:
        assert out_t[3].mpc is None


def _plant_states(seed=7):
    """Ego states across the dynamic plant's regimes: standstill and slow
    (the vx guards), large slip (the friction caps), ordinary driving."""
    rng = np.random.default_rng(seed)
    n = 64
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)  # noqa: E731
    vx = f(0.0, 20.0)
    vx[:8] = [0.0, 0.05, 0.09, 0.3, 0.5, 0.8, 0.11, 0.0]
    ego = JEgo(f(-50, 50), f(-50, 50), f(-3, 3), vx, f(-2, 2), f(-1.5, 1.5),
               f(-2, 2), f(-2, 2), f(-1, 1))
    cmds = (f(-1.2, 1.2), f(0, 1), f(0, 1) * (rng.uniform(size=n) < 0.3))
    return ego, cmds


@pytest.mark.parametrize("kind,substeps", [("dynamic", 1), ("kinematic", 2),
                                           ("dynamic", 2)])
def test_plant_step_matches_jax(kind, substeps):
    jc, tc = _variant(None, dict(kind=kind, substeps=substeps))
    ego, (steer, thr, brk) = _plant_states()
    ej = jax.vmap(lambda s, a, b, c: j_plant.step(s, a, b, c, jc.vehicle, jc.plant))(
        ego, steer, thr, brk)
    et = t_plant.step(convert.ego_from_numpy(ego), t32(steer), t32(thr), t32(brk),
                      tc.vehicle, tc.plant)
    for name, a, b in zip(JEgo._fields, et, ej):
        np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    if kind == "dynamic":
        fzf, fzr = t_plant.axle_force_caps(tc.vehicle)
        # the friction cap binds in some lanes and the slow-speed gate zeroes
        # vy and omega in others
        alpha_f = (ego.vy + tc.vehicle.a * ego.omega) / np.maximum(ego.vx, 0.5)
        assert (np.abs(tc.vehicle.cf * alpha_f) > fzf).any()
        slow = np_of(et.vx) <= 0.1
        assert slow.any() and (np_of(et.vy)[slow] == 0.0).all()
        assert (np_of(et.vy)[~slow] != 0.0).all()


@pytest.mark.parametrize("variant", list(TICK_VARIANTS))
def test_tick_loop_matches_jax(tick_inputs, variant):
    """The plain tick loop (K5's and K6's plain version) against the JAX
    package's tick loop, on one JAX-planned cycle with a bad plan, an
    arrived lane and a destination within reach, the egos displaced off the
    target so that the MPC saturates in the first ticks."""
    jc, tc = TICK_VARIANTS[variant]
    sc, target, tspeed, tq, plan_ok, arrived, feas, dest_x, dest_y, pid = tick_inputs
    ego0, _ = _control_states(tick_inputs)
    out_j = jax.jit(jax.vmap(
        lambda e, b, c, l, o, ts, tgt, ar, fe, ok, dx, dy: j_cl._full_ticks_base(
            e, b, c, l, o, ts, jnp.asarray(tq), tgt, ar, fe, ok, dx, dy,
            TrafficLights.none(), jnp.float32(0.0), jc)))(
        ego0, *pid, sc.obstacles, tspeed, target, arrived, feas, plan_ok,
        dest_x, dest_y)
    args = ((convert.ego_from_numpy(ego0),) + _tick_args_torch(tick_inputs)[1:-1]
            + (tc,))
    before = dict(t_cl.launches)
    out_t = t_cl.run_ticks(*args)
    assert t_cl.launches == before  # CPU tensors: the plain loop
    assert_tick_bar(out_t, out_j)
    mpc = out_t[7]
    if tc.control.kind == "MPC":
        nu = tc.control.mpc_n * tc.control.mpc_p
        assert mpc.z.shape == (B, nu) and mpc.u_d.shape == (B, nu)
        assert int(mpc.admm_ticks.sum()) > 0  # some ticks left the box
    else:
        assert mpc is None


@pytest.fixture(scope="module")
def jax_config4_run():
    jc, _ = CONFIG4
    sc = j_sc.batch_scenarios(jax.random.PRNGKey(0), B, jc, n_path=96)
    carry, metrics = jax.jit(jax.vmap(lambda g, e, o: j_cl.simulate_full(g, e, o, jc)))(
        sc.global_path, sc.ego0, sc.obstacles)
    return sc, jax.tree.map(np.asarray, carry), metrics


def test_simulate_full_config4_matches_jax(jax_config4_run):
    sc, carry_j, mj = jax_config4_run
    _, tc = CONFIG4
    carry_t, mt = t_cl.simulate_full(
        convert.path_from_numpy(sc.global_path), convert.ego_from_numpy(sc.ego0),
        convert.obstacles_from_numpy(sc.obstacles), tc, device="cpu")
    assert_metrics_match(mt, mj, j_cl.TickMetrics._fields, "config4.")
    sj = {k: float(v) for k, v in j_cl.summarize(mj).items()}
    st = {k: float(v) for k, v in t_cl.summarize(mt).items()}
    for k in sj:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-4, atol=5e-3, err_msg=k)
    # the carried controller state holds the MPC's (z, u_d), (B, 12) each
    # (the JAX kernel dispatch hands back the rebind's zeros)
    nu = tc.control.mpc_n * tc.control.mpc_p
    assert [tuple(a.shape) for a in carry_t.ctrl.mpc] == [(B, nu)] * 2
    from_jax = convert.carry_from_numpy(carry_j)
    for a, b in zip(from_jax.ctrl.mpc, carry_j.ctrl.mpc):
        np.testing.assert_array_equal(np_of(a), b)


def test_controller_state_rebind_zeroes_mpc():
    _, tc = CONFIG4
    cs = vehicle.ControllerState.init(tc.control, 3)
    assert [tuple(a.shape) for a in cs.mpc] == [(3, 12)] * 2
    busy = cs._replace(mpc=tuple(torch.ones(3, 12) for _ in range(2)))
    assert all(float(a.abs().sum()) == 0.0 for a in busy.rebind().mpc)
    assert vehicle.ControllerState.init(JC.control, 3).mpc is None


def test_simulate_mpc_dynamic_matches_oracle():
    """Config 4's controller/plant pair in the path loop, at the settings of
    ``test_fidelity.test_mpc_dynamic_closed_loop_matches_oracle``."""
    jc = dataclasses.replace(CONFIG4[0], loop=dataclasses.replace(
        j_config.EMConfig().loop, n_plans=N_PLANS))
    tc = convert.config_from_dict(dataclasses.asdict(jc))
    sc = j_sc.make_scenario(jax.random.PRNGKey(1), jc, with_dynamic=False,
                            n_active_static=2, v0=10.0)
    batch = jax.tree.map(lambda a: np.asarray(a)[None], sc)
    _, m = t_cl.simulate(
        convert.path_from_numpy(batch.global_path), convert.ego_from_numpy(batch.ego0),
        convert.obstacles_from_numpy(batch.obstacles), tc, device="cpu")
    g, ego0, statics, _ = unpack_scenario(sc)
    ox, oy = run_single_threaded(closed_loop_np.simulate, g, ego0, statics, jc,
                                 N_PLANS)
    px, py = np_of(m.x).reshape(-1), np_of(m.y).reshape(-1)
    assert len(ox) == len(px)
    rmse = lateral_rmse(px, py, ox, oy)
    assert rmse <= 0.05, f"port MPC/dynamic lateral RMSE vs oracle {rmse:.3f} m"


@pytest.mark.parametrize("ki,kd", [(0.0, 0.0), (0.3, 0.05)])
def test_pid_core_matches_jax(ki, kd):
    """``pid_core`` against the JAX package's PID, which always sums the
    error window and takes the derivative, on finite random buffers with and
    without integral separation. With ki = kd = 0 the port skips both (the
    tick kernel's choice) and the command, buffer and count are the same;
    with ki and kd nonzero it sums as the JAX PID does, in another order, so
    the command is held at float32 round-off."""
    rng = np.random.default_rng(4)
    jc = dataclasses.replace(JC, control=dataclasses.replace(JC.control, ki=ki, kd=kd))
    tc = convert.config_from_dict(dataclasses.asdict(jc))
    nb = jc.control.pid_buffer
    buf = rng.uniform(-2.0, 2.0, (64, nb)).astype(np.float32)
    count = rng.integers(0, nb + 1, 64).astype(np.int32)
    last = rng.uniform(-2.0, 2.0, 64).astype(np.float32)
    err = rng.uniform(-3.0, 3.0, 64).astype(np.float32)
    cmd_j, buf_j, cnt_j, _ = j_pid.pid_core(jnp.asarray(buf.T), jnp.asarray(count[None]),
                                            jnp.asarray(last[None]), jnp.asarray(err[None]),
                                            jc.control)
    cmd_t, buf_t, cnt_t, _ = t_pid.pid_core(t32(buf), torch.as_tensor(count), t32(last),
                                            t32(err), tc.control)
    np.testing.assert_array_equal(np_of(buf_t), np.asarray(buf_j).T)
    np.testing.assert_array_equal(np_of(cnt_t), np.asarray(cnt_j)[0])
    if ki == 0.0 and kd == 0.0:
        np.testing.assert_array_equal(np_of(cmd_t), np.asarray(cmd_j)[0])
    else:
        np.testing.assert_allclose(np_of(cmd_t), np.asarray(cmd_j)[0], rtol=1e-6, atol=1e-6)


def test_pid_core_skipped_window_keeps_nan_out():
    """With ki = kd = 0, ``pid_core`` (and the tick kernel with it) sums no
    window and takes no derivative, so a NaN error in the window does not
    reach the command: it is kp * error. The JAX PID always sums, and its
    0 * NaN makes the command NaN for as long as the NaN stays in the
    window. This is where the port departs from the JAX package."""
    jc = dataclasses.replace(JC, control=dataclasses.replace(JC.control, ki=0.0, kd=0.0))
    tc = convert.config_from_dict(dataclasses.asdict(jc))
    nb = jc.control.pid_buffer
    buf = np.full((2, nb), 0.5, np.float32)
    buf[:, nb - 3] = np.nan
    count = np.full(2, nb, np.int32)
    last = np.array([0.2, np.nan], np.float32)
    err = np.array([0.4, -0.7], np.float32)
    cmd_t, buf_t, cnt_t, _ = t_pid.pid_core(t32(buf), torch.as_tensor(count), t32(last),
                                            t32(err), tc.control)
    np.testing.assert_array_equal(np_of(cmd_t), np.float32(jc.control.kp) * err)
    assert np.isnan(np_of(buf_t)[:, nb - 4]).all()
    np.testing.assert_array_equal(np_of(cnt_t), count)
    cmd_j, *_ = j_pid.pid_core(jnp.asarray(buf.T), jnp.asarray(count[None]),
                               jnp.asarray(last[None]), jnp.asarray(err[None]), jc.control)
    assert np.isnan(np.asarray(cmd_j)).all()


def test_discretize_and_riccati_gain_match_jax():
    """The Tustin discretization and the fixed-trip Riccati iteration
    (``tests/test_control.py``'s inputs, at several speeds) against the JAX
    package's, batched over the speeds."""
    vp, cc = JC.vehicle, JC.control
    tc = convert.config_from_dict(dataclasses.asdict(JC))
    vxs = np.asarray([2.0, 8.0, 13.9, 25.0], np.float32)
    Q = np.diag(cc.lqr_q).astype(np.float32)
    R = np.array([[cc.lqr_r]], np.float32)
    A_t, B_t, _ = t_lat.error_state_model(torch.as_tensor(vxs), tc.vehicle)
    Ad_t, Bd_t, T_t = t_lat.discretize(A_t, B_t, cc.ts_discretize)
    K_t = t_lat.riccati_gain(Ad_t, Bd_t, torch.as_tensor(Q), torch.as_tensor(R),
                             cc.riccati_iters)
    assert K_t.shape == (len(vxs), 1, 4)
    for i, vx in enumerate(vxs):
        A, Bm, _ = j_lat.error_state_model(jnp.float32(vx), vp)
        Ad, Bd, T = j_lat.discretize(A, Bm, cc.ts_discretize)
        K = j_lat.riccati_gain(Ad, Bd, jnp.asarray(Q), jnp.asarray(R), cc.riccati_iters)
        for name, a, b in (("A_d", Ad_t[i], Ad), ("B_d", Bd_t[i], Bd), ("T", T_t[i], T),
                           ("K", K_t[i], K)):
            np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} at vx {vx}")
