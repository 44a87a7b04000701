"""PyTorch port, driving from pixels: the camera (``render_columns``,
``render``, ``rgb_frame``), the detector (``detect``,
``detect_from_columns``), the tracker (``update_tracks``), the pixel loop
(``simulate_pixels``, path-only and full EM) and the sensor models, each
against ``jax.vmap`` of its JAX-package counterpart on the same inputs.

Bars: column presence, class ids, every detection and tracker decision
(validity, boxes, counts) identical; the column view's near-face depth
within rtol 1e-5 plus eight float32 unit roundoffs times its root's
condition number (the depth is a root whose discriminant cancels, most at
the grazing silhouette-edge columns, where the two libraries' last-ulp sin /
cos and multiply-add contraction differences grow), and 95 % of the columns
within rtol 1e-5 alone; the frame's depth within rtol 1e-5 on interior
pixels and 1e-4 on silhouette edges; the detector fed the same views and
frames, the tracker and the sensors within rtol 1e-5 / atol 1e-5 (bearings
and positions through ``atan`` / ``sin`` / ``cos`` of two libraries); the
closed loop at ``__graft_entry__._assert_metrics_match``'s bar, rtol 1e-5 /
atol 5 mm with decisions identical, ``n_tracked`` identical and
``perc_err`` at the same float bar.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.sim import camera as j_cam
from emplanner_carla_tpu.sim import detector as j_det
from emplanner_carla_tpu.sim import pixel_loop as j_pix
from emplanner_carla_tpu.sim import scenario as j_sc
from emplanner_carla_tpu.sim import sensors as j_sens
from emplanner_carla_tpu.types import EgoState as JEgo
from emplanner_carla_tpu.types import Obstacles as JObs
from emplanner_carla_tpu.types import Path as JPath
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.sim import camera as t_cam
from emplanner_carla_tpu_torch.sim import closed_loop as t_cl
from emplanner_carla_tpu_torch.sim import detector as t_det
from emplanner_carla_tpu_torch.sim import pixel_loop as t_pix
from emplanner_carla_tpu_torch.sim import sensors as t_sens
from emplanner_carla_tpu_torch.types import EgoState as TEgo
from emplanner_carla_tpu_torch.types import Obstacles as TObs
from emplanner_carla_tpu_torch.types import Path as TPath
from torch_port_helpers import assert_metrics_match, column_depth_bar, np_of

F32 = np.float32
K = 12
CAM = j_cam.CameraConfig()


def _layout(seed: int, B: int = 48):
    """Random egos and obstacle layouts in front of them, with walkers; lane
    0 holds a partially occluding pair, lane 1 two slots at the same spot
    (equal depth: the lower slot wins), lane 2 a walker behind a vehicle."""
    rng = np.random.default_rng(seed)
    ego = [rng.uniform(-5, 5, B), rng.uniform(-5, 5, B), rng.uniform(-np.pi, np.pi, B),
           rng.uniform(0, 10, B), rng.uniform(-0.5, 0.5, B), rng.uniform(-0.3, 0.3, B),
           rng.uniform(-1, 1, B), rng.uniform(-1, 1, B), np.zeros(B)]
    ego = [a.astype(F32) for a in ego]
    r = rng.uniform(3.0, 40.0, (B, K))
    az = rng.uniform(-0.9, 0.9, (B, K))
    valid = rng.uniform(size=(B, K)) < 0.7
    walk = rng.uniform(size=(B, K)) < 0.3
    for lane, rs, azs in ((0, (12.0, 16.0), (0.05, 0.12)), (1, (15.0, 15.0), (0.1, 0.1)),
                          (2, (10.0, 14.0), (-0.2, -0.21))):
        r[lane, :2], az[lane, :2] = rs, azs
        valid[lane, :2] = True
        walk[lane, :2] = (False, lane == 2)
    ox = ego[0][:, None] + r * np.cos(ego[2][:, None] + az)
    oy = ego[1][:, None] + r * np.sin(ego[2][:, None] + az)
    vx, vy = rng.uniform(-3, 3, (B, K)), rng.uniform(-3, 3, (B, K))
    obs = [a.astype(F32) for a in (ox, oy, vx, vy)] + [valid]
    return ego, obs, walk


def _jax_ego(ego):
    return JEgo(*map(jnp.asarray, ego))


def _torch_ego(ego):
    return TEgo(*(torch.as_tensor(np.array(a)) for a in ego))


def _jax_obs(obs):
    return JObs(*map(jnp.asarray, obs))


def _torch_obs(obs):
    return TObs(*(torch.as_tensor(np.array(a)) for a in obs))


@pytest.mark.parametrize("seed", (0, 1))
def test_render_columns_matches_jax(seed):
    ego, obs, walk = _layout(seed)
    ref = jax.vmap(lambda e, o, w: j_cam.render_columns(e, o, CAM, is_walker=w))(
        _jax_ego(ego), _jax_obs(obs), jnp.asarray(walk))
    out = t_cam.render_columns(_torch_ego(ego), _torch_obs(obs), CAM,
                               is_walker=torch.as_tensor(walk))
    col_j, col_t = np.asarray(ref.col), np_of(out.col)
    np.testing.assert_array_equal(col_t, col_j)
    assert col_t.sum() > 500
    d_j, d_t = np.asarray(ref.col_d), np_of(out.col_d)
    for c in (0, 1):
        ref = d_j[:, c].astype(np.float64)
        bar = column_depth_bar(ego, obs, walk, ref, bool(c), CAM)
        err = np.abs(d_t[:, c] - ref)
        present = col_j[:, c]
        assert np.all(err[present] <= bar[present]), f"class {c}: max err {err.max()}"
        assert np.all(d_t[:, c][~present] == t_cam.BIG)
        # and 95 % of the present columns at rtol 1e-5 alone
        assert np.mean(err[present] <= 1e-5 * ref[present]) >= 0.95
    # equal depth: lane 1's slot 0 hides slot 1 entirely, so the column view
    # is the one-car view
    solo = [a.copy() for a in obs]
    solo[4][1, 1] = False
    one = t_cam.render_columns(_torch_ego(ego), _torch_obs(solo), CAM,
                               is_walker=torch.as_tensor(walk))
    assert torch.equal(one.col[1], out.col[1]) and torch.equal(one.col_d[1], out.col_d[1])


def _path(B, n=128):
    x = np.tile(np.arange(n, dtype=F32) * 2.0 - 60.0, (B, 1))
    z = np.zeros((B, n), F32)
    return x, np.full((B, n), 1.5, F32), z, z


def test_render_frame_and_rgb_match_jax():
    ego, obs, walk = _layout(2, B=6)
    gp = _path(6)
    ref = jax.vmap(lambda e, g, o, w: j_cam.render(e, g, o, CAM, is_walker=w))(
        _jax_ego(ego), JPath(*map(jnp.asarray, gp)), _jax_obs(obs), jnp.asarray(walk))
    out = t_cam.render(_torch_ego(ego), TPath(*map(torch.as_tensor, gp)), _torch_obs(obs),
                       CAM, is_walker=torch.as_tensor(walk))
    sem_j, sem_t = np.asarray(ref.semantic), np_of(out.semantic)
    assert sem_t.dtype == np.int32
    # ray/cylinder and road-band boundaries decided by a last ulp: a few
    # pixels of a frame at most
    same = sem_t == sem_j
    assert same.mean() > 0.999
    for c in range(5):
        assert (sem_t == c).any() == (sem_j == c).any()
    # interior pixels (the four neighbours of the same class) at rtol 1e-5;
    # silhouette edges, where a ray grazes its cylinder and the root is
    # ill-conditioned, at rtol 1e-4
    pad = np.pad(sem_j, ((0, 0), (1, 1), (1, 1)), mode="edge")
    interior = same & (pad[:, :-2, 1:-1] == sem_j) & (pad[:, 2:, 1:-1] == sem_j) \
        & (pad[:, 1:-1, :-2] == sem_j) & (pad[:, 1:-1, 2:] == sem_j)
    edge = same & ~interior
    d_t, d_j = np_of(out.depth), np.asarray(ref.depth)
    fl_t, fl_j = np_of(out.flow), np.asarray(ref.flow)
    np.testing.assert_allclose(d_t[interior], d_j[interior], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_t[edge], d_j[edge], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(fl_t[interior], fl_j[interior], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(fl_t[edge], fl_j[edge], rtol=1e-4, atol=1e-3)
    assert interior.mean() > 0.9
    rgb_j = np.asarray(jax.vmap(lambda fr: j_cam.rgb_frame(fr, CAM))(ref))
    rgb_t = np_of(t_cam.rgb_frame(out, CAM))
    assert rgb_t.dtype == np.uint8 and rgb_t.shape == rgb_j.shape
    assert np.abs(rgb_t[same].astype(int) - rgb_j[same]).max() <= 1
    # without the road classes every ground pixel is TERRAIN
    bare = t_cam.render(_torch_ego(ego), TPath(*map(torch.as_tensor, gp)), _torch_obs(obs),
                        CAM, is_walker=torch.as_tensor(walk), road_classes=False)
    assert not bool((bare.semantic == t_cam.ROAD).any())
    assert torch.equal(bare.depth, out.depth)


def _assert_detections(out, ref, label):
    for name, a, b in zip(ref._fields, out, ref):
        a, b = np_of(a), np.asarray(b)
        assert a.shape == b.shape, f"{label}{name}"
        if b.dtype in (np.bool_, np.int32):
            assert a.dtype == b.dtype, f"{label}{name}"
            np.testing.assert_array_equal(a, b, err_msg=f"{label}{name}")
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f"{label}{name}")


def _edge_columns(B=4, W=96):
    """Column views with a run touching each frame edge (no fit there), a
    run split by a depth step of 2 m, single-column runs and a run whose
    minimum is flat (zero curvature: no fit)."""
    col = np.zeros((B, 2, W), bool)
    col_d = np.full((B, 2, W), 1e9, F32)
    u = np.arange(W)

    def put(b, c, lo, hi, d0, step=None):
        cols = slice(lo, hi)
        col[b, c, cols] = True
        col_d[b, c, cols] = d0 + 0.02 * (u[cols] - (lo + hi) / 2.0) ** 2
        if step is not None:
            col_d[b, c, step:hi] += 2.0

    put(0, 0, 0, 6, 10.0)                 # left frame edge, minimum at column 0
    put(0, 0, 40, 52, 12.0, step=47)      # one run split in two by a 2 m step
    put(0, 1, 90, 96, 8.0)                # right frame edge
    put(1, 0, 20, 21, 15.0)               # single column
    put(1, 1, 30, 38, 20.0)
    col_d[1, 1, 33:35] = 20.0             # flat minimum
    put(2, 0, 10, 14, 5.0)
    put(2, 0, 14, 20, 9.0)                # adjacent runs, split at the step
    put(3, 0, 1, 9, 30.0)                 # minimum next to the edge: fit
    return col, col_d


def test_detect_from_columns_matches_jax():
    """The same column views through both detectors (the views of a random
    layout and hand-made edge, split and flat cases): identical runs, boxes
    and validity, floats at the bar."""
    ego, obs, walk = _layout(3)
    views = jax.vmap(lambda e, o, w: j_cam.render_columns(e, o, CAM, is_walker=w))(
        _jax_ego(ego), _jax_obs(obs), jnp.asarray(walk))
    col, col_d = _edge_columns()
    for label, v, e in (
        ("layout.", views, ego),
        ("edges.", j_cam.ColumnView(jnp.asarray(col), jnp.asarray(col_d)),
         [a[:4] for a in ego]),
    ):
        ref = jax.vmap(lambda c, eg: j_det.detect_from_columns(c, eg, CAM))(v, _jax_ego(e))
        tv = t_cam.ColumnView(*(torch.as_tensor(np.array(a)) for a in v))
        out = t_det.detect_from_columns(tv, _torch_ego(e), CAM)
        _assert_detections(out, ref, label)
        assert bool(out.valid.any())
    # the split: lane 0's 40..51 run is two vehicle detections
    u_min = np_of(out.u_min[0])
    assert 40 in u_min and 47 in u_min


def test_detect_frame_matches_jax():
    """``detect`` on the same rendered frames (JAX's), both packages."""
    ego, obs, walk = _layout(4, B=8)
    gp = JPath(*map(jnp.asarray, _path(8)))
    frames = jax.vmap(lambda e, g, o, w: j_cam.render(e, g, o, CAM, is_walker=w,
                                                      road_classes=False))(
        _jax_ego(ego), gp, _jax_obs(obs), jnp.asarray(walk))
    ref = jax.vmap(lambda fr, e: j_det.detect(fr, e, CAM))(frames, _jax_ego(ego))
    tf = t_cam.CameraFrame(*(torch.as_tensor(np.array(a)) for a in frames))
    out = t_det.detect(tf, _torch_ego(ego), CAM)
    _assert_detections(out, ref, "frame.")
    assert int(out.valid.sum()) >= 8


def _det(x, y, depth, valid, D=8):
    """Detections of (steps, B, D) arrays (the tracker reads x, y, depth and
    valid)."""
    x, y, depth = (np.asarray(a, F32) for a in (x, y, depth))
    valid = np.asarray(valid, bool)
    zi = np.zeros(valid.shape, np.int32)
    zf = np.zeros(valid.shape, F32)
    return (zi, zi, zi, zi, depth, zf, x, y, np.full(valid.shape, 3, np.int32), valid)


def _scripted():
    """One lane's script (plan_dt 0.4 s, so the 12 m gate admits an implied
    27.5 m/s that VEL_MAX rejects): a parked car A seen three times (static
    confirmation), then lost (coasting on its long budget of four cycles,
    then gone); a mover B matched, missing for one cycle (coasting), matched
    again, then lost; a detection C 11 m from B's prediction (rejected: a
    fresh track at rest)."""
    D = 8
    steps = []
    a = (20.0, 1.0)
    b = [(30.0, -1.0), (32.0, -1.0), None, (36.0, -1.0), (38.0, -1.0)]
    for t in range(9):
        xs, ys, vs = [0.0] * D, [0.0] * D, [False] * D
        if t < 3:
            xs[0], ys[0], vs[0] = a[0] + 0.02 * t, a[1], True
        if t < len(b) and b[t] is not None:
            xs[2], ys[2], vs[2] = b[t][0], b[t][1], True
        if t == 5:
            xs[1], ys[1], vs[1] = 40.0 + 11.0, -1.0, True
        steps.append((xs, ys, [15.0] * D, vs))
    return [_det(*(np.asarray(c)[None] for c in s)) for s in steps]


def _random_steps(steps=10, B=16, D=8, seed=7):
    rng = np.random.default_rng(seed)
    base_x = rng.uniform(5, 40, (B, D))
    base_y = rng.uniform(-6, 6, (B, D))
    vel = np.where(rng.uniform(size=(B, D)) < 0.5, 0.0, rng.uniform(-8, 8, (B, D)))
    out = []
    for t in range(steps):
        x = base_x + vel * 0.4 * t + rng.normal(0, 0.05, (B, D))
        y = base_y + rng.normal(0, 0.05, (B, D))
        valid = rng.uniform(size=(B, D)) < 0.7
        perm = rng.permuted(np.tile(np.arange(D), (B, 1)), axis=1)
        x, y, valid = (np.take_along_axis(a, perm, 1) for a in (x, y, valid))
        out.append(_det(x, y, rng.uniform(2, 40, (B, D)), valid))
    return out


@pytest.mark.parametrize("script", ("scripted", "random"))
def test_update_tracks_matches_jax(script):
    seq = _scripted() if script == "scripted" else _random_steps()
    B, D = seq[0][9].shape
    plan_dt = 0.4
    tj = jax.vmap(lambda _: j_pix.Tracks.init(D))(jnp.arange(B))
    tt = t_pix.Tracks.init(B, D)
    upd = jax.jit(jax.vmap(lambda d, t: j_pix.update_tracks(d, t, plan_dt)))
    history = []
    for step, d in enumerate(seq):
        tj = upd(j_det.Detections(*map(jnp.asarray, d)), tj)
        tt = t_pix.update_tracks(t_det.Detections(*(torch.as_tensor(np.array(a)) for a in d)),
                                 tt, plan_dt)
        for name, a, b in zip(tj._fields, tt, tj):
            a, b = np_of(a), np.asarray(b)
            assert a.dtype == b.dtype, name
            if b.dtype in (np.bool_, np.int32):
                np.testing.assert_array_equal(a, b, err_msg=f"step {step} {name}")
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                           err_msg=f"step {step} {name}")
        history.append(tt)
    if script == "scripted":
        conf = [int(t.static_conf[0].max()) for t in history]
        miss = [int(t.misses[0].max()) for t in history]
        n = [int(t.valid[0].sum()) for t in history]
        assert conf[2] >= t_pix.STATIC_CONF            # A confirmed static
        assert miss[2] == 1 and n[2] == 2              # B coasts through its gap
        assert max(miss) == t_pix.STATIC_MAX_MISSES    # A's long budget is spent
        assert n[7] == 1 and float(history[7].x[0].max()) == 51.0   # A is gone
        # C starts at rest (VEL_MAX rejects the 27.5 m/s association) while
        # B coasts on at its velocity
        assert float(history[5].vx[0, 1]) == 0.0 and float(history[5].vx[0, 2]) == 5.0
        assert n[-1] == 0


@pytest.fixture(scope="module")
def pixel_scenarios():
    jc = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=2, plan_every=20))
    return jc, j_sc.batch_scenarios(jax.random.PRNGKey(0), 4, jc, n_path=96)


@pytest.mark.parametrize("full", (False, True))
def test_simulate_pixels_matches_jax(pixel_scenarios, full):
    """4 lanes x 2 plans of the pixel loop, path-only and full EM."""
    jc, sc = pixel_scenarios
    tc = convert.config_from_dict(dataclasses.asdict(jc))
    _, m_j = jax.jit(jax.vmap(
        lambda g, e, o: j_pix.simulate_pixels(g, e, o, jc, full=full)))(*sc)
    before = dict(t_cl.launches)
    _, m_t = t_pix.simulate_pixels(
        convert.path_from_numpy(sc.global_path), convert.ego_from_numpy(sc.ego0),
        convert.obstacles_from_numpy(sc.obstacles), tc, full=full, device="cpu")
    assert t_cl.launches == before      # CPU tensors: the plain tick loop
    assert_metrics_match(m_t.ticks, m_j.ticks, t_cl.TickMetrics._fields, "ticks.")
    assert_metrics_match(m_t, m_j, ("n_tracked", "perc_err"), "pixels.")
    assert m_t.n_tracked.dtype == torch.int32
    assert int(m_t.n_tracked.min()) >= 1


def test_sensors_match_jax():
    ego, obs, _ = _layout(9, B=16)
    je, jo = _jax_ego(ego), _jax_obs(obs)
    te, to = _torch_ego(ego), _torch_obs(obs)

    def close(a, b, name):
        a, b = np_of(a), np.asarray(b)
        assert a.shape == b.shape, name
        if b.dtype == np.bool_:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)

    close(t_sens.collision_depth(te, to, radius=12.0),
          jax.vmap(lambda e, o: j_sens.collision_depth(e, o, radius=12.0))(je, jo), "pen")
    for dyn in (True, False):
        close(t_sens.obstacle_detector(te, to, hit_radius=25.0, dynamics_only=dyn),
              jax.vmap(lambda e, o: j_sens.obstacle_detector(e, o, 25.0, dyn))(je, jo),
              "detector")
    rt = t_sens.radar(te, to, max_range=30.0)
    rj = jax.vmap(lambda e, o: j_sens.radar(e, o, max_range=30.0))(je, jo)
    for name, a, b in zip(rj._fields, rt, rj):
        close(a, b, f"radar.{name}")
    for a, b in zip(t_sens.imu(te), jax.vmap(j_sens.imu)(je)):
        close(a, b, "imu")
    for a, b in zip(t_sens.gnss(te), jax.vmap(lambda e: j_sens.gnss(e))(je)):
        close(a, b, "gnss")
    # sigma 0 is exact even with a generator
    gen = torch.Generator().manual_seed(0)
    assert all(torch.equal(a, b) for a, b in zip(t_sens.gnss(te, gen, 0.0), (te.x, te.y)))
    noisy = t_sens.gnss(te, gen, 0.5)
    assert not torch.equal(noisy[0], te.x) and float((noisy[0] - te.x).abs().max()) < 5.0
    for lat0, lon0 in ((0.0, 0.0), (48.5, 11.0)):
        gt = t_sens.gnss_geodetic(te, lat0, lon0, 12.0)
        gj = jax.vmap(lambda e: j_sens.gnss_geodetic(e, lat0, lon0, 12.0))(je)
        for name, a, b in zip(gj._fields, gt, gj):
            close(a, b, f"geodetic.{name}")
    # lane invasion against a straight lane along y = 1.5
    gp = _path(16, n=96)
    s_map = np.tile(np.arange(96, dtype=F32) * 2.0 - 60.0, (16, 1))
    lt = t_sens.lane_invasion(te, TPath(*map(torch.as_tensor, gp)), torch.as_tensor(s_map))
    lj = jax.vmap(lambda e, x, y, th, k, s: j_sens.lane_invasion(e, JPath(x, y, th, k), s))(
        je, *map(jnp.asarray, gp), jnp.asarray(s_map))
    close(lt, lj, "lane_invasion")
    assert bool(lt.any()) and not bool(lt.all())
