"""PyTorch port, the utilities (``utils/checkpoint.py``, ``utils/profiling.py``,
``utils/report.py``) against the JAX package's.

Checkpoint: the round trip is bit-exact and keeps dtypes and devices, the
shard file loads under ``torch.load(weights_only=True)``, a template that
does not fit raises; ``resume_simulation`` from the same restored carry
(path ``LoopCarry``, full ``LoopCarry``, ``TrafficCarry``, each carried
across from the JAX package's run by ``convert``) against the JAX
package's ``resume_simulation`` at ``__graft_entry__._assert_metrics_match``'s
bar; and an NPC checkpointed mid lane change resumes and completes it
(``tests/test_aux.py``'s traffic-resume test, ported). Profiling: ``sync``
equals the JAX package's checksum (rtol 1e-6), ``stage_timer`` records its
stage, ``trace`` writes a trace holding an ``annotate`` region. Report:
``run_report`` equals the JAX package's on the same metrics (ints and bools
exact, floats rtol 1e-6), the plots and the GIF are written, and the camera
keyframes match the JAX package's at the camera frame bar
(``tests/test_torch_pixels.py``: at most 0.1 % of the pixels differ by more
than 1 in a channel).
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.sim import camera as j_cam
from emplanner_carla_tpu.sim import closed_loop as j_cl
from emplanner_carla_tpu.sim import scenario as j_sc
from emplanner_carla_tpu.types import EgoState as JEgo
from emplanner_carla_tpu.types import Obstacles as JObs
from emplanner_carla_tpu.types import Path as JPath
from emplanner_carla_tpu.utils import checkpoint as j_ckpt
from emplanner_carla_tpu.utils import profiling as j_prof
from emplanner_carla_tpu.utils import report as j_report
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.config import EMConfig as TCfg
from emplanner_carla_tpu_torch.sim import closed_loop as t_cl
from emplanner_carla_tpu_torch.sim import npc as t_npc
from emplanner_carla_tpu_torch.sim import scenario as t_sc
from emplanner_carla_tpu_torch.types import EgoState, Obstacles, Path
from emplanner_carla_tpu_torch.utils import checkpoint as t_ckpt
from emplanner_carla_tpu_torch.utils import profiling as t_prof
from emplanner_carla_tpu_torch.utils import report as t_report
from torch_port_helpers import assert_metrics_match, np_of, tensors_of

JC = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=2, plan_every=20))
TC = convert.config_from_dict(dataclasses.asdict(JC))
B = 2


@pytest.fixture(scope="module")
def lanes():
    """Two JAX scenarios, batched and one at a time."""
    sc = j_sc.batch_scenarios(jax.random.PRNGKey(5), B, JC, n_path=96)
    return sc, [jax.tree.map(lambda a, i=i: a[i], sc) for i in range(B)]


@pytest.fixture(scope="module")
def port_run():
    """A port run at batch 8 on the CPU: (scenarios, full LoopCarry,
    TickMetrics)."""
    sc = t_sc.batch_scenarios(11, 8, TC, device="cpu", n_path=96)
    carry, metrics = t_cl.simulate_full(*sc, TC, device="cpu")
    return sc, carry, metrics


def test_checkpoint_round_trip_is_exact(port_run, tmp_path):
    _, carry, metrics = port_run
    t_ckpt.save(str(tmp_path), carry, metrics)
    restored, m2 = t_ckpt.restore(str(tmp_path), carry, metrics)
    assert type(restored) is type(carry) and type(m2) is type(metrics)
    assert restored.ctrl.mpc is None and restored.qp_warm[1] is not None
    pairs = list(zip(tensors_of(restored), tensors_of(carry)))
    pairs += list(zip(tensors_of(m2), tensors_of(metrics)))
    assert len(pairs) == len(list(tensors_of(carry))) + len(metrics)
    for a, b in pairs:
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    # one shard file, a flat dict of tensors that loads without pickled code
    files = glob.glob(str(tmp_path / "*.pt"))
    assert [os.path.basename(f) for f in files] == ["shard-00000-of-00001.pt"]
    flat = torch.load(files[0], weights_only=True)
    assert all(isinstance(k, str) and isinstance(v, torch.Tensor) for k, v in flat.items())
    assert torch.equal(flat["carry/ego/x"], carry.ego.x)


def test_checkpoint_template_must_fit(port_run, tmp_path):
    _, carry, _ = port_run
    t_ckpt.save(str(tmp_path), carry)
    short = carry._replace(ego=carry.ego._replace(x=carry.ego.x[:4]))
    with pytest.raises(ValueError, match="shape"):
        t_ckpt.restore(str(tmp_path), short)
    # a field the checkpoint lacks: an MPC state where the carry had none
    mpc = carry._replace(ctrl=carry.ctrl._replace(mpc=(torch.zeros(8, 12),)))
    with pytest.raises(ValueError, match="no field"):
        t_ckpt.restore(str(tmp_path), mpc)


def _jax_runs(lanes_, run, resume):
    """Per lane: the JAX run's carry and the JAX resume's metrics, stacked
    over the lanes (the unbatched calls share one compiled program)."""
    carries, metrics = [], []
    for sc in lanes_:
        carry, _ = run(sc)
        metrics.append(resume(sc, carry)[1])
        carries.append(carry)
    stack = lambda *a: np.stack([np.asarray(x) for x in a])  # noqa: E731
    return jax.tree.map(stack, *carries), jax.tree.map(stack, *metrics)


@pytest.mark.parametrize("kind", ["path", "full", "traffic"])
def test_resume_matches_jax(lanes, kind, tmp_path):
    sc, lanes_ = lanes
    full = kind == "full"
    if kind == "traffic":
        run = lambda s: j_cl.simulate_traffic(*s, JC, behavior="normal")  # noqa: E731
        to_port = convert.traffic_carry_from_numpy
    else:
        sim = j_cl.simulate_full if full else j_cl.simulate
        run = lambda s: sim(*s, JC)  # noqa: E731
        to_port = convert.carry_from_numpy
    j_carry, j_m = _jax_runs(
        lanes_, run,
        lambda s, c: j_ckpt.resume_simulation(s.global_path, c, JC, n_plans=2, full=full,
                                              behavior="normal"))
    carry = to_port(j_carry)
    t_ckpt.save(str(tmp_path), carry)
    restored = t_ckpt.restore(str(tmp_path), carry)
    gp = convert.path_from_numpy(sc.global_path)
    _, m = t_ckpt.resume_simulation(gp, restored, TC, n_plans=2, full=full,
                                     behavior="normal", device="cpu")
    assert m.x.shape == (B, 2, 20)
    assert_metrics_match(m, j_m, t_cl.TickMetrics._fields, f"resume {kind}: ")
    # the resume continues from the restored pose
    ego0 = restored.loop.ego if kind == "traffic" else restored.ego
    assert bool((m.x[:, 0, 0] != ego0.x).all())


def test_traffic_resume_continues_lane_change(tmp_path):
    """An NPC checkpointed mid lane change resumes and completes the
    manoeuvre instead of snapping back to the centre."""
    cfg = TCfg(loop=dataclasses.replace(TCfg().loop, n_plans=2))
    n = 200
    s_ax = torch.arange(n, dtype=torch.float32)[None] * 2.0
    z = torch.zeros((1, n))
    gp = Path(s_ax, z, z, z)
    K = cfg.n_static_obs + cfg.n_dynamic_obs
    d0 = cfg.n_static_obs
    # a parked car blocks the agent NPC's lane
    ox = torch.zeros((1, K))
    ox[0, 0], ox[0, d0] = 60.0, 20.0
    ovx = torch.zeros((1, K))
    ovx[0, d0] = 8.0
    valid = torch.zeros((1, K), dtype=torch.bool)
    valid[0, 0] = valid[0, d0] = True
    obstacles = Obstacles(ox, torch.zeros((1, K)), ovx, torch.zeros((1, K)), valid)
    z1 = torch.zeros(1)
    ego0 = EgoState(gp.x[:, 0], z1, z1, torch.full((1,), 5.0), z1, z1, z1, z1, z1)

    carry, _ = t_cl.simulate_traffic(gp, ego0, obstacles, cfg, behavior="normal",
                                     device="cpu")
    off_mid = float(carry.npc_lane.offset[0, d0])
    assert 0.5 < off_mid < 3.4, off_mid   # checkpointed mid manoeuvre
    assert isinstance(carry.npc_lane, t_npc.LaneState)

    t_ckpt.save(str(tmp_path), carry)
    restored = t_ckpt.restore(str(tmp_path), carry)
    carry2, m2 = t_ckpt.resume_simulation(gp, restored, cfg, n_plans=2,
                                          behavior="normal", device="cpu")
    assert bool(torch.isfinite(m2.lateral_err).all())
    off_end = float(carry2.npc_lane.offset[0, d0])
    assert off_end > off_mid
    assert float(carry2.npc_lane.target[0, d0]) == 3.5
    assert not bool(m2.collided.any())


def test_sync_equals_jax_checksum():
    rng = np.random.default_rng(0)
    arrays = (rng.normal(size=(8, 33)).astype(np.float32),
              rng.integers(-5, 5, size=(4, 7)).astype(np.int32),
              rng.normal(size=(3, 2, 5)).astype(np.float32) * 1e3,
              rng.random(size=(16,)) > 0.5)
    tree = {"a": arrays[0], "b": (arrays[1], [arrays[2], arrays[3]])}
    port = t_prof.sync({"a": torch.as_tensor(arrays[0]),
                        "b": (torch.as_tensor(arrays[1]),
                              [torch.as_tensor(arrays[2]), torch.as_tensor(arrays[3])])})
    ref = j_prof.sync(jax.tree.map(jnp.asarray, tree))
    assert isinstance(port, float)
    np.testing.assert_allclose(port, ref, rtol=1e-6)
    assert t_prof.sync(()) == 0.0


def test_stage_timer_and_trace(tmp_path):
    results = {}
    x = torch.arange(1000, dtype=torch.float32)
    with t_prof.stage_timer("stage a", results):
        assert t_prof.sync(x * 2.0) == float(999 * 1000)
    assert list(results) == ["stage a"] and results["stage a"] > 0.0
    with t_prof.trace(str(tmp_path / "trace")) as logdir:
        with t_prof.annotate("port region"):
            (x @ x).item()
    assert logdir == str(tmp_path / "trace")
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "port region" for e in events)


@pytest.fixture(scope="module")
def one_lane():
    """One lane of a port run of 3 plans x 100 ticks (``tests/test_aux.py``'s
    report run): (config, batch-1 scenario, batch-1 metrics)."""
    cfg = TCfg(loop=dataclasses.replace(TCfg().loop, n_plans=3))
    sc = t_sc.make_scenario(0, cfg, device="cpu")
    _, m = t_cl.simulate(*sc, cfg, device="cpu")
    return cfg, sc, m


def test_run_report_equals_jax(one_lane, tmp_path):
    cfg, _, m = one_lane
    jcfg = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=3))
    out = t_report.run_report(m, cfg, path=str(tmp_path / "r.json"))
    ref = j_report.run_report(type(m)(*[np_of(f) for f in m]), jcfg)
    assert list(out) == list(ref)
    for k, v in ref.items():
        assert type(out[k]) is type(v), k
        if isinstance(v, float):
            np.testing.assert_allclose(out[k], v, rtol=1e-6, err_msg=k)
        else:
            assert out[k] == v, k
    assert out["ticks"] == 300 and out["distance_m"] > 10.0
    with open(tmp_path / "r.json") as fh:
        assert json.load(fh) == out


def test_plots_and_animation(one_lane, tmp_path):
    from PIL import Image

    from emplanner_carla_tpu_torch.sim import camera as t_cam

    cfg, sc, m = one_lane
    t_report.plot_run(m, sc, cfg, path=str(tmp_path / "run.png"))
    assert (tmp_path / "run.png").stat().st_size > 10000
    p = t_report.animate_run(m, sc, cfg, path=str(tmp_path / "run.gif"), every=50,
                             camera=True, device="cpu")
    img = Image.open(p)
    assert img.format == "GIF"
    assert getattr(img, "n_frames", 1) == (3 * 100 + 49) // 50
    assert (tmp_path / "run.gif").stat().st_size > 20000
    frame = t_cam.render(sc.ego0, sc.global_path, sc.obstacles)
    t_report.plot_camera_frame(frame, path=str(tmp_path / "cam.png"))
    assert (tmp_path / "cam.png").stat().st_size > 10000


def test_camera_keyframes_match_jax(one_lane):
    cfg, sc, m = one_lane
    every = 50
    rgb = np_of(t_report.camera_keyframes(m, sc, cfg, every=every, device="cpu"))
    # the JAX package's keyframes (utils/report.py animate_run, camera=True)
    x, y = np_of(m.x).reshape(-1), np_of(m.y).reshape(-1)
    spd, phi = np_of(m.speed_kmh).reshape(-1), np_of(m.heading).reshape(-1)
    dt = cfg.plant.dt
    ks = np.arange(0, len(x), every)
    gp = JPath(*[jnp.asarray(np_of(a)[0]) for a in sc.global_path])
    ov = JObs(*[jnp.asarray(np_of(a)[0]) for a in sc.obstacles])
    cam_cfg = j_cam.CameraConfig()

    def frame_at(xk, yk, pk, vk, tk):
        zz = jnp.zeros(())
        ego = JEgo(xk, yk, pk, vk, zz, zz, zz, zz, zz)
        obs_t = ov._replace(x=ov.x + ov.vx * tk, y=ov.y + ov.vy * tk)
        return j_cam.rgb_frame(j_cam.render(ego, gp, obs_t, cam_cfg), cam_cfg)

    ref = np.asarray(jax.jit(jax.vmap(frame_at))(
        jnp.asarray(x[ks], jnp.float32), jnp.asarray(y[ks], jnp.float32),
        jnp.asarray(phi[ks], jnp.float32), jnp.asarray(spd[ks] / 3.6, jnp.float32),
        jnp.asarray((ks + 1) * dt, jnp.float32)))
    assert rgb.dtype == np.uint8 and rgb.shape == ref.shape == (len(ks), 64, 96, 3)
    off = (np.abs(rgb.astype(int) - ref).max(-1) > 1).mean()
    assert off <= 1e-3, off
