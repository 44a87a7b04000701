"""Post-run reporting: plots and structured summaries (counterpart of
``emplanner_carla_tpu/utils/report.py``).

The closed loops return their observability as TickMetrics tensors; this
module renders one scenario's on the host, from NumPy copies. Pass one
lane's metrics and scenario (``metrics[0]``-style slices, or a batch of
one): every array is flattened, as the JAX package does. The camera
keyframes of an animation render in one batched call on the device
(:func:`camera_keyframes`). matplotlib and PIL are imported inside the
plotting functions only.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from emplanner_carla_tpu_torch.sim import camera as cam_mod
from emplanner_carla_tpu_torch.types import EgoState


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _flat(a) -> np.ndarray:
    return _np(a).reshape(-1)


def run_report(metrics, cfg, path: str | None = None) -> dict:
    """Scalar roll-up of one scenario's TickMetrics (host-side).

    Returns (and optionally writes as JSON) the run summary: RMSE, speed
    stats, collision/arrival flags, distance travelled.
    """
    lat = _flat(metrics.lateral_err)
    spd = _flat(metrics.speed_kmh)
    x = _flat(metrics.x)
    y = _flat(metrics.y)
    out = {
        "ticks": int(lat.size),
        "sim_seconds": float(lat.size * cfg.plant.dt),
        "lateral_rmse_m": float(np.sqrt(np.mean(lat**2))),
        "lateral_max_m": float(np.max(np.abs(lat))),
        "speed_mean_kmh": float(spd.mean()),
        "speed_max_kmh": float(spd.max()),
        "distance_m": float(np.sum(np.hypot(np.diff(x), np.diff(y)))),
        "collided": bool(_np(metrics.collided).any()),
        "arrived": bool(_np(metrics.arrived).any()),
    }
    if path is not None:
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_run(metrics, scenario=None, cfg=None, path: str = "run.png"):
    """Trajectory + speed + heading + lateral-error panel (the post-run
    matplotlib plots of ``test_3.py:142-152`` and the debug-draw overlay of
    ``test_9.py:410-433``, rendered offline)."""
    plt = _plt()
    x = _flat(metrics.x)
    y = _flat(metrics.y)
    spd = _flat(metrics.speed_kmh)
    lat = _flat(metrics.lateral_err)
    heading = _flat(metrics.heading)
    dt = cfg.plant.dt if cfg is not None else 0.01
    t = np.arange(len(spd)) * dt

    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    ax = axes[0, 0]
    if scenario is not None:
        gp = scenario.global_path
        ax.plot(_flat(gp.x), _flat(gp.y), "k--", lw=0.8, label="global path")
        ov = _flat(scenario.obstacles.valid)
        ax.scatter(_flat(scenario.obstacles.x)[ov], _flat(scenario.obstacles.y)[ov],
                   c="red", marker="s", s=40, label="obstacles")
    ax.plot(x, y, "b-", lw=1.2, label="ego")
    ax.set_title("trajectory")
    ax.axis("equal")
    ax.legend(fontsize=8)

    axes[0, 1].plot(t, spd)
    axes[0, 1].set_title("speed (km/h)")
    axes[1, 0].plot(t, lat)
    axes[1, 0].set_title("lateral error (m)")
    axes[1, 1].plot(t, np.unwrap(heading))
    axes[1, 1].set_title("heading (rad)")
    for a in axes.flat:
        a.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def _keyframe_ticks(n_ticks: int, every: int) -> np.ndarray:
    """The ticks an animation draws: every ``every``-th from tick 0."""
    return np.arange(0, n_ticks, max(int(every), 1))


def camera_keyframes(metrics, scenario, cfg=None, every: int = 10, device="cuda"):
    """The ego camera's RGB view at every keyframe of one scenario's
    rollout, (F, H, W, 3) uint8 on ``device`` (the card unless the caller
    asks for the CPU): one batch row a keyframe, rendered in one call
    (``camera.render`` and ``rgb_frame``) from the recorded ego poses, with
    the obstacles advanced at constant velocity from the scenario's initial
    state (exact for ``simulate``/``simulate_full`` rollouts; for agent
    traffic it shows the constant-velocity approximation)."""
    x = _flat(metrics.x)
    y = _flat(metrics.y)
    spd = _flat(metrics.speed_kmh)
    phi = _flat(metrics.heading)
    dt = cfg.plant.dt if cfg is not None else 0.01
    ks = _keyframe_ticks(len(x), every)
    F = len(ks)
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    z = torch.zeros(F, dtype=torch.float32, device=device)
    ego = EgoState(t32(x[ks]), t32(y[ks]), t32(phi[ks]), t32(spd[ks] / 3.6),
                   z, z, z, z, z)
    tk = t32((ks + 1) * dt)[:, None]
    gp = type(scenario.global_path)(
        *[t32(_flat(f))[None].expand(F, -1) for f in scenario.global_path])
    ov = scenario.obstacles
    row = lambda a: t32(_flat(a))[None].expand(F, -1)  # noqa: E731
    vx, vy = row(ov.vx), row(ov.vy)
    obs = type(ov)(row(ov.x) + vx * tk, row(ov.y) + vy * tk, vx, vy,
                   torch.as_tensor(_flat(ov.valid), device=device)[None].expand(F, -1))
    cam_cfg = cam_mod.CameraConfig()
    frame = cam_mod.render(ego, gp, obs, cam_cfg)
    return cam_mod.rgb_frame(frame, cam_cfg)


def animate_run(
    metrics,
    scenario=None,
    cfg=None,
    path: str = "run.gif",
    every: int = 10,
    camera: bool = False,
    fps: int = 12,
    device="cuda",
):
    """Rollout animation (the live-HUD role, rendered offline): map view
    with the ego trail + obstacles moving over time, the speed trace with
    a time cursor, and optionally (``camera=True``) the ego camera's RGB
    view per frame from :func:`camera_keyframes` on ``device``.

    Obstacles are re-simulated at constant velocity from the scenario's
    initial state. Writes an animated GIF; returns the path.
    """
    plt = _plt()
    from matplotlib import animation

    x = _flat(metrics.x)
    y = _flat(metrics.y)
    spd = _flat(metrics.speed_kmh)
    dt = cfg.plant.dt if cfg is not None else 0.01
    t = np.arange(len(spd)) * dt
    ks = _keyframe_ticks(len(x), every)

    rgb_frames = None
    if camera and scenario is not None:
        rgb_frames = _np(camera_keyframes(metrics, scenario, cfg, every, device))

    ncols = 3 if rgb_frames is not None else 2
    fig, axes = plt.subplots(1, ncols, figsize=(5 * ncols, 4.2))
    ax_map, ax_spd = axes[0], axes[1]

    if scenario is not None:
        gp = scenario.global_path
        ax_map.plot(_flat(gp.x), _flat(gp.y), "k--", lw=0.8)
    ax_map.plot(x, y, color="0.8", lw=0.8)  # full route, dimmed
    trail, = ax_map.plot([], [], "b-", lw=1.4)
    ego_pt, = ax_map.plot([], [], "bo", ms=6)
    obs_sc = None
    if scenario is not None:
        ovalid = _flat(scenario.obstacles.valid)
        obs0x = _flat(scenario.obstacles.x)[ovalid]
        obs0y = _flat(scenario.obstacles.y)[ovalid]
        obsvx = _flat(scenario.obstacles.vx)[ovalid]
        obsvy = _flat(scenario.obstacles.vy)[ovalid]
        obs_sc = ax_map.scatter(obs0x, obs0y, c="red", marker="s", s=36)
    ax_map.set_title("world")
    ax_map.axis("equal")
    ax_map.grid(alpha=0.3)

    ax_spd.plot(t, spd, color="0.7")
    cursor, = ax_spd.plot([], [], "b-", lw=1.4)
    ax_spd.set_title("speed (km/h)")
    ax_spd.set_xlabel("t (s)")
    ax_spd.grid(alpha=0.3)

    im = None
    if rgb_frames is not None:
        im = axes[2].imshow(rgb_frames[0])
        axes[2].set_title("ego camera")
        axes[2].set_xticks([])
        axes[2].set_yticks([])

    def draw(i):
        k = ks[i]
        trail.set_data(x[: k + 1], y[: k + 1])
        ego_pt.set_data([x[k]], [y[k]])
        arts = [trail, ego_pt, cursor]
        if obs_sc is not None:
            tk = (k + 1) * dt
            obs_sc.set_offsets(np.stack([obs0x + obsvx * tk, obs0y + obsvy * tk], axis=1))
            arts.append(obs_sc)
        cursor.set_data(t[: k + 1], spd[: k + 1])
        if im is not None:
            im.set_data(rgb_frames[i])
            arts.append(im)
        return arts

    fig.tight_layout()
    anim = animation.FuncAnimation(
        fig, draw, frames=len(ks), blit=True, interval=1000 // fps
    )
    anim.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path


def plot_camera_frame(frame, cfg=None, path: str = "camera.png"):
    """Render one ``sim/camera.py`` frame (lane 0 of a batched
    ``CameraFrame``) as the four-panel HUD view the reference's pygame
    window showed (RGB / semantic / depth / flow,
    ``simulation_2.py:594-668`` + ``Sensors_camera_lib.py``)."""
    plt = _plt()
    cam_cfg = cfg if cfg is not None else cam_mod.CameraConfig()
    if frame.semantic.dim() == 3:
        frame = type(frame)(*[f[:1] for f in frame])
    rgb = _np(cam_mod.rgb_frame(frame, cam_cfg)).reshape(*frame.depth.shape[-2:], 3)
    sem = _np(frame.semantic).reshape(rgb.shape[:2])
    depth = _np(frame.depth).reshape(rgb.shape[:2])
    flow = _np(frame.flow).reshape(*rgb.shape[:2], 2)

    fig, axes = plt.subplots(2, 2, figsize=(10, 6))
    axes[0, 0].imshow(rgb)
    axes[0, 0].set_title("rgb")
    axes[0, 1].imshow(sem, cmap="tab10", vmin=0, vmax=9)
    axes[0, 1].set_title("semantic")
    im = axes[1, 0].imshow(depth, cmap="viridis")
    axes[1, 0].set_title("depth (m)")
    fig.colorbar(im, ax=axes[1, 0], shrink=0.8)
    mag = np.hypot(flow[..., 0], flow[..., 1])
    axes[1, 1].imshow(mag, cmap="magma")
    axes[1, 1].set_title("optical-flow magnitude (px/s)")
    for a in axes.flat:
        a.set_xticks([])
        a.set_yticks([])
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
