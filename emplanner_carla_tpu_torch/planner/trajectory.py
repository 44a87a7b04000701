"""Path x speed merge: the time-parameterized trajectory on batch-first
tensors (counterpart of ``emplanner_carla_tpu/planner/trajectory.py``)."""

from __future__ import annotations

import torch

from emplanner_carla_tpu_torch.ops import frenet, interp
from emplanner_carla_tpu_torch.precision import require_fp32_matmul
from emplanner_carla_tpu_torch.types import Path, Tensor, Trajectory


def path_arc_length(path: Path) -> Tensor:
    """Arc-length table of a planned path (B, N) (``trajectory_index2s``)."""
    return frenet.arc_length(path)


def merge(path: Path, s_dense: Tensor, v_dense: Tensor, a_dense: Tensor,
          t_dense: Tensor) -> Trajectory:
    """Pose at s(t) along the path (B, N) plus the speed profile (B, nd) ->
    Trajectory of (B, nd). s beyond the path's end clamps to the final pose
    and is marked invalid. The four pose channels share one interpolation
    weight matrix and one float32 batched matmul. ``t_dense`` is (nd,) or
    (B, nd); the trajectory's time is (B, nd)."""
    require_fp32_matmul(s_dense)
    s_map = path_arc_length(path)
    W = interp.weight_matrix(s_dense, s_map)                  # (B, nd, N)
    F = torch.stack([path.x, path.y, path.theta, path.kappa], -1)  # (B, N, 4)
    pose = torch.bmm(W, F)                                    # (B, nd, 4)
    valid = s_dense <= s_map[:, -1:]
    return Trajectory(
        pose[..., 0], pose[..., 1], pose[..., 2], pose[..., 3],
        v_dense, a_dense, t_dense.expand_as(s_dense), valid,
    )


def speed_at(traj: Trajectory, t: Tensor) -> Tensor:
    """Planned speed (B,) at relative time t (B,) or scalar, clamped to the
    horizon: closed-form hat weights on the uniform time grid."""
    n = traj.time.shape[-1]
    t0 = traj.time[:, :1]
    dx = traj.time[:, 1:2] - t0
    t = torch.as_tensor(t, dtype=torch.float32, device=traj.speed.device)
    t = t.expand(traj.speed.shape[0])[:, None]
    w = interp.uniform_hat(t, t0, dx, n)[:, 0, :]             # (B, n)
    return (w * traj.speed).sum(-1)
