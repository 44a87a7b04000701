"""Core data types of the PyTorch port: NamedTuples of batch-first tensors.

Counterparts of ``emplanner_carla_tpu/types.py``. Where the JAX package
writes every type unbatched and ``vmap``s it, the port carries the batch
axis explicitly: a per-scenario scalar is a ``(B,)`` tensor, a per-scenario
vector a ``(B, N)`` tensor. Variable-length collections stay fixed-width
with an explicit boolean ``valid`` mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


def hypot(a: Tensor, b: Tensor) -> Tensor:
    """``jnp.hypot``'s formula: max * sqrt(1 + (min/max)^2).

    ``torch.hypot`` rounds differently in the last ulp; the port uses the
    reference's formula so that its plain path tracks the JAX package, and
    the tick kernel computes the same expression."""
    a, b = a.abs(), b.abs()
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    zero = hi == 0
    r = lo / torch.where(zero, torch.ones_like(hi), hi)
    out = torch.where(zero, hi, hi * torch.sqrt(1.0 + r * r))
    return torch.where(torch.isposinf(a) | torch.isposinf(b),
                       torch.full_like(out, float("inf")), out)


def tdiv(a: Tensor, b: float) -> Tensor:
    """IEEE division by a constant. PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which rounds differently from the
    quotient the CPU and the hand-written kernels compute."""
    return a / torch.full_like(a, b)


def sdiv(a: float, b: Tensor) -> Tensor:
    """IEEE quotient of a constant by a tensor (``a / t`` in PyTorch is
    ``t.reciprocal() * a``)."""
    return torch.full_like(b, a) / b


class Path(NamedTuple):
    """A discrete path (x, y, heading theta, curvature kappa), each (B, N)."""

    x: Tensor
    y: Tensor
    theta: Tensor
    kappa: Tensor

    @property
    def n(self) -> int:
        return self.x.shape[-1]


class EgoState(NamedTuple):
    """Cartesian ego state shared by planner, controllers and plant; every
    field is (B,)."""

    x: Tensor
    y: Tensor
    phi: Tensor      # yaw (rad)
    vx: Tensor       # body-frame longitudinal speed (m/s)
    vy: Tensor       # body-frame lateral speed (m/s)
    omega: Tensor    # yaw rate (rad/s)
    ax: Tensor       # world-frame acceleration x (m/s^2)
    ay: Tensor       # world-frame acceleration y (m/s^2)
    steer: Tensor    # applied (post-actuator) normalized steer in [-1, 1]

    @property
    def speed(self) -> Tensor:
        return hypot(self.vx, self.vy)

    @property
    def v_world(self) -> tuple[Tensor, Tensor]:
        c, s = torch.cos(self.phi), torch.sin(self.phi)
        return self.vx * c - self.vy * s, self.vy * c + self.vx * s


class Obstacles(NamedTuple):
    """Fixed-width obstacle set, fields (B, K); ``valid`` is bool."""

    x: Tensor
    y: Tensor
    vx: Tensor      # world-frame velocity (0 for static)
    vy: Tensor
    valid: Tensor

    @property
    def k(self) -> int:
        return self.x.shape[-1]


class STSegments(NamedTuple):
    """S-T occupancy line segments, one slot per dynamic obstacle, each
    field (B, K); ``valid`` is bool."""

    s_in: Tensor
    s_out: Tensor
    t_in: Tensor
    t_out: Tensor
    valid: Tensor


class Trajectory(NamedTuple):
    """Time-parameterized trajectory = path x speed profile, each field
    (B, N); ``valid`` marks samples inside the path's arc length."""

    x: Tensor
    y: Tensor
    theta: Tensor
    kappa: Tensor
    speed: Tensor
    accel: Tensor
    time: Tensor
    valid: Tensor


def tree_to(tree, device):
    """Move every tensor of a (nested) NamedTuple/tuple to ``device``."""
    if isinstance(tree, Tensor):
        return tree.to(device)
    if tree is None:
        return None
    if isinstance(tree, tuple):
        items = [tree_to(t, device) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree
