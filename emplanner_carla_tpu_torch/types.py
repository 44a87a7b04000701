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
Array = Tensor  # the JAX package's name for its array type


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


class SLObstacles(NamedTuple):
    """Obstacles projected into the Frenet (s, l) frame of a reference
    line, fields (B, K); ``valid`` is bool."""

    s: Tensor
    l: Tensor
    valid: Tensor


class STSegments(NamedTuple):
    """S-T occupancy line segments, one slot per dynamic obstacle, each
    field (B, K); ``valid`` is bool."""

    s_in: Tensor
    s_out: Tensor
    t_in: Tensor
    t_out: Tensor
    valid: Tensor


class FrenetState(NamedTuple):
    """Full Frenet state (s, l and derivatives) of one point a lane, each
    field (B,): the seven outputs of ``cal_s_l_deri_fun``
    (``planner/planning_utils.py:512-588``) plus s itself."""

    s: Tensor
    l: Tensor
    s_dot: Tensor    # ds/dt
    l_dot: Tensor    # dl/dt
    s_ddot: Tensor   # d2s/dt2
    l_ddot: Tensor   # d2l/dt2
    l_prime: Tensor  # dl/ds
    l_pprime: Tensor  # d2l/ds2


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


def tree_map(tree, fn):
    """``fn`` over every tensor of a (nested) NamedTuple/tuple; None and
    other leaves as they are."""
    if isinstance(tree, Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        items = [tree_map(t, fn) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def tree_leaves(tree):
    """Every tensor of a (nested) tuple, NamedTuple, list or dict, in order."""
    if isinstance(tree, Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for leaf in tree:
            yield from tree_leaves(leaf)
    elif isinstance(tree, dict):
        for leaf in tree.values():
            yield from tree_leaves(leaf)


def tree_to(tree, device):
    """Move every tensor of a (nested) NamedTuple/tuple to ``device``."""
    return tree_map(tree, lambda t: t.to(device))
