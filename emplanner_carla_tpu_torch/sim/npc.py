"""NPC traffic: behaviour presets and waypoint-following agents on
batch-first tensors (counterpart of ``emplanner_carla_tpu/sim/npc.py``).

Each NPC follows the scenario's global path, laterally offset by its lane
state, with pure-pursuit steering toward a speed-scaled look-ahead node and
IDM car-following against the preset's target speed, time headway and
minimum spacing, yielding to the ego and the other NPCs; an overtake
pressure moves it one lane to the side and back. NPCs use the kinematic
bicycle without actuator lag.

Every function takes the NPC slots as ``(B, K)`` tensors and the path as
``(B, N)``; the "others" of :func:`lead_info` and :func:`corridor_free`
carry one more trailing axis, ``(B, K, M)``, broadcast against the slots.
The JAX package's one-hot node lookups are plain gathers here
(``ops/frenet._gather``). The tick kernel ``csrc/tick_lqr.cu`` computes the
same expressions in its traffic branch, in the same order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from emplanner_carla_tpu_torch.config import VehicleParams
from emplanner_carla_tpu_torch.ops import frenet
from emplanner_carla_tpu_torch.types import EgoState, Path, Tensor, hypot, tdiv


class BehaviorPreset(NamedTuple):
    """Max speed (m/s), safety time headway (s), min spacing (m),
    comfortable accel / decel (m/s^2), each a 0-dim float32 tensor."""

    max_speed: Tensor
    safety_time: Tensor
    min_distance: Tensor
    accel: Tensor
    decel: Tensor


_PRESET_TABLE = {
    "cautious": (30.0 / 3.6, 3.0, 12.0, 1.5, 3.0),
    "normal": (40.0 / 3.6, 2.0, 10.0, 2.0, 4.0),
    "aggressive": (50.0 / 3.6, 1.0, 8.0, 3.0, 5.0),
}


def preset(name: str, device="cpu") -> BehaviorPreset:
    """Cautious / normal / aggressive: the table's float64 values rounded
    once to float32, on ``device`` (the device of the tensors they meet, so
    that a quotient by them is an IEEE quotient on the card too)."""
    return BehaviorPreset(*(torch.tensor(v, dtype=torch.float32, device=device)
                            for v in _PRESET_TABLE[name]))


def preset_floats(name: str) -> tuple:
    """The preset as Python floats (the tick kernel's parameters, rounded to
    float32 once when they are handed over)."""
    return tuple(float(v) for v in _PRESET_TABLE[name])


class NPCState(NamedTuple):
    ego: EgoState        # NPC pose / velocity in the EgoState layout, (B, K)
    path_index: Tensor   # carried match index on the global path, int32
    active: Tensor       # bool


def idm_accel(v: Tensor, v_lead: Tensor, gap: Tensor, p: BehaviorPreset) -> Tensor:
    """Intelligent-Driver-Model acceleration: free-road term and interaction
    term from the preset's headway and minimum spacing. ``** 4`` is
    ``(t * t) * (t * t)`` and ``** 2`` is ``t * t``, as JAX's integer power
    computes them."""
    den = 2.0 * torch.sqrt(p.accel * p.decel)
    s_star = p.min_distance + torch.clamp(
        v * p.safety_time + v * (v - v_lead) / den, min=0.0)
    gap = torch.clamp(gap, min=0.5)
    r = v / torch.clamp(p.max_speed, min=0.1)
    q = s_star / gap
    return p.accel * (1.0 - (r * r) * (r * r) - q * q)


LANE_WIDTH = 3.5
LANE_CHANGE_RATE = 1.75  # lateral offset slew (m/s): one lane in ~2 s


class LaneState(NamedTuple):
    """Carried lane-change state per NPC slot, (B, K): the current lateral
    offset from the lane centre and the commanded target offset."""

    offset: Tensor
    target: Tensor

    @classmethod
    def init(cls, batch: int, k: int, device="cpu"):
        z = torch.zeros((batch, k), dtype=torch.float32, device=device)
        return cls(z, z.clone())


def lane_change_decision(lane: LaneState, gap_own: Tensor, v_lead_own: Tensor,
                         v_self: Tensor, left_free: Tensor, right_free: Tensor,
                         own_free: Tensor, p: BehaviorPreset) -> LaneState:
    """Overtake-pressure lane selection, left lane preferred; merge back once
    the own lane is clear AND the pressure has released (the ``~blocked``
    term keeps the target from flapping every tick while the blocker sits
    between the corridor gate and the pressure gate)."""
    press_gap = p.min_distance + v_self * p.safety_time
    blocked = (gap_own < 1.5 * press_gap) & (v_lead_own < 0.8 * p.max_speed)
    in_lane = lane.target.abs() < 0.1
    go_left = blocked & in_lane & left_free
    go_right = blocked & in_lane & ~left_free & right_free
    target = torch.where(go_left, LANE_WIDTH,
                         torch.where(go_right, -LANE_WIDTH, lane.target))
    target = torch.where(~in_lane & own_free & ~blocked, 0.0, target)
    return LaneState(lane.offset, target)


def lateral_offset_on_path(s: EgoState, path: Path, idx: Tensor) -> Tensor:
    """The NPC's lateral offset from its path (+ = path-normal (-sin, cos)
    side), measured at node ``idx`` (B, K)."""
    th = frenet._gather(path.theta, idx)
    px = frenet._gather(path.x, idx)
    py = frenet._gather(path.y, idx)
    return -(s.x - px) * torch.sin(th) + (s.y - py) * torch.cos(th)


def slew_lane(lane: LaneState, dt: float) -> LaneState:
    """Move the actual offset toward the target at the lane-change rate."""
    step = LANE_CHANGE_RATE * dt
    d = torch.clamp(lane.target - lane.offset, -step, step)
    return LaneState(lane.offset + d, lane.target)


def _frame(npc: EgoState, lateral_shift: Tensor, others_x: Tensor, others_y: Tensor):
    """Others' (longitudinal, lateral) offsets in the NPC's heading frame
    about its position shifted by ``lateral_shift`` along the normal."""
    ux, uy = torch.cos(npc.phi)[..., None], torch.sin(npc.phi)[..., None]
    nx, ny = -uy, ux
    sh = lateral_shift[..., None]
    dx = others_x - (npc.x[..., None] + sh * nx)
    dy = others_y - (npc.y[..., None] + sh * ny)
    return dx * ux + dy * uy, -dx * uy + dy * ux


def corridor_free(npc: EgoState, lateral_shift: Tensor, others_x: Tensor,
                  others_y: Tensor, others_valid: Tensor, back: float = 8.0,
                  ahead: float = 20.0, half_width: float = 1.8) -> Tensor:
    """Is the laterally shifted corridor clear of the other actors?"""
    d_long, d_lat = _frame(npc, lateral_shift, others_x, others_y)
    occupied = others_valid & (d_long > -back) & (d_long < ahead) & (
        d_lat.abs() < half_width)
    return ~occupied.any(-1)


def lead_info(npc: EgoState, others_x: Tensor, others_y: Tensor, others_v: Tensor,
              others_valid: Tensor, lateral_shift: Tensor):
    """Nearest actor ahead of the NPC in a lane corridor -> (gap, speed); the
    first minimum wins ties (an obstacle slot before the ego). Nothing ahead
    gives (1e4, 100)."""
    d_long, d_lat = _frame(npc, lateral_shift, others_x, others_y)
    ahead = others_valid & (d_long > 0.5) & (d_lat.abs() < 2.0)
    masked = torch.where(ahead, d_long, float("inf"))
    gap, lead_idx = masked.min(-1).values, torch.argmin(masked, dim=-1)
    v_at = torch.gather(others_v.expand(masked.shape), -1, lead_idx[..., None])[..., 0]
    found = torch.isfinite(gap)
    return torch.where(found, gap, 1e4), torch.where(found, v_at, 100.0)


def npc_step(state: NPCState, path: Path, lead_dist: Tensor, lead_speed: Tensor,
             p: BehaviorPreset, vp: VehicleParams, dt: float,
             lane_offset: Tensor) -> NPCState:
    """One NPC tick: the 32-node forward match, pure pursuit toward the
    speed-scaled look-ahead node shifted by ``lane_offset`` along the path
    normal, IDM acceleration and the kinematic bicycle. Inactive slots keep
    their state."""
    s = state.ego
    idx = frenet.nearest_index_windowed(s.x, s.y, path, state.path_index, 32)
    look = torch.clamp(idx + 2 + (s.vx * 0.25).to(torch.int32), 0, path.n - 1)
    th_l = frenet._gather(path.theta, look)
    lx = frenet._gather(path.x, look)
    ly = frenet._gather(path.y, look)
    dx = lx - lane_offset * torch.sin(th_l) - s.x
    dy = ly + lane_offset * torch.cos(th_l) - s.y
    alpha = torch.atan2(dy, dx) - s.phi
    alpha = torch.atan2(torch.sin(alpha), torch.cos(alpha))
    wheelbase = vp.a + vp.b
    ld = torch.clamp(hypot(dx, dy), min=1.0)
    delta = torch.atan2(2.0 * wheelbase * torch.sin(alpha), ld)
    steer = torch.clamp(tdiv(delta, vp.max_steer_rad), -1.0, 1.0)

    accel = idm_accel(s.vx, lead_speed, lead_dist, p)
    accel = torch.minimum(torch.maximum(accel, -p.decel), p.accel)

    v = torch.clamp(s.vx + accel * dt, min=0.0)
    omega = tdiv(v * torch.tan(steer * vp.max_steer_rad), wheelbase)
    phi = s.phi + omega * dt
    c, sn = torch.cos(phi), torch.sin(phi)
    x = s.x + v * c * dt
    y = s.y + v * sn * dt
    z = torch.zeros_like(v)
    new = EgoState(x, y, phi, v, z, omega, accel * c, accel * sn, steer)
    keep = state.active
    ego_out = EgoState(*[torch.where(keep, a, b) for a, b in zip(new, s)])
    return NPCState(ego_out, torch.where(keep, idx, state.path_index), keep)
