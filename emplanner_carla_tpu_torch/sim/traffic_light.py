"""Traffic lights: fixed-cycle signals and the red-light stop cap on
batch-first tensors (counterpart of
``emplanner_carla_tpu/sim/traffic_light.py``).

A light is a fixed slot (stop-line position and phase parameters); its
state is a pure function of time, and "brake for red" is a time-headway
speed cap against the stop line, the same form as the closed loops' ACC
guard, so the two compose by a min. The tick kernel ``csrc/tick_lqr.cu``
computes the same cap in its lights branch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from emplanner_carla_tpu_torch.types import EgoState, Tensor, hypot

STOP_STANDOFF = 4.0   # metres kept to the stop line when stopped
STOP_HEADWAY = 1.2    # seconds of time headway on approach
STOP_LAT_GATE = 3.0   # |lateral offset| of a stop line that affects us


class TrafficLights(NamedTuple):
    """Fixed signal slots, each field (B, L). Green on [0, green_frac *
    period) of the cycle, red on the rest (amber folded into red)."""

    x: Tensor           # stop-line position
    y: Tensor
    period: Tensor      # full cycle length (s)
    offset: Tensor      # phase offset (s)
    green_frac: Tensor  # fraction of the cycle that is green
    valid: Tensor       # bool

    @classmethod
    def none(cls, batch: int, n: int = 2, device="cpu"):
        """No light: every slot invalid."""
        z = torch.zeros((batch, n), dtype=torch.float32, device=device)
        one = torch.ones_like(z)
        return cls(z, z, one, z, one,
                   torch.zeros((batch, n), dtype=torch.bool, device=device))


def is_green(lights: TrafficLights, t: Tensor) -> Tensor:
    """(B, L) bool: the light shows green at absolute time t (B,). The phase
    is a floored modulo (``jnp.mod``), which is ``torch.remainder``."""
    phase = torch.remainder(t[:, None] + lights.offset,
                            torch.clamp(lights.period, min=1e-3))
    return phase < lights.green_frac * lights.period


def stop_distance(ego: EgoState, lights: TrafficLights, t: Tensor) -> Tensor:
    """(B,) longitudinal distance to the nearest red stop line ahead in the
    vehicle's corridor (motion direction, heading below 0.5 m/s); inf when
    unaffected."""
    vxw, vyw = ego.v_world
    spd = torch.clamp(hypot(vxw, vyw), min=1e-3)
    slow = spd < 0.5
    den = torch.where(slow, torch.ones_like(spd), spd)
    ux = torch.where(slow, torch.cos(ego.phi), vxw / den)
    uy = torch.where(slow, torch.sin(ego.phi), vyw / den)
    dx = lights.x - ego.x[:, None]
    dy = lights.y - ego.y[:, None]
    d_long = dx * ux[:, None] + dy * uy[:, None]
    d_lat = -dx * uy[:, None] + dy * ux[:, None]
    red = lights.valid & ~is_green(lights, t)
    gating = red & (d_long > 0.0) & (d_lat.abs() < STOP_LAT_GATE)
    return torch.where(gating, d_long, float("inf")).min(dim=1).values


def red_light_cap(ego: EgoState, lights: TrafficLights, t: Tensor,
                  standoff: float = STOP_STANDOFF,
                  headway: float = STOP_HEADWAY) -> Tensor:
    """(B,) speed cap (m/s) to stop ``standoff`` metres short of the nearest
    red light ahead at a time headway of ``headway`` seconds."""
    d = stop_distance(ego, lights, t) - standoff
    return torch.clamp(d / torch.full_like(d, headway), min=0.0)
