"""Longitudinal PID with integral separation (counterpart of
``emplanner_carla_tpu/control/pid.py``): error in km/h, a 60-deep error
buffer for the integral/derivative terms, and integral separation —
|error| above 1 km/h zeroes the integral and clears the buffer."""

from __future__ import annotations

from typing import NamedTuple

import torch

from emplanner_carla_tpu_torch.config import ControlConfig
from emplanner_carla_tpu_torch.types import Tensor, tdiv


class PIDState(NamedTuple):
    buffer: Tensor   # (B, pid_buffer) recent errors (km/h), newest last
    count: Tensor    # (B,) int32 number of valid entries
    last_error: Tensor  # (B,)

    @classmethod
    def init(cls, cfg: ControlConfig, batch: int, device="cpu"):
        return cls(
            torch.zeros((batch, cfg.pid_buffer), dtype=torch.float32, device=device),
            torch.zeros(batch, dtype=torch.int32, device=device),
            torch.zeros(batch, dtype=torch.float32, device=device),
        )


def pid_core(buffer, count, last, error, cfg: ControlConfig):
    """One PID tick on (B, n_buf) buffers and (B,) rows. Returns
    (cmd, buffer', count', error). With ``ki == 0`` the window is not
    summed, with ``kd == 0`` no derivative is taken: their terms are 0, the
    tick kernel's choice. For finite errors the command is the same; a NaN
    in the window, which the always-summing JAX PID turns into a NaN
    command, does not reach it."""
    buffer = torch.cat([buffer[:, 1:], error[:, None]], 1)
    count = torch.clamp(count + 1, max=cfg.pid_buffer)

    have_two = count >= 2
    zero = torch.zeros_like(error)
    integral = torch.where(have_two, buffer.sum(dim=1) * cfg.pid_dt, 0.0) \
        if cfg.ki != 0.0 else zero
    deriv = torch.where(have_two, tdiv(error - last, cfg.pid_dt), 0.0) \
        if cfg.kd != 0.0 else zero

    # integral separation (controller.py:667-671)
    separate = error.abs() > cfg.integral_sep_threshold
    integral = torch.where(separate, 0.0, integral)
    buffer = torch.where(separate[:, None], 0.0, buffer)
    count = torch.where(separate, torch.zeros_like(count), count)

    cmd = cfg.kp * error + cfg.ki * integral + cfg.kd * deriv
    return cmd, buffer, count, error


def pid_step(state: PIDState, speed_mps: Tensor, target_kmh: Tensor,
             cfg: ControlConfig):
    """One PID tick -> (command, new state); > 0 throttle, < 0 brake."""
    error = target_kmh - 3.6 * speed_mps
    cmd, buffer, count, _ = pid_core(
        state.buffer, state.count, state.last_error, error, cfg
    )
    return cmd, PIDState(buffer, count, error)


def split_throttle_brake(cmd: Tensor):
    """Positive command -> throttle, negative -> proportional brake."""
    return torch.clamp(cmd, 0.0, 1.0), torch.clamp(-cmd, 0.0, 1.0)
