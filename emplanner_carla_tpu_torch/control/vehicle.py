"""Vehicle control facade: LQR or MPC lateral + longitudinal PID per tick
(counterpart of ``emplanner_carla_tpu/control/vehicle.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from emplanner_carla_tpu_torch.config import ControlConfig, VehicleParams
from emplanner_carla_tpu_torch.control import lateral, pid
from emplanner_carla_tpu_torch.types import EgoState, Path, Tensor


def mpc_zero_state(cfg: ControlConfig, batch: int, device="cpu"):
    """The MPC box-ADMM warm state (z, u_d), zeros of (B, nu)."""
    nu = cfg.mpc_n * cfg.mpc_p
    return tuple(torch.zeros((batch, nu), dtype=torch.float32, device=device)
                 for _ in range(2))


class ControllerState(NamedTuple):
    """Carried controller state: the PID buffer, and under MPC the box-ADMM
    warm state ``mpc = (z, u_d)`` of (B, nu) (None under LQR, whose lateral
    side is stateless)."""

    pid: pid.PIDState
    mpc: object = None

    @classmethod
    def init(cls, cfg: ControlConfig, batch: int, device="cpu"):
        mpc = mpc_zero_state(cfg, batch, device) if cfg.kind == "MPC" else None
        return cls(pid.PIDState.init(cfg, batch, device), mpc)

    def rebind(self):
        """Controller rebind on replan (``test_9.py:415-417`` builds a fresh
        controller): the PID buffer starts empty and the MPC warm state at
        zeros."""
        p = self.pid
        mpc = None
        if self.mpc is not None:
            mpc = tuple(torch.zeros_like(a) for a in self.mpc)
        return ControllerState(
            pid.PIDState(torch.zeros_like(p.buffer), torch.zeros_like(p.count),
                         torch.zeros_like(p.last_error)),
            mpc,
        )


def run_step(ego: EgoState, target: Path, state: ControllerState,
             target_speed_kmh: Tensor, vp: VehicleParams, cfg: ControlConfig):
    """One control tick -> (steer, throttle, brake, new state)."""
    return control_step(ego, target, state, target_speed_kmh, vp, cfg)[:4]


def control_step(ego: EgoState, target: Path, state: ControllerState,
                 target_speed_kmh: Tensor, vp: VehicleParams, cfg: ControlConfig):
    """:func:`run_step` that also returns which lanes ran the MPC's box ADMM
    this tick, (B,) bool (None under LQR). With a warm state the MPC runs
    ``cfg.mpc_warm_admm_iters`` from it, without one the cold count from
    zeros."""
    mpc_state, ran = state.mpc, None
    if cfg.kind == "MPC":
        iters = cfg.mpc_admm_iters if mpc_state is None else cfg.mpc_warm_admm_iters
        steer, _, warm, ran = lateral.mpc_steer_table(ego, target, vp, cfg,
                                                      mpc_state, iters)
        mpc_state = None if mpc_state is None else warm
    else:
        steer, _ = lateral.lqr_steer(ego, target, vp, cfg)
    cmd, pid_state = pid.pid_step(state.pid, ego.speed, target_speed_kmh, cfg)
    throttle, brake = pid.split_throttle_brake(cmd)
    return steer, throttle, brake, ControllerState(pid_state, mpc_state), ran
