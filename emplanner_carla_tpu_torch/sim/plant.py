"""Vehicle plant (counterpart of ``emplanner_carla_tpu/sim/plant.py``): the
kinematic bicycle and the friction-limited dynamic bicycle, each with a
lagged, rate-limited steering actuator, integrated ``cfg.substeps`` times a
tick at dt / substeps. Every field is (B,). Divisions by a constant are
IEEE quotients (``types.tdiv``), as in the tick kernel."""

from __future__ import annotations

import torch

from emplanner_carla_tpu_torch.config import PlantConfig, VehicleParams
from emplanner_carla_tpu_torch.types import EgoState, Tensor, tdiv

MU_G = 1.0 * 9.81  # tyre friction coefficient times gravity


def control_to_accel(throttle: Tensor, brake: Tensor, vp: VehicleParams) -> Tensor:
    """Longitudinal acceleration from pedal commands."""
    return throttle * vp.max_accel - brake * vp.max_brake_decel


def steer_to_wheel(steer: Tensor, vp: VehicleParams) -> Tensor:
    """Normalized steer command -> front wheel angle (rad)."""
    return torch.clamp(steer, -1.0, 1.0) * vp.max_steer_rad


def apply_steer_actuator(applied: Tensor, cmd: Tensor, vp: VehicleParams,
                         dt: float) -> Tensor:
    """First-order-lag + rate-limited steering actuator."""
    desired = tdiv((cmd - applied) * dt, max(vp.steer_tau, dt))
    change = torch.clamp(desired, -vp.steer_rate * dt, vp.steer_rate * dt)
    return torch.clamp(applied + change, -1.0, 1.0)


def kinematic_step(s: EgoState, steer: Tensor, accel: Tensor,
                   vp: VehicleParams, dt: float) -> EgoState:
    """Rear-axle kinematic bicycle, explicit Euler at dt."""
    applied = apply_steer_actuator(s.steer, steer, vp, dt)
    delta = steer_to_wheel(applied, vp)
    L = vp.a + vp.b
    v = torch.clamp(s.vx + accel * dt, min=0.0)  # no reverse (reference gear=1)
    omega = tdiv(v * torch.tan(delta), L)
    phi = s.phi + omega * dt
    x = s.x + v * torch.cos(phi) * dt
    y = s.y + v * torch.sin(phi) * dt
    ax = accel * torch.cos(phi)
    ay = accel * torch.sin(phi)
    return EgoState(x, y, phi, v, torch.zeros_like(v), omega, ax, ay, applied)


def axle_force_caps(vp: VehicleParams) -> tuple[float, float]:
    """mu * static load of the front and rear axle, as Python floats (the
    JAX package's products; cast to float32 where they clip a force)."""
    fzf = vp.mass * MU_G * vp.b / (vp.a + vp.b)
    fzr = vp.mass * MU_G * vp.a / (vp.a + vp.b)
    return fzf, fzr


def dynamic_step(s: EgoState, steer: Tensor, accel: Tensor,
                 vp: VehicleParams, dt: float) -> EgoState:
    """Dynamic bicycle with linear tyres, F = C * alpha (the reference's
    negative-stiffness convention), slip angles guarded at vx ~ 0, each
    axle's force capped at mu * static load. vy and omega integrate only
    while the new vx exceeds 0.1 m/s; vy_dot uses the old vx."""
    applied = apply_steer_actuator(s.steer, steer, vp, dt)
    delta = steer_to_wheel(applied, vp)
    vx_safe = torch.clamp(s.vx, min=0.5)
    alpha_f = (s.vy + vp.a * s.omega) / vx_safe - delta
    alpha_r = (s.vy - vp.b * s.omega) / vx_safe
    fzf, fzr = axle_force_caps(vp)
    fyf = torch.clamp(vp.cf * alpha_f, -fzf, fzf)
    fyr = torch.clamp(vp.cr * alpha_r, -fzr, fzr)
    vy_dot = tdiv(fyf + fyr, vp.mass) - s.vx * s.omega
    omega_dot = tdiv(vp.a * fyf - vp.b * fyr, vp.iz)
    vx = torch.clamp(s.vx + accel * dt, min=0.0)
    moving = vx > 0.1
    vy = torch.where(moving, s.vy + vy_dot * dt, 0.0)
    omega = torch.where(moving, s.omega + omega_dot * dt, 0.0)
    phi = s.phi + omega * dt
    c, sn = torch.cos(phi), torch.sin(phi)
    x = s.x + (vx * c - vy * sn) * dt
    y = s.y + (vy * c + vx * sn) * dt
    return EgoState(x, y, phi, vx, vy, omega, accel * c, accel * sn, applied)


def step(s: EgoState, steer: Tensor, throttle: Tensor, brake: Tensor,
         vp: VehicleParams, cfg: PlantConfig) -> EgoState:
    """One control tick: ``cfg.substeps`` plant steps at cfg.dt / substeps
    under the same command."""
    accel = control_to_accel(throttle, brake, vp)
    stepper = kinematic_step if cfg.kind == "kinematic" else dynamic_step
    dt = cfg.dt / cfg.substeps
    for _ in range(cfg.substeps):
        s = stepper(s, steer, accel, vp, dt)
    return s


def predict_forward(s: EgoState, ts: float):
    """Plan-start prediction: dead-reckon the pose ts seconds ahead
    (``predict_block``)."""
    vx_w, vy_w = s.v_world
    return s.x + vx_w * ts, s.y + vy_w * ts, s.phi + s.omega * ts
