"""State carried across from the JAX package, through NumPy.

The system has no weights; what makes the two packages compute the same
thing is the configuration and the state they are handed. These helpers
build the port's types from ``dataclasses.asdict`` of a JAX ``EMConfig`` and
from NumPy arrays of the JAX pytrees. They read attributes by name (duck
typing), so this module imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from emplanner_carla_tpu_torch import config as cfg_mod
from emplanner_carla_tpu_torch.control import pid, vehicle
from emplanner_carla_tpu_torch.sim import npc
from emplanner_carla_tpu_torch.sim.closed_loop import LoopCarry, TrafficCarry
from emplanner_carla_tpu_torch.sim.traffic_light import TrafficLights
from emplanner_carla_tpu_torch.types import EgoState, Obstacles, Path


def _build(cls, d):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.default):
            v = _build(type(f.default), v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def config_from_dict(d: dict) -> cfg_mod.EMConfig:
    """The port's EMConfig from ``dataclasses.asdict`` of the JAX one."""
    return _build(cfg_mod.EMConfig, d)


def _t(a, device, dtype):
    return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)


def path_from_numpy(p, device="cpu") -> Path:
    """Path from anything with x, y, theta, kappa arrays of shape (B, N)."""
    return Path(*(_t(getattr(p, f), device, torch.float32) for f in Path._fields))


def ego_from_numpy(e, device="cpu") -> EgoState:
    """EgoState from anything with the nine EgoState fields, each (B,)."""
    return EgoState(*(_t(getattr(e, f), device, torch.float32)
                      for f in EgoState._fields))


def obstacles_from_numpy(o, device="cpu") -> Obstacles:
    """Obstacles from anything with x, y, vx, vy, valid, each (B, K)."""
    return Obstacles(
        _t(o.x, device, torch.float32), _t(o.y, device, torch.float32),
        _t(o.vx, device, torch.float32), _t(o.vy, device, torch.float32),
        _t(o.valid, device, torch.bool),
    )


def carry_from_numpy(c, device="cpu") -> LoopCarry:
    """LoopCarry from a batched JAX ``closed_loop.LoopCarry``: ego, PID
    state (buffer, count, last error), match index, obstacles, arrival flag
    and the QP warm states (x_s, z, y): the path QP's, and the speed QP's
    when the carry has one (``simulate_full``); under MPC the controller's
    box-ADMM state (z, u_d)."""
    f32 = lambda a: _t(a, device, torch.float32)  # noqa: E731
    p = c.ctrl.pid
    mpc = getattr(c.ctrl, "mpc", None)
    ctrl = vehicle.ControllerState(
        pid.PIDState(f32(p.buffer), _t(p.count, device, torch.int32),
                     f32(p.last_error)),
        None if mpc is None else tuple(f32(a) for a in mpc),
    )
    qp_warm = tuple(
        None if st is None else tuple(_t(a, device, torch.float32) for a in st)
        for st in c.qp_warm
    )
    return LoopCarry(
        ego_from_numpy(c.ego, device), ctrl,
        _t(c.match_index, device, torch.int32),
        obstacles_from_numpy(c.obstacles, device),
        _t(c.arrived, device, torch.bool),
        qp_warm,
    )


def lights_from_numpy(tl, device="cpu") -> TrafficLights:
    """TrafficLights from anything with the six TrafficLights fields, each
    (B, L)."""
    return TrafficLights(
        *(_t(getattr(tl, f), device, torch.float32)
          for f in TrafficLights._fields[:-1]),
        _t(tl.valid, device, torch.bool),
    )


def lane_state_from_numpy(lane, device="cpu") -> npc.LaneState:
    """npc.LaneState from anything with offset and target arrays, (B, K)."""
    return npc.LaneState(_t(lane.offset, device, torch.float32),
                         _t(lane.target, device, torch.float32))


def traffic_carry_from_numpy(c, device="cpu") -> TrafficCarry:
    """TrafficCarry from a batched JAX ``closed_loop.TrafficCarry``: its
    LoopCarry, the NPCs' match indices (int32) and their lane state, e.g.
    taken mid lane change, for ``simulate_traffic``'s ``npc_init`` and
    starting state."""
    return TrafficCarry(carry_from_numpy(c.loop, device),
                        _t(c.npc_path_index, device, torch.int32),
                        lane_state_from_numpy(c.npc_lane, device))
