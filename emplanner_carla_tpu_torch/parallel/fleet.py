"""Fleet-scale execution: a scenario batch split over ``torch.distributed``
ranks (counterpart of ``emplanner_carla_tpu/parallel/fleet.py``).

Scaling is batch (scenario) parallelism. Each rank drives one device and
simulates its contiguous ``B / world`` rows of the batch independently; the
only traffic between ranks is the reduction of the fleet aggregates at the
end, one ``all_reduce`` of seven float32 partial sums on the device that
holds the metrics (NCCL on the card, gloo on the CPU).

A mesh is a :class:`FleetMesh`: the process group, this rank's device, its
rank and the world size. :func:`make_mesh` takes the default process group
when one is initialised (``torchrun``, or ranks the caller started), else it
starts a one-rank group of its own. Per-scenario metrics stay on their rank,
as the JAX package's output stays sharded.
"""

from __future__ import annotations

from datetime import timedelta
from typing import NamedTuple

import torch
import torch.distributed as dist

from emplanner_carla_tpu_torch.config import EMConfig
from emplanner_carla_tpu_torch.sim import closed_loop, pixel_loop
from emplanner_carla_tpu_torch.sim.scenario import Scenario
from emplanner_carla_tpu_torch.types import tree_map

DATA_AXIS = "data"
# the one-rank group's rendezvous and collectives give up after this long
GROUP_TIMEOUT = timedelta(seconds=300)


class FleetMesh(NamedTuple):
    """A 1-D data-parallel mesh over ``torch.distributed`` (axis
    :data:`DATA_AXIS`): the process group the aggregates are reduced over,
    the device this rank drives, the rank, the world size and the group's
    backend."""

    group: object
    device: torch.device
    rank: int
    world: int
    backend: str


def make_mesh(devices=None) -> FleetMesh:
    """The data-parallel mesh of this process: ``devices`` is the device it
    drives (a device, its name, or a one-element list of either); by default
    the card (``cuda:<rank % cards>``) under an NCCL group and the CPU under
    a gloo one.

    An initialised default process group is used as it is. Otherwise a
    one-rank group starts on an in-process ``HashStore``: NCCL for a CUDA
    device (the default), gloo for the CPU. A CUDA device under a gloo group
    raises ``ValueError``: the fleet never reduces a card's metrics through
    the host."""
    if isinstance(devices, (list, tuple)):
        if len(devices) != 1:
            raise ValueError("a rank drives one device; start one rank a device")
        devices = devices[0]
    if not dist.is_initialized():
        device = _card(torch.device("cuda" if devices is None else devices))
        if device.type == "cuda":
            dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=GROUP_TIMEOUT,
                                    device_id=device)
        else:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=GROUP_TIMEOUT)
    backend = str(dist.get_backend())
    rank, world = dist.get_rank(), dist.get_world_size()
    if devices is None:
        device = (torch.device("cuda", rank % torch.cuda.device_count())
                  if "nccl" in backend else torch.device("cpu"))
    else:
        device = torch.device(devices)
    if device.type == "cuda" and "nccl" not in backend:
        raise ValueError(f"a {backend} group cannot reduce on {device}: the fleet "
                         "reduces a card's metrics with NCCL")
    device = _card(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return FleetMesh(dist.group.WORLD, device, rank, world, backend)


def _card(device: torch.device) -> torch.device:
    """``cuda`` as the current card's index; other devices as they are."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def shard_scenarios(scenarios: Scenario, mesh: FleetMesh) -> Scenario:
    """This rank's contiguous ``B / world`` rows of a batched Scenario, on
    the mesh's device. ``B`` must be a multiple of the world size."""
    B = scenarios.ego0.x.shape[0]
    if B % mesh.world:
        raise ValueError(f"batch {B} does not split over {mesh.world} ranks")
    b = B // mesh.world
    lo = mesh.rank * b
    return tree_map(scenarios, lambda t: t[lo:lo + b].to(mesh.device).contiguous())


def fleet_simulate(
    scenarios: Scenario, cfg: EMConfig, mesh: FleetMesh, full: bool = False,
    traffic: bool = False, behavior: str = "normal",
    pixels: bool = False, return_carry: bool = False,
):
    """Run the closed loop on this rank's shard of a scenario batch (from
    :func:`shard_scenarios`) and reduce the fleet aggregates over the mesh.

    ``full=True`` runs the complete EM loop (``simulate_full``), otherwise
    the path-only loop. ``traffic=True`` instead runs the agent-traffic loop
    (``simulate_traffic``, composing with ``full``). ``pixels=True`` instead
    runs the drive-from-pixels loop (``pixel_loop.simulate_pixels``,
    composing with ``full``; the per-scenario metrics are ``PixelMetrics``,
    whose ``.ticks`` feed the aggregates). Returns (metrics, aggregates):
    this rank's per-scenario metrics and the fleet aggregates, 0-d float32
    tensors on the mesh's device, equal on every rank: lateral RMSE, mean
    speed, collision count, scenario count, infeasible plan cycles and
    planner drops. ``return_carry=True`` appends this rank's final loop
    carry: ``(metrics, agg, carry)``."""
    if pixels and traffic:
        raise ValueError("pixels and traffic modes are mutually exclusive")
    dev = mesh.device
    if pixels:
        carry, metrics = pixel_loop.simulate_pixels(*scenarios, cfg, full=full,
                                                    device=dev)
    elif traffic:
        carry, metrics = closed_loop.simulate_traffic(
            *scenarios, cfg, behavior=behavior, full=full, device=dev)
    elif full:
        carry, metrics = closed_loop.simulate_full(*scenarios, cfg, device=dev)
    else:
        carry, metrics = closed_loop.simulate(*scenarios, cfg, device=dev)

    tk = metrics.ticks if pixels else metrics
    b = tk.lateral_err.shape[0]
    f32 = torch.float32
    lat = tk.lateral_err
    # feasible and segments_dropped are constant within a plan cycle: count
    # them from each cycle's first tick (metrics are (b, n_plans, plan_every))
    partial = torch.stack([
        (lat * lat).sum(),
        torch.tensor(float(lat.numel()), dtype=f32, device=dev),
        tk.collided.reshape(b, -1).any(1).to(f32).sum(),
        tk.speed_kmh.sum(),
        torch.tensor(float(b), dtype=f32, device=dev),
        (1.0 - tk.feasible[..., 0].to(f32)).sum(),
        tk.segments_dropped[..., 0].to(f32).sum(),
    ])
    dist.all_reduce(partial, op=dist.ReduceOp.SUM, group=mesh.group)
    sq, ticks, col, speed, n, infeasible, dropped = partial.unbind()
    agg = {
        "lateral_rmse": torch.sqrt(sq / ticks),
        "mean_speed_kmh": speed / ticks,
        "collisions": col,
        "n_scenarios": n,
        "infeasible_cycles": infeasible,
        "segments_dropped": dropped,
    }
    if return_carry:
        return metrics, agg, carry
    return metrics, agg
