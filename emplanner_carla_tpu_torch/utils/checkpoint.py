"""Checkpoint / resume of fleet simulation state (counterpart of
``emplanner_carla_tpu/utils/checkpoint.py``).

A checkpoint is a directory. Each rank of a fleet writes its own shard
file, a flat ``{field path: tensor}`` dict saved with ``torch.save`` (tensors
only, so ``torch.load(..., weights_only=True)`` reads it). Restoring takes a
template of the saved tree (the carry of a run of the same shape): its
structure rebuilds the NamedTuples, and each tensor lands on the device and
dtype of its template leaf.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from emplanner_carla_tpu_torch.sim import closed_loop


def _flatten(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().to("cpu", copy=True)
    elif isinstance(tree, tuple):
        names = tree._fields if hasattr(tree, "_fields") else range(len(tree))
        for name, leaf in zip(names, tree):
            _flatten(leaf, f"{prefix}/{name}", out)
    elif tree is not None:
        raise TypeError(f"{prefix}: cannot checkpoint a {type(tree).__name__}")
    return out


def _rebuild(template, prefix: str, flat: dict):
    if isinstance(template, torch.Tensor):
        if prefix not in flat:
            raise ValueError(f"checkpoint has no field {prefix}")
        t = flat[prefix]
        if tuple(t.shape) != tuple(template.shape):
            raise ValueError(f"{prefix}: checkpoint shape {tuple(t.shape)}, template "
                             f"{tuple(template.shape)}")
        return t.to(device=template.device, dtype=template.dtype)
    if isinstance(template, tuple):
        names = template._fields if hasattr(template, "_fields") else range(len(template))
        items = [_rebuild(leaf, f"{prefix}/{name}", flat)
                 for name, leaf in zip(names, template)]
        return type(template)(*items) if hasattr(template, "_fields") else tuple(items)
    return template


def _shard_file(path: str) -> str:
    """This rank's shard in checkpoint directory ``path``: the rank and
    world size of the default process group, else rank 0 of 1."""
    rank, world = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
                   else (0, 1))
    return os.path.join(path, f"shard-{rank:05d}-of-{world:05d}.pt")


def save(path: str, carry, metrics=None) -> None:
    """Write this rank's shard of a checkpoint directory at ``path``: the
    carry and, if given, the metrics. Under a process group of several
    ranks (a fleet), each rank writes its own shard."""
    payload = _flatten(carry, "carry", {})
    if metrics is not None:
        _flatten(metrics, "metrics", payload)
    os.makedirs(path, exist_ok=True)
    dst = _shard_file(path)
    tmp = f"{dst}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, dst)


def restore(path: str, carry_like, metrics_like=None):
    """Restore this rank's shard against templates of the saved trees
    (``carry_like`` / ``metrics_like`` give structure, shapes, dtypes and
    devices). Returns the carry, or (carry, metrics) with ``metrics_like``.
    Raises ``ValueError`` on a field the checkpoint lacks or a shape that
    differs from the template's."""
    flat = torch.load(_shard_file(path), map_location="cpu", weights_only=True)
    carry = _rebuild(carry_like, "carry", flat)
    if metrics_like is not None:
        return carry, _rebuild(metrics_like, "metrics", flat)
    return carry


def resume_simulation(global_path, carry, cfg, n_plans: int, full: bool = False,
                      behavior: str | None = None, device="cuda"):
    """Continue a closed-loop run from a restored carry for ``n_plans`` more
    cycles, on ``device`` (the card unless the caller asks for the CPU). The
    loop re-enters with the carried ego and obstacle world; the controller
    and the QP warm states start fresh, as at any controller rebind
    (``test_9.py:415-417`` semantics).

    A restored ``closed_loop.TrafficCarry`` resumes the agent-traffic loop
    (preset ``behavior``, default ``"normal"``) with the NPCs' carried match
    indices and lane state: a mid-lane-change NPC continues its manoeuvre."""
    cfg2 = dataclasses.replace(
        cfg, loop=dataclasses.replace(cfg.loop, n_plans=n_plans)
    )
    if isinstance(carry, closed_loop.TrafficCarry):
        return closed_loop.simulate_traffic(
            global_path, carry.loop.ego, carry.loop.obstacles, cfg2,
            behavior=behavior or "normal", full=full,
            npc_init=(carry.npc_path_index, carry.npc_lane), device=device,
        )
    sim = closed_loop.simulate_full if full else closed_loop.simulate
    return sim(global_path, carry.ego, carry.obstacles, cfg2, device=device)
