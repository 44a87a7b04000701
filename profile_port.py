"""Where the PyTorch port's full EM plan cycle spends its time on the GPU.

Drives ``closed_loop.simulate_full`` (path + S-T speed planning) at batch
4096 with 256-point paths on one NVIDIA card, at config 5 (LQR + kinematic
plant) or, with ``--config 4``, at config 4 (MPC + dynamic bicycle), with
``--config 6`` on fleets routed by the device A* over ``grid_town_curved``,
with ``--config 7`` ``closed_loop.simulate_traffic`` at config 7 (the full
EM cycle with NPC agents, normal preset), or with ``--config 8``
``pixel_loop.simulate_pixels`` (the full EM cycle on the camera's
estimates), and prints JSON lines. It breaks a cycle down; the end-to-end
rate (cycles/s) is ``chip_smoke.py``'s.

1. ``device``: from a ``torch.profiler`` trace of an unsynchronised
   2-cycle run, the device events per cycle, the device busy time per
   cycle (union of the device event intervals), the device's idle share
   against the profiled run's wall (the profiler slows the host, so the
   unprofiled cycle idles more) and, given ``--e2e``, against the median
   unprofiled cycle that ``chip_smoke.py --summary`` measured, and the
   device time of each hand-written kernel (the two QP sites share one
   kernel symbol);
2. ``stages``: per planner stage, from a second trace in which every stage
   is bracketed by ``torch.cuda.synchronize()`` and named by
   ``utils/profiling.py``'s ``annotate``: host wall, device time and device
   events per cycle. No checksum runs inside a timed span (``profiling.sync``
   materialises the scenario before the timed run, and its kernels are left
   out of the device counts). The synchronisation serialises host and device,
   so these walls add up to more than the unsynchronised cycle; they rank
   the stages, and device time against wall says which are launch-bound;
3. ``top_ops``: the device events with the most total time.

Run from the root of a checkout, on a machine with the card, after
``chip_smoke.py`` on the same machine:

    python3 chip_smoke.py --summary e2e.json && python3 profile_port.py --e2e e2e.json [--config 4|6|7|8]

Imports no JAX. Fails when there is no card or the trace holds no device
events.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys

BATCH = 4096
# chip_smoke.py's seeds and names of each profiled path
SEEDS = {4: 1, 5: 1, 6: 2, 7: 1, 8: 3}
PATHS = {4: "simulate_full config 4", 5: "simulate_full config 5",
         6: "simulate_full config 6, routed", 7: "simulate_traffic config 7",
         8: "simulate_pixels config 8"}
N_PLANS = 2
KERNELS = {"qp_admm (path + speed sites)": "qp_admm_kernel",
           "path_obs_costs": "path_obs_kernel",
           "speed_dp": "speed_dp_kernel",
           "tick (K3; K5 + K6 at config 4; K7 at config 7)": "tick_kernel"}


def _stage_targets():
    """(module, function name, stage label) of every wrapped stage, in the
    order the plan cycle runs them."""
    from emplanner_carla_tpu_torch.ops import frenet
    from emplanner_carla_tpu_torch.planner import (
        path_dp, path_qp, reference_line, speed_planner, trajectory,
    )
    from emplanner_carla_tpu_torch.sim import (
        camera, closed_loop, detector, perception, pixel_loop, plant,
    )

    return [
        (camera, "render_columns", "camera (column view)"),
        (camera, "render", "camera (frame)"),
        (detector, "detect_from_columns", "detector"),
        (detector, "detect", "detector"),
        (pixel_loop, "update_tracks", "tracker"),
        (pixel_loop, "estimates", "tracker"),
        (pixel_loop, "perception_error", "perception_error"),
        (plant, "predict_forward", "predict"),
        (reference_line, "build_reference_line", "reference_line"),
        (frenet, "s_map_from_origin", "frenet"),
        (perception, "perceive", "perception"),
        (frenet, "cartesian_to_sl", "frenet"),
        (perception, "static_gate", "perception"),
        (frenet, "cartesian_to_frenet_full", "frenet"),
        (perception, "virtual_obstacles", "perception"),
        (path_dp, "path_dp", "path_dp (K2 inside)"),
        (path_dp, "enrich_dp", "enrich_dp"),
        (path_qp, "corridor", "corridor"),
        (path_qp, "path_qp", "path_qp (K1 inside)"),
        (frenet, "frenet_to_cartesian", "frenet"),
        (reference_line, "smooth_local_path", "smooth_target"),
        (speed_planner, "speed_plan_start", "speed_frenet"),
        (trajectory, "path_arc_length", "speed_frenet"),
        (frenet, "dynamic_obs_frenet", "speed_frenet"),
        (speed_planner, "st_graph", "st_graph"),
        (speed_planner, "top_m_segments", "st_graph"),
        (speed_planner, "speed_dp", "speed_dp (K4)"),
        (speed_planner, "convex_space", "convex_space"),
        (speed_planner, "speed_qp", "speed_qp (K1)"),
        (speed_planner, "densify_speed", "densify_merge"),
        (trajectory, "merge", "densify_merge"),
        (closed_loop, "_all_finite", "plan_guards"),
        (closed_loop, "_sanitize", "plan_guards"),
        (closed_loop, "run_ticks", "ticks (tick kernel)"),
        (closed_loop, "run_traffic_ticks", "ticks (tick kernel, NPC agents)"),
    ]


class _Stages:
    """Wraps the stage functions so that each outermost call runs in a named
    range (``profiling.annotate``) bracketed by ``torch.cuda.synchronize()``."""

    def __init__(self):
        self.originals = []
        self.depth = 0

    def _wrap(self, fn, label):
        import torch

        from emplanner_carla_tpu_torch.utils import profiling

        def staged(*args, **kw):
            if self.depth:
                return fn(*args, **kw)
            self.depth += 1
            try:
                torch.cuda.synchronize()
                with profiling.annotate("stage:" + label):
                    out = fn(*args, **kw)
                    torch.cuda.synchronize()
            finally:
                self.depth -= 1
            return out

        return staged

    def __enter__(self):
        for mod, name, label in _stage_targets():
            fn = getattr(mod, name)
            self.originals.append((mod, name, fn))
            setattr(mod, name, self._wrap(fn, label))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.originals):
            setattr(mod, name, fn)
        self.originals.clear()


def _device_events(prof):
    """The trace's device events, without the annotations and without the
    checksum kernels of ``profiling.sync`` (the device side of its ``sync``
    regions)."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    syncs = [(e.time_range.start, e.time_range.end) for e in dev
             if e.is_user_annotation and e.name == "sync"]
    evs = [e for e in dev
           if not e.is_user_annotation and not e.name.startswith("stage:")
           and not any(s <= e.time_range.start <= t for s, t in syncs)]
    if not evs:
        raise RuntimeError("the profiler trace holds no device events")
    return evs


def _busy_us(evs) -> float:
    """Length of the union of the events' device intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _run(sc, cfg, config: int):
    import torch

    from emplanner_carla_tpu_torch.sim import closed_loop, pixel_loop
    from emplanner_carla_tpu_torch.utils import profiling

    wall = {}
    profiling.sync(sc)
    with profiling.stage_timer("run", wall):
        if config == 7:
            out = closed_loop.simulate_traffic(*sc, cfg, behavior="normal", full=True,
                                               device="cuda")
        elif config == 8:
            out = pixel_loop.simulate_pixels(*sc, cfg, full=True, device="cuda")
        else:
            out = closed_loop.simulate_full(*sc, cfg, device="cuda")
        torch.cuda.synchronize()
    return out, wall["run"]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--e2e", help="chip_smoke.py --summary output, run just before")
    ap.add_argument("--config", type=int, choices=(4, 5, 6, 7, 8), default=5,
                    help="BASELINE config: 5 (LQR, kinematic), 4 (MPC, dynamic), 6 "
                         "(routed fleet), 7 (NPC agents) or 8 (driving from pixels)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from emplanner_carla_tpu_torch import cuda as kbuild
    from emplanner_carla_tpu_torch.config import EMConfig
    from emplanner_carla_tpu_torch.sim import scenario

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kbuild.build_all()

    full = EMConfig()
    if opts.config == 4:
        full = dataclasses.replace(
            full, control=dataclasses.replace(full.control, kind="MPC"),
            plant=dataclasses.replace(full.plant, kind="dynamic"))
    cfg = dataclasses.replace(full, loop=dataclasses.replace(full.loop, n_plans=N_PLANS))
    if opts.config == 6:
        sc = scenario.routed_scenarios_device(SEEDS[6], BATCH, cfg, device="cuda").scenario
    else:
        sc = scenario.batch_scenarios(SEEDS[opts.config], BATCH, cfg, device="cuda")
    _run(sc, cfg, opts.config)                       # warm-up: allocator, caches

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        _, p_wall = _run(sc, cfg, opts.config)
    evs = _device_events(prof)
    busy = _busy_us(evs) / N_PLANS
    kern = {k: sum(e.time_range.elapsed_us() for e in evs if sym in e.name) / N_PLANS
            for k, sym in KERNELS.items()}
    e2e_ms = None
    if opts.e2e:
        with open(opts.e2e) as fh:
            e2e_ms = json.load(fh)["paths"][PATHS[opts.config]]["ms_per_cycle"]
    print(json.dumps({"config": opts.config, "device": {
        "profiled_ms_per_cycle": p_wall / N_PLANS * 1e3,
        "device_events_per_cycle": len(evs) / N_PLANS,
        "device_busy_ms_per_cycle": busy / 1e3,
        "idle_share_of_profiled_run": 1.0 - busy / (p_wall / N_PLANS * 1e6),
        "chip_smoke_median_ms_per_cycle": e2e_ms,
        "idle_share_of_chip_smoke_median": (None if e2e_ms is None
                                            else 1.0 - busy / 1e3 / e2e_ms),
        "kernel_ms_per_cycle": {k: v / 1e3 for k, v in kern.items()}}}), flush=True)

    with _Stages(), profile(activities=acts) as sprof:
        _, s_wall = _run(sc, cfg, opts.config)
    sevs = _device_events(sprof)
    ranges = [(e.name[len("stage:"):], e.time_range.start, e.time_range.end)
              for e in sprof.events()
              if e.name.startswith("stage:") and e.device_type == DeviceType.CPU]
    stages = collections.OrderedDict()
    for label, s, e in ranges:
        st = stages.setdefault(label, {"wall_ms": 0.0, "device_ms": 0.0, "events": 0})
        st["wall_ms"] += (e - s) / 1e3 / N_PLANS
        inside = [d for d in sevs if s <= d.time_range.start <= e]
        st["device_ms"] += sum(d.time_range.elapsed_us() for d in inside) / 1e3 / N_PLANS
        st["events"] += len(inside) / N_PLANS
    staged_sum = sum(v["wall_ms"] for v in stages.values())
    print(json.dumps({"stages": {
        "synced_ms_per_cycle": s_wall / N_PLANS * 1e3,
        "unstaged_ms_per_cycle": s_wall / N_PLANS * 1e3 - staged_sum,
        "per_stage": stages}}), flush=True)

    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in evs:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({"top_ops": [
        {"name": n[:90], "ms_per_cycle": t / 1e3 / N_PLANS, "count_per_cycle": c / N_PLANS}
        for n, (t, c) in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
