"""Quickest proof that the PyTorch port runs on the GPU: drive its main paths
once on one NVIDIA card and hold every CUDA kernel against its plain
PyTorch version.

Run from the root of a checkout, on a machine with the card:

    python3 chip_smoke.py [--summary PATH]

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (``nvidia-smi``) and the kernel build
   time (``nvcc`` on every ``csrc/*.cu``, in parallel);
2. per kernel, on inputs captured from the third plan cycle of a main path
   at batch 4096, the kernel against its plain version on the card, with
   the kernel's device time (CUDA events around launches queued behind a
   spin kernel), its time per call with its wrapper and the plain
   version's (CUDA events), and the least time the card could take:
   - from ``simulate`` (config 3): the warm QP at the path site (x, x_s, z
     at rtol 1e-4 / atol 1e-4, the dual y within 1% of its magnitude), the
     path-DP obstacle costs (bit for bit; also its device time with no
     obstacle valid, ``dead_ms``, the write-and-launch floor) and the tick
     loop (bool channels identical, floats within rtol 1e-5 / atol 5 mm);
   - from ``simulate_full`` (config 5): the speed DP (stations, validity and
     terminal column identical), also on bench config 1's two-segment set
     tiled to the batch, each with its device time on the kernel's first
     block alone (one lane, ``chain_ms``) and with every segment invalid
     (``dead_ms``), and the warm QP at the speed site (as at the path
     site but at atol 1e-3, the equality rows' dual held by the next
     solve, see ``_check_qp``);
   - from ``simulate_full`` with two traffic lights a lane: the tick loop's
     lights branch (the tick loop's bar);
   - from ``simulate_full`` at config 4 (MPC + dynamic bicycle): the tick
     kernel's other instantiations on that cycle's inputs, MPC + dynamic
     (config 4's launch), MPC + kinematic (K5 alone), LQR + dynamic (K6
     alone) and the feedforward MPC variant with two plant steps a tick, each
     at the JAX package's kernel-vs-scan bar (``tests/test_tick_pallas.py``:
     positions, speed and PID buffer within 1e-3, heading 5e-4, obstacles
     1e-4, lateral error 2e-3; PID count and decisions identical), with the
     (lane, tick) pairs that ran the MPC's box ADMM;
   - the cold QP (K1c) at the speed site, on bench config 1's two-segment
     set tiled to the batch, and at the path site, on bench config 2's
     open-loop plan: x within the site's K1 bar;
   - for the tick kernel's instantiations also the device time on the
     first 32 lanes alone (one block of the kernel: the time of one lane's
     chain of ticks, ``chain_ms``) and a SHA-256 digest of the captured
     inputs (``inputs_digest``), by which two runs show that they timed the
     same tensors;
   - for the QP kernel at its four sites also its tile, blocks a launch and
     shared memory a block, and two bounds, with the products counted over
     A's nonzero entries (A is sparse, Kinv dense): its operations at the
     rates of the units that do them at the required precision (the
     products' flops x 3 passes at the dense TF32 rate, the elementwise
     flops at the FP32 rate; the JSON line's ``bound_ms``) and every flop at
     the FP32 rate (``bound_fp32_ms``);
   - from ``simulate_traffic`` at config 7 (full EM, NPC agents, normal
     preset), the tick kernel's agent-traffic branch (K7): LQR + kinematic,
     with the traffic lights, and MPC + dynamic (config 4's controller and
     plant), each held bit for bit or, failing that, at the JAX package's
     kernel-vs-scan traffic bar (the tick bar; NPC indices, lane targets and
     decisions identical, lane offsets within 1e-5, NPC positions and
     velocities within 1e-3), with the live agent (lane, tick) pairs;
   - on new input distributions, printed beside the kernel lines and not in
     the JSON line: K1 at both sites, K2, K4 and the tick kernel on the
     third plan cycle of config 6 (routed roads: junction arcs, padded
     tails) and of config 8 (obstacles estimated from the camera), each at
     its bar above;
3. end to end, each main path with every launch counter taken from zero
   just before it and read just after, and with the plain tick loops made
   to raise: ``simulate`` at config 3, ``simulate_full`` at configs 5 and 4
   and ``simulate_traffic`` at config 7 (batch 4096, 20 plans x 100 ticks,
   256-point paths), ``simulate_full`` at config 6 (fleets routed by
   ``scenario.routed_scenarios_device`` over ``grid_town_curved``) and
   ``pixel_loop.simulate_pixels`` at config 8 (full EM on the camera's
   estimates; also its mean tracked count and perception error, and its
   collisions beside the JAX package's recorded 0/4096, a finding), five
   timed runs each, finite metrics, collisions, lateral RMSE and the median
   cycles/s; then once each ``simulate_full`` with the traffic lights,
   config 4 on the kinematic plant, config 5 on the dynamic plant and
   config 4 with the feedforward MPC and two plant steps a tick,
   ``simulate_traffic`` with the traffic lights, with walkers and under MPC
   + the dynamic bicycle, and ``simulate_pixels`` path-only; then bench
   config 1 (standalone S-T DP + cold speed QP, solves/s), config 2
   (open-loop path plan, plans/s) and config 6b (4096 device route queries
   over ``grid_town_curved``, A* + backtracking + stitching to 256 points,
   routes/s, no kernel launched, with the reached share), five timed runs
   each; then once the test_9 drive (``scenario.test9_scenario``,
   ``simulate_traffic`` under MPC + the dynamic bicycle, 5 plans: lateral
   RMSE, collisions);
4. the fleet and the utilities: ``parallel.fleet.make_mesh()`` (a one-rank
   NCCL group on the card; the phase fails if NCCL does not start), then
   ``fleet_simulate(full=True)`` at config 5 (batch 4096 x 20 x 100, five
   timed runs, config 5's launch counts; per-scenario metrics identical to
   the same call's ``simulate_full`` config 5 run, else held at the loop's
   bar and said so; the six aggregates equal to a float64 host reduction
   of the metrics, rtol 1e-5, the counts exact), and once each at batch
   4096 x 2 plans its traffic (config 7, full EM), pixel (config 8, full
   EM) and path-only modes; ``utils.checkpoint`` save / restore of the
   config 5 ``LoopCarry`` and the config 7 ``TrafficCarry`` bit for bit on
   the card, and ``resume_simulation`` of the restored ``TrafficCarry``
   identical to the in-memory resume; ``utils.report.run_report`` of lane 0
   and its ``camera_keyframes`` on the card; ``utils.profiling``'s
   ``sync`` and ``stage_timer`` around one config 5 cycle and a ``trace``
   of one, which must name the four kernel symbols and the ``annotate``
   region;
5. device equivalence: ``simulate``, ``simulate_full`` (with and without
   lights), ``simulate_full`` at configs 4 and 6, ``simulate_traffic`` at
   config 7 and ``simulate_pixels`` (full EM, path-only, and path-only on
   the rendered frame) on 128 scenarios x 2 plans with ``device="cuda"``
   and ``device="cpu"``; config 6b's route engine on 128 pairs, identical;
6. the edge phase, the reference's own edge-case scenarios (builders from
   NumPy, held equal to the JAX tests' by
   ``tests/test_torch_edge_builders.py``): planted lanes of the batch (lanes
   ``PLANTED``: a NaN ego speed, the obstacle wall, the wall with NaN
   obstacle slots, ``tests/test_feasibility.py:140``, :55, :106) in
   ``simulate`` (config 3), ``simulate_full`` (config 5) and
   ``simulate_traffic(full=True)`` (config 7), 8 plans and a 12 m lateral
   gate, each beside the same batch clean: the healthy lanes' metrics and
   carry bit for bit the clean run's, the planted lanes meeting the JAX
   test's assertions and equal to the same lanes' CPU run (NaN at the same
   places); then ``EDGE_CASES`` (a crosser the ego cannot yield to, a red
   light, a walker, an NPC's lane change, a stopped ego behind its lead,
   the emergency brake on arrival) broadcast to the batch: every lane
   lane 0's bits, lane 0 equal to the CPU run and meeting the JAX test's
   assertions; the phase's wall;
7. the script's wall time, a ``{"kernels": [...]}`` JSON line, then the
   last line ``{"ok": true, "device": {...}}``.

``--summary PATH`` also writes the end-to-end medians there as JSON
(``profile_port.py --e2e PATH`` reads them). Needs no network and imports
no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
import time

SEED = 1
BATCH = 4096
H100_FP32_FLOPS = 67e12     # published, SXM, outside the tensor cores
H100_TF32_FLOPS = 495e12    # published, SXM, dense TF32 on the tensor cores
H100_BYTES_PER_S = 3.35e12  # published HBM3 rate
QP_PASSES = 3               # the QP's products' passes in the bound (3xTF32)
# traffic lights of the lights phases: stop lines at these path stations,
# a 12 s cycle green for its first half, phase offsets spread over the batch
LIGHT_S = (30.0, 60.0)
# per-kernel checks printed beside the times, not part of the JSON line
_EXTRA = ("y_max_abs_err", "candidates_in_window", "speed_columns_read",
          "live_triples", "lanes_capped", "input", "admm_lane_ticks",
          "admm_lane_ticks_plain", "live_agent_lane_ticks",
          "scanned_actor_lane_ticks", "bit_exact", "bound_fp32_ms",
          "tile_lanes", "blocks", "smem_bytes", "chain_ms", "inputs_digest", "dead_ms",
          "window_samples")
# lanes of the tick kernel's single-chain timing: one block of the kernel
CHAIN_LANES = 32
# bench config 6 routes its fleet with seed 2 and config 6b draws its queries
# with seed 7 (bench_all.py:127,142); stitched routes are padded to 256 points
ROUTED_SEED = 2
ROUTE_QUERY_SEED = 7
ROUTE_PAD = 256
# plan cycles of the test_9 drive (tests/test_town05.py:58-83)
TEST9_PLANS = 5
# bench config 8 drives batch_scenarios with seed 3 (bench_all.py:181)
PIXEL_SEED = 3


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int, warm: int = 1) -> float:
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int, call_ms: float) -> float:
    """Device time per call of ``fn`` over ``reps`` calls launched back to
    back, without the host work of its wrapper (which, for a kernel of a
    few microseconds, is the longer). A spin kernel holds the stream while
    the host queues the calls, so the CUDA events around them see only the
    device; the start event must still be pending once the last call is
    queued, else the spin is lengthened and the reading taken again. The
    interval holds every device op of the wrapper: for the tick loop, the
    packing of its inputs and the casts of its outputs besides the kernel.
    ``call_ms`` is the time of one call with its wrapper."""
    import torch

    spin_ms = max(5.0, 4.0 * reps * call_ms)
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * 2e6))  # clock cycles: >= spin_ms at <= 2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_behind_spin = not start.query()
        torch.cuda.synchronize()
        if queued_behind_spin:
            return start.elapsed_time(end) / reps
        spin_ms *= 4.0
    raise AssertionError(f"the host took longer than a {spin_ms / 4.0:.0f} ms "
                         f"spin to queue {reps} calls")


def _first_lanes(x, B: int, n: int):
    """The first n lanes of every batch-major tensor in x (nested tuples,
    NamedTuples, dicts); everything else as it is."""
    import torch

    if isinstance(x, torch.Tensor):
        return x[:n].contiguous() if x.dim() and x.shape[0] == B else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_first_lanes(v, B, n) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_first_lanes(v, B, n) for v in x)
    if isinstance(x, dict):
        return {k: _first_lanes(v, B, n) for k, v in x.items()}
    return x


def _digest(*trees) -> str:
    """SHA-256 (first 16 hex digits) of every tensor's shape and bytes in
    the nested tuples, NamedTuples and dicts given, and of their strings and
    numbers; other objects (configs) are skipped."""
    import torch

    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, torch.Tensor):
            h.update(f"{x.dtype}{tuple(x.shape)}".encode())
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                walk(x[k])
        elif x is None or isinstance(x, (str, int, float, bool)):
            h.update(repr(x).encode())

    for t in trees:
        walk(t)
    return h.hexdigest()[:16]


def _chain_ms(run, args, kw) -> float:
    """Device ms of ``run`` on the first CHAIN_LANES lanes of its arguments
    alone: one block of the tick kernel, the time of one lane's chain of
    ticks with nothing else on the card."""
    B = args[0].x.shape[0]
    a, k = _first_lanes(args, B, CHAIN_LANES), _first_lanes(kw, B, CHAIN_LANES)
    fn = lambda: run(*a, **k)  # noqa: E731
    return _device_ms(fn, 20, _time_ms(fn, 20))


def _bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _qp_bound(solver, q, nbytes):
    """The QP kernel's bounds for one launch on q's batch: (the bound at the
    rates of the units that do its work at the required precision: the
    products' flops x 3 passes at the dense TF32 rate plus the elementwise
    flops at the FP32 rate, or the bytes; the bound with every flop at the
    FP32 rate). The products are counted as the function needs them: A^T v
    and A x over A's nonzero entries, Kinv rhs dense."""
    import numpy as np

    B, n, m = q.shape[0], solver.n, solver.m
    P, it = solver.rho.shape[0], solver.iters
    prod = 2.0 * B * P * it * (2 * np.count_nonzero(solver.At) + n * n)
    elem = B * P * it * (10 * m + 3 * n)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_tc = (prod * QP_PASSES / H100_TF32_FLOPS + elem / H100_FP32_FLOPS) * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_tc else (t_tc, "operations")
    return bound, by, _bound_ms(nbytes, prod + elem)[0]


def _qp_layout(solver, q):
    from emplanner_carla_tpu_torch.ops import qp as t_qp

    return dict(tile_lanes=t_qp.KERNEL_LANES,
                blocks=-(-q.shape[0] // t_qp.KERNEL_LANES),
                smem_bytes=t_qp.kernel_layout(solver.n, solver.m)["smem_bytes"])


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _with_plans(cfg, n_plans: int):
    return dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, n_plans=n_plans))


def _lights_for(gp, device):
    """Two traffic lights a lane on its global path (B, N), the phase offsets
    spread over [0, 12) s across the batch so that both phases occur."""
    import torch

    from emplanner_carla_tpu_torch.sim import scenario

    B = gp.x.shape[0]
    off = torch.arange(B, dtype=torch.float32) * (12.0 / B)
    return scenario.lights_on_path(gp, LIGHT_S, period=12.0, green_frac=0.5,
                                   offsets=off[:, None].expand(B, len(LIGHT_S)),
                                   device=device)


def _capture_cycle(run, cfg, n_plans: int):
    """Run ``run(cfg)`` for the first ``n_plans`` plan cycles of a main path,
    recording each kernel wrapper's arguments in the last of them (the QP's
    keyed by its call site)."""
    return _capture(lambda: run(_with_plans(cfg, n_plans)))


def _capture(fn):
    """Run ``fn()``, recording each kernel wrapper's arguments at its last
    launch (the QP's keyed by its call site)."""
    import torch

    from emplanner_carla_tpu_torch.ops import qp as t_qp
    from emplanner_carla_tpu_torch.planner import path_dp as t_dp
    from emplanner_carla_tpu_torch.planner import speed_planner as t_sp
    from emplanner_carla_tpu_torch.sim import closed_loop as t_cl

    captured = {}
    originals = {
        (t_qp, "warm_admm_kernel"): t_qp.warm_admm_kernel,
        (t_dp, "transition_obstacle_costs_kernel"): t_dp.transition_obstacle_costs_kernel,
        (t_cl, "run_ticks_kernel"): t_cl.run_ticks_kernel,
        (t_cl, "run_traffic_ticks_kernel"): t_cl.run_traffic_ticks_kernel,
        (t_sp, "speed_dp_kernel"): t_sp.speed_dp_kernel,
    }

    def recorder(name, fn):
        def wrapped(*args, **kw):
            captured[args[0].name if name == "warm_admm_kernel" else name] = (args, kw)
            return fn(*args, **kw)
        return wrapped

    for (mod, name), orig in originals.items():
        setattr(mod, name, recorder(name, orig))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for (mod, name), orig in originals.items():
            setattr(mod, name, orig)
    return captured


def _check_qp(captured, site, replaces, eq_mask=None):
    """The warm QP kernel against its plain ladder on a site's captured
    arguments: x, x_s, z at rtol 1e-4 / atol 1e-4, y within 1% of its
    magnitude. With ``eq_mask`` (the speed site), y is compared so on the
    inequality rows only: on the equality rows (rho scaled by 1e3) it
    random-walks over the site's 3 x 40 iterations between two operation
    orders by up to ~0.4 and moves x by 1e-3 of that, so x, x_s and z are
    held at atol 1e-3 there (2.65e-4 was measured at batch 4096), and the
    equality rows' y by what it does: the next solve from the kernel's
    state and from the plain version's state agree within atol 5e-3, the
    functional bar of the JAX package's own warm-state test
    (``tests/test_qp_pallas.py``)."""
    import torch

    from emplanner_carla_tpu_torch.ops import qp as t_qp

    (solver, q, l, u, state), _ = captured[site]

    def compare(label, x_k, st_k, x_p, st_p, atol=1e-4):
        err = 0.0
        for name, a, b in (("x", x_k, x_p), ("x_s", st_k[0], st_p[0]),
                           ("z", st_k[1], st_p[1])):
            if not torch.allclose(a, b, rtol=1e-4, atol=atol):
                raise AssertionError(f"{site}{label} {name}: max |diff| "
                                     f"{float((a - b).abs().max())}")
            err = max(err, float((a - b).abs().max()))
        yk, yp = st_k[2], st_p[2]
        if eq_mask is not None:
            rows = torch.as_tensor(~eq_mask, device=yk.device)
            yk, yp = yk[:, rows], yp[:, rows]
        y_tol = 1e-2 * float(yp.abs().max())
        y_err = float((yk - yp).abs().max())
        if not y_err <= y_tol:
            raise AssertionError(f"{site}{label} y: max |diff| {y_err} > {y_tol}")
        return err, y_err

    x_k, st_k = t_qp.warm_admm_kernel(solver, q, l, u, state)
    x_p, st_p = t_qp.warm_ladder_torch(solver, q, l, u, state)
    torch.cuda.synchronize()
    err, y_err = compare("", x_k, st_k, x_p, st_p,
                         atol=1e-4 if eq_mask is None else 1e-3)
    if eq_mask is not None:
        x_k2, st_k2 = t_qp.warm_admm_kernel(solver, q, l, u, st_k)
        x_p2, st_p2 = t_qp.warm_ladder_torch(solver, q, l, u, st_p)
        torch.cuda.synchronize()
        compare(" (next solve)", x_k2, st_k2, x_p2, st_p2, atol=5e-3)
    k1 = lambda: t_qp.warm_admm_kernel(solver, q, l, u, state)  # noqa: E731
    call_ms = _time_ms(k1, 20)
    ms = _device_ms(k1, 20, call_ms)
    plain_ms = _time_ms(lambda: t_qp.warm_ladder_torch(solver, q, l, u, state), 3)
    k = solver.consts(q.device)
    nbytes = _nbytes(q, l, u, *state, k["At"], k["Kinv"], k["rho"], k["D"], k["E"]) \
        + _nbytes(x_k, *st_k)
    bound, by, bound_fp32 = _qp_bound(solver, q, nbytes)
    return dict(
        name=site, route="cuda", source="emplanner_carla_tpu_torch/csrc/qp_admm.cu",
        replaces=replaces, max_abs_err=err, ms=ms, call_ms=call_ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        y_max_abs_err=y_err, bound_fp32_ms=bound_fp32,
        **_qp_layout(solver, q))


def _check_path_obs(captured):
    import torch

    from emplanner_carla_tpu_torch.planner import path_dp as t_dp

    (obs_s, obs_l, obs_valid, ps, pcfg), _ = captured["transition_obstacle_costs_kernel"]
    a = t_dp.transition_obstacle_costs_kernel(obs_s, obs_l, obs_valid, ps, pcfg)
    b = t_dp._transition_obstacle_costs_torch(obs_s, obs_l, obs_valid, ps, pcfg)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"path_obs not bit-identical: max |diff| "
                             f"{float((a - b).abs().max())}")
    k2 = lambda: t_dp.transition_obstacle_costs_kernel(  # noqa: E731
        obs_s, obs_l, obs_valid, ps, pcfg)
    call_ms = _time_ms(k2, 50)
    ms = _device_ms(k2, 50, call_ms)
    # the write-and-launch floor: no obstacle valid
    none = torch.zeros_like(obs_valid)
    k2_d = lambda: t_dp.transition_obstacle_costs_kernel(  # noqa: E731
        obs_s, obs_l, none, ps, pcfg)
    dead_ms = _device_ms(k2_d, 50, _time_ms(k2_d, 50))
    plain_ms = _time_ms(lambda: t_dp._transition_obstacle_costs_torch(
        obs_s, obs_l, obs_valid, ps, pcfg), 5)
    # work this run's data needs: every (lane, slot, candidate) in window
    # evaluates rows^2 edges x samples at ~12 float operations each
    h = float(pcfg.sample_s)
    span = h * (pcfg.n_edge_samples - 1) / pcfg.n_edge_samples
    r = obs_s - ps[:, None]
    n1 = torch.floor((r + pcfg.safe_dist) / h)
    n_lo = (r - pcfg.safe_dist - span) / h
    n_ok = 0
    for cn in (n1 - 1.0, n1):
        ok = (cn >= 1) & (cn <= pcfg.cols - 1) & (cn >= n_lo) & obs_valid
        n_ok += int(ok.sum())
    RR = pcfg.rows * pcfg.rows
    flops = 12.0 * n_ok * RR * pcfg.n_edge_samples
    tl, uh = t_dp._kernel_tables(pcfg, str(obs_s.device))
    nbytes = _nbytes(obs_s, obs_l, obs_valid, ps, tl, uh, a)
    bound, by = _bound_ms(nbytes, flops)
    return dict(
        name="path_obs_costs", route="cuda",
        source="emplanner_carla_tpu_torch/csrc/path_obs.cu",
        replaces="emplanner_carla_tpu/ops/path_obs_pallas.py:47",
        max_abs_err=0.0, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=None, candidates_in_window=n_ok, dead_ms=dead_ms)


def _tick_bar(name, out_k, out_p):
    """The JAX package's kernel-vs-scan bar (``tests/test_tick_pallas.py``):
    ego x, y, vx and the PID buffer within 1e-3, heading within 5e-4,
    obstacle x within 1e-4, the x metric within 1e-3, the lateral error
    within 2e-3; PID count, arrival and the decision channels identical."""
    import torch

    ek, ep = out_k[0], out_p[0]
    for ch, a, b, atol in (
        ("x", ek.x, ep.x, 1e-3), ("y", ek.y, ep.y, 1e-3), ("phi", ek.phi, ep.phi, 5e-4),
        ("vx", ek.vx, ep.vx, 1e-3), ("pid_buffer", out_k[1], out_p[1], 1e-3),
        ("obs.x", out_k[4].x, out_p[4].x, 1e-4), ("metric x", out_k[6][0], out_p[6][0], 1e-3),
        ("lateral_err", out_k[6][3], out_p[6][3], 2e-3),
    ):
        err = float((a - b).abs().max())
        if not err <= atol:
            raise AssertionError(f"{name} {ch}: max |diff| {err} > {atol}")
    for ch, a, b in (("pid_count", out_k[2], out_p[2]), ("arrived", out_k[5], out_p[5]),
                     ("collided", out_k[6][5], out_p[6][5]),
                     ("arrived metric", out_k[6][6], out_p[6][6]),
                     ("feasible", out_k[6][7], out_p[6][7])):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} {ch}: {int((a != b).sum())} of {a.numel()} differ")


def _tick_work(cfg, args, kw, out_k, out_p):
    """(bytes, float operations, extra checks) of one tick-loop call on
    these inputs, counted from this run's data."""
    import torch

    ego, pbuf, pcnt, plast, obs, tspeed, ttime, target = args[:8]
    B, K, NP, NB = ego.x.shape[0], obs.x.shape[1], target.x.shape[1], pbuf.shape[1]
    T = cfg.loop.plan_every
    lights = kw.get("lights")
    L = 0 if lights is None else lights.x.shape[1]
    cc, pc = cfg.control, cfg.plant
    # per tick: two first-min matches (6 ops per path node), the obstacle
    # passes (ACC gate, advance, collision: ~25 ops per slot), the red-light
    # gate (~20 ops per light), the PID window sum where ki != 0 and ~200
    # scalar ops of controller, plant and metrics; ~40 more a plant step for
    # each extra step and for the dynamic bicycle's tyre forces
    per_tick = 2 * NP * 6 + K * 25 + L * 20 + (NB if cc.ki != 0.0 else 0) + 200
    per_tick += 40 * (pc.substeps - 1) + (40 * pc.substeps if pc.kind == "dynamic" else 0)
    flops = float(B) * T * per_tick
    extra = {}
    if cc.kind == "MPC":
        nu = cc.mpc_n * cc.mpc_p
        # every tick: the W1 / w2 lerps and u* (~25 ops a variable); a
        # (lane, tick) that runs the ADMM adds the G1 / g2 lerps and f (~25
        # a variable), the Minv lerp (3 a entry) and per iteration the
        # product Minv v (2 nu^2) and ~5 ops a variable
        admm = int(out_k[7].admm_ticks.sum())
        flops += float(B) * T * 25 * nu + admm * (
            25 * nu + 3 * nu * nu + cc.mpc_warm_admm_iters * (2 * nu * nu + 5 * nu))
        extra["admm_lane_ticks"] = admm
        extra["admm_lane_ticks_plain"] = int(out_p[7].admm_ticks.sum())
    # the speed profile is read only where the ticks' hat lookups land
    # (t_rel = dt .. T*dt), two entries of the time grid give its spacing;
    # the target path is counted whole (heading and curvature are read
    # only at the matched nodes, so this counts up to 2*NP floats a lane
    # more than the least)
    ND = tspeed.shape[1]
    t_rel = torch.arange(1, T + 1, dtype=torch.float32, device=ttime.device) \
        * float(cfg.plant.dt)
    u = torch.clamp((t_rel - ttime[0]) / (ttime[1] - ttime[0]), 0.0, ND - 1.0)
    k0 = torch.clamp(torch.floor(u).long(), max=ND - 2)
    cols_read = int(torch.unique(torch.cat([k0, k0 + 1])).numel())
    nbytes = _nbytes(*list(ego), pbuf, pcnt, plast, *list(obs), *list(target),
                     *args[8:13]) + B * cols_read * tspeed.element_size() \
        + 2 * ttime.element_size() \
        + _nbytes(*list(out_k[0]), out_k[1], out_k[2], out_k[3], out_k[4].x,
                  out_k[4].y, out_k[5], *out_k[6])
    if out_k[7] is not None:
        from emplanner_carla_tpu_torch.control import lateral

        nbytes += _nbytes(*out_k[7], lateral.mpc_tables_on(
            cfg.vehicle, cc, str(ego.x.device))[2]["packed"])
    if lights is not None:
        nbytes += _nbytes(*list(lights), kw["t0"])
    extra["speed_columns_read"] = cols_read
    return nbytes, flops, extra


def _check_ticks(cfg, captured, name, replaces, tick_bar=False):
    """The tick kernel against its plain loop on captured arguments (with
    the captured lights, if any), run under ``cfg``: bool channels
    identical, floats within rtol 1e-5 / atol 5 mm; with ``tick_bar`` the
    JAX package's kernel-vs-scan bar (:func:`_tick_bar`) instead."""
    import torch

    from emplanner_carla_tpu_torch.sim import closed_loop as t_cl

    args, kw = captured["run_ticks_kernel"]
    args = args[:-1] + (cfg,)
    out_k = t_cl.run_ticks_kernel(*args, **kw)
    out_p = t_cl._full_ticks_base(*args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    names = t_cl.TickMetrics._fields[:8]
    for ch, a, b in zip(names, out_k[6], out_p[6]):
        if a.dtype == torch.bool:
            if not tick_bar and not torch.equal(a, b):
                raise AssertionError(f"{name} {ch}: {int((a != b).sum())} "
                                     f"of {a.numel()} differ")
        else:
            if not tick_bar and not torch.allclose(a, b, rtol=1e-5, atol=5e-3):
                raise AssertionError(f"{name} {ch}: max |diff| "
                                     f"{float((a - b).abs().max())}")
            err = max(err, float((a - b).abs().max()))
    if tick_bar:
        _tick_bar(name, out_k, out_p)
    k3 = lambda: t_cl.run_ticks_kernel(*args, **kw)  # noqa: E731
    call_ms = _time_ms(k3, 20)
    ms = _device_ms(k3, 20, call_ms)
    chain = _chain_ms(t_cl.run_ticks_kernel, args, kw)
    plain_ms = _time_ms(lambda: t_cl._full_ticks_base(*args, **kw), 2)
    nbytes, flops, extra = _tick_work(cfg, args, kw, out_k, out_p)
    if kw.get("lights") is not None:
        # lanes whose cycle the red-light cap changed: the lights-free run
        # of the same arguments ends at another speed
        free = t_cl.run_ticks_kernel(*args)
        extra["lanes_capped"] = int((out_k[6][2][:, -1] != free[6][2][:, -1]).sum())
    bound, by = _bound_ms(nbytes, flops)
    return dict(
        name=name, route="cuda", source="emplanner_carla_tpu_torch/csrc/tick_lqr.cu",
        replaces=replaces, max_abs_err=err, ms=ms, call_ms=call_ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        chain_ms=chain, inputs_digest=_digest(args, kw), **extra)


def _check_traffic(cfg, captured, name, replaces):
    """The tick kernel's agent-traffic branch (K7) against its plain loop on
    captured arguments, run under ``cfg``: bit for bit on every float and
    decision channel, or else within the JAX package's kernel-vs-scan
    traffic bar (:func:`_tick_bar`; NPC indices, lane targets identical,
    lane offsets within 1e-5, NPC positions and velocities within 1e-3),
    which raises when broken."""
    import torch

    from emplanner_carla_tpu_torch.sim import closed_loop as t_cl

    args, kw = captured["run_traffic_ticks_kernel"]
    args = args[:-1] + (cfg,)
    out_k = t_cl.run_traffic_ticks_kernel(*args, **kw)
    out_p = t_cl._traffic_ticks_base(*args, **kw)
    torch.cuda.synchronize()
    floats = [*zip(out_k[0], out_p[0]), (out_k[1], out_p[1]), (out_k[3], out_p[3]),
              *[(getattr(out_k[4], f), getattr(out_p[4], f)) for f in ("x", "y", "vx", "vy")],
              *[(a, b) for a, b in zip(out_k[6], out_p[6]) if a.dtype != torch.bool],
              (out_k[9], out_p[9])]
    err = max(float((a - b).abs().max()) for a, b in floats)
    _tick_bar(name, out_k, out_p)
    for ch, a, b in (("npc index", out_k[8], out_p[8].to(torch.int32)),
                     ("lane target", out_k[10], out_p[10])):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} {ch}: {int((a != b).sum())} of {a.numel()} differ")
    for ch, atol, a, b in (("lane offset", 1e-5, out_k[9], out_p[9]),
                           *[(f"obs.{f}", 1e-3, getattr(out_k[4], f), getattr(out_p[4], f))
                             for f in ("x", "y", "vx", "vy")]):
        e = float((a - b).abs().max())
        if not e <= atol:
            raise AssertionError(f"{name} {ch}: max |diff| {e} > {atol}")
    k7 = lambda: t_cl.run_traffic_ticks_kernel(*args, **kw)  # noqa: E731
    call_ms = _time_ms(k7, 20)
    ms = _device_ms(k7, 20, call_ms)
    chain = _chain_ms(t_cl.run_traffic_ticks_kernel, args, kw)
    plain_ms = _time_ms(lambda: t_cl._traffic_ticks_base(*args, **kw), 2)
    nbytes, flops, extra = _tick_work(cfg, args, kw, out_k, out_p)
    tr, obs = kw["traffic"], args[4]
    B, K = obs.x.shape
    T = cfg.loop.plan_every
    L = 0 if kw.get("lights") is None else kw["lights"].x.shape[1]
    agents = tr.agent_slot & obs.valid
    live = int(agents.sum()) * T
    # the actors each live agent's scans visit: the lane's valid slots but
    # itself, and the ego
    scanned = int((agents.sum(1) * obs.valid.sum(1)).sum()) * T
    # per live agent (lane, tick): five corridor scans (~12 operations per
    # actor visited), the 32-row match (6 a row), ~18 transcendentals (atan2,
    # sin, cos, tan, sqrt; ~20 operations each) and ~60 scalar operations of
    # lane decision, IDM and bicycle, plus ~20 a traffic light; every other
    # slot ~4 a tick of constant-velocity motion and each slot 3 for its
    # lane slew
    flops += 5 * 12.0 * scanned + live * (32 * 6 + 18 * 20 + 60 + 20 * L) \
        + (B * K * T - live) * 4.0 + B * K * T * 3.0
    # the global path, the NPC state and the outputs the traffic adds
    nbytes += _nbytes(*list(tr.global_path)[:3], tr.npc_idx, tr.lane_off, tr.lane_tgt,
                      tr.agent_slot, out_k[4].vx, out_k[4].vy, out_k[8], out_k[9], out_k[10])
    bound, by = _bound_ms(nbytes, flops)
    bit_exact = err == 0.0
    return dict(
        name=name, route="cuda", source="emplanner_carla_tpu_torch/csrc/tick_lqr.cu",
        replaces=replaces, max_abs_err=err, ms=ms, call_ms=call_ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        live_agent_lane_ticks=live, scanned_actor_lane_ticks=scanned, bit_exact=bit_exact,
        chain_ms=chain, inputs_digest=_digest(args, kw), **extra)


def _displaced(captured):
    """Captured tick arguments with each ego moved up to 2.5 m sideways and
    0.4 rad off its heading (a spread over the batch)."""
    import torch

    args, kw = captured["run_ticks_kernel"]
    ego = args[0]
    off = torch.linspace(-2.5, 2.5, ego.x.shape[0], device=ego.x.device)
    ego = ego._replace(x=ego.x - off * torch.sin(ego.phi),
                       y=ego.y + off * torch.cos(ego.phi),
                       phi=ego.phi + 0.4 * torch.sin(7.0 * off))
    return {"run_ticks_kernel": ((ego,) + args[1:], kw)}


def _check_cold_qp(captured, site, atol):
    """The cold QP (K1c) against the plain ladder from the zero state on a
    site's captured arguments: x within rtol 1e-4 / ``atol`` (the site's K1
    bar)."""
    import torch

    from emplanner_carla_tpu_torch.ops import qp as t_qp

    (solver, q, l, u, zero), _ = captured[site]
    x_k = solver(q, l, u)
    x_p = t_qp.warm_ladder_torch(solver, q, l, u, zero)[0]
    torch.cuda.synchronize()
    err = float((x_k - x_p).abs().max())
    if not torch.allclose(x_k, x_p, rtol=1e-4, atol=atol):
        raise AssertionError(f"{site} x: max |diff| {err}")
    k1 = lambda: solver(q, l, u)  # noqa: E731
    call_ms = _time_ms(k1, 20)
    ms = _device_ms(k1, 20, call_ms)
    plain_ms = _time_ms(lambda: t_qp.warm_ladder_torch(solver, q, l, u, zero), 3)
    k = solver.consts(q.device)
    # a cold solve reads (q, l, u) and the constants and writes x alone
    nbytes = _nbytes(q, l, u, k["At"], k["Kinv"], k["rho"], k["D"], k["E"], x_k)
    bound, by, bound_fp32 = _qp_bound(solver, q, nbytes)
    return dict(
        name=site, route="cuda", source="emplanner_carla_tpu_torch/csrc/qp_admm.cu",
        replaces="emplanner_carla_tpu/ops/qp_pallas.py:279", max_abs_err=err, ms=ms,
        call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None, bound_fp32_ms=bound_fp32,
        **_qp_layout(solver, q))


def _speed_dp_work(seg, cfg):
    """The obstacle work this input needs, by the kernel's exact gates (a
    sample outside its segment's ``st_gate_window`` costs exactly 0):
    (live (lane, column, segment) triples of the transitions, interior
    samples inside a live segment's window, endpoint samples inside it,
    start-column samples inside it)."""
    import torch

    from emplanner_carla_tpu_torch.planner import speed_planner as t_sp

    dev = seg.t_in.device
    t0 = cfg.t_step
    ts = (torch.arange(cfg.n_t - 1, dtype=torch.float32, device=dev) + 1.0) * cfg.t_step
    gap = torch.maximum(seg.t_in[:, None, :] - (ts + cfg.t_step)[None, :, None],
                        ts[None, :, None] - seg.t_out[:, None, :])
    live = seg.valid[:, None, :] & (gap < cfg.obs_danger_dist)      # (B, C, K)
    live0 = seg.valid & (torch.maximum(seg.t_in - t0, -seg.t_out) < cfg.obs_danger_dist)
    lo, hi = t_sp.st_gate_window(seg, cfg)                         # (B, K)
    g = t_sp._grid(cfg, str(dev))
    sg, frac = g.s_grid, g.frac

    def inside(s):                          # (B, K) samples of s (n,) in the window
        return (~t_sp.st_sample_skipped(s[None, None, :], lo[..., None],
                                        hi[..., None])).sum(-1)

    s_mid = (sg[:, None] + (sg[None, :] - sg[:, None]) * frac[1:-1, None, None]).reshape(-1)
    n_cols = live.sum(1)                                            # (B, K)
    interior = int((n_cols * inside(s_mid)).sum())
    endpoint = int((2 * n_cols * inside(sg)).sum())
    start = int((live0 * inside((sg[None, :] * frac[:, None]).reshape(-1))).sum())
    return int(live.sum()), interior, endpoint, start


def _check_speed_dp(seg, v0, cfg, label):
    """The speed-DP kernel against its plain version: stations, validity and
    terminal column identical; its device time on the input, on its first
    block alone (one lane) and on the input with every segment invalid."""
    import torch

    from emplanner_carla_tpu_torch.planner import speed_planner as t_sp
    from emplanner_carla_tpu_torch.types import STSegments

    out_k = t_sp.speed_dp_kernel(seg, v0, cfg)
    out_p = t_sp._speed_dp_torch(seg, v0, cfg)
    torch.cuda.synchronize()
    for ch, a, b in (("end_index", out_k.end_index, out_p.end_index.to(torch.int32)),
                     ("valid", out_k.valid, out_p.valid), ("s", out_k.s, out_p.s)):
        if not torch.equal(a, b):
            raise AssertionError(f"speed_dp ({label}) {ch}: {int((a != b).sum())} "
                                 f"of {a.numel()} differ")
    k4 = lambda: t_sp.speed_dp_kernel(seg, v0, cfg)  # noqa: E731
    call_ms = _time_ms(k4, 20)
    ms = _device_ms(k4, 20, call_ms)
    B, K = seg.valid.shape
    n = t_sp.DP_BLOCK_LANES
    seg_1, v0_1 = _first_lanes(seg, B, n), _first_lanes(v0, B, n)
    k4_1 = lambda: t_sp.speed_dp_kernel(seg_1, v0_1, cfg)  # noqa: E731
    chain_ms = _device_ms(k4_1, 20, _time_ms(k4_1, 20))
    dead = STSegments(*seg[:4], torch.zeros_like(seg.valid))
    k4_d = lambda: t_sp.speed_dp_kernel(dead, v0, cfg)  # noqa: E731
    dead_ms = _device_ms(k4_d, 20, _time_ms(k4_d, 20))
    plain_ms = _time_ms(lambda: t_sp._speed_dp_torch(seg, v0, cfg), 2)
    n_s, n_t = cfg.n_s, cfg.n_t
    triples, interior, endpoint, start = _speed_dp_work(seg, cfg)
    # recursion: ~8 operations per edge (acceleration, its cost, the sums,
    # the running minimum); ~25 per obstacle sample inside a live segment's
    # window (interior, endpoint and start-column samples)
    flops = 8.0 * B * (n_t - 1) * n_s * n_s + 25.0 * (interior + endpoint + start)
    g = t_sp._grid(cfg, str(v0.device))
    nbytes = 4 * B * 5 * K + _nbytes(v0, g.s_grid, g.dv, g.ref_tr, g.v0e, g.ref0,
                                     out_k.s, out_k.valid, out_k.end_index)
    bound, by = _bound_ms(nbytes, flops)
    return dict(
        name="speed_dp", route="cuda", source="emplanner_carla_tpu_torch/csrc/speed_dp.cu",
        replaces="emplanner_carla_tpu/ops/speed_dp_pallas.py:61", max_abs_err=0.0,
        ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None, live_triples=triples, window_samples=interior + endpoint + start,
        chain_ms=chain_ms, dead_ms=dead_ms, input=label)


def _bench_config1_segments(batch, device):
    """bench_all.py config 1's fixed set (K = 4, two valid segments), tiled
    to the batch, with its plan-start speed of 10 m/s."""
    import torch

    from emplanner_carla_tpu_torch.types import STSegments

    rows = ([20.0, 35.0, 0, 0], [25.0, 38.0, 0, 0], [2.0, 4.0, 0, 0], [5.0, 6.5, 0, 0])
    f = [torch.tensor(r, dtype=torch.float32, device=device).expand(batch, 4).contiguous()
         for r in rows]
    valid = torch.tensor([True, True, False, False], device=device).expand(batch, 4)
    return STSegments(*f, valid.contiguous()), torch.full((batch,), 10.0, device=device)


def _check_new_inputs(run, cfg, eq, label):
    """K1 at both sites, K2, K4 and the tick kernel against their plain
    versions at their bars on the third plan cycle of a main path that feeds
    them a new input distribution (``run(cfg)`` drives it)."""
    cap = _capture_cycle(run, cfg, n_plans=3)
    (seg, v0, _), _ = cap["speed_dp_kernel"]
    out = [_check_qp(cap, "qp_admm_warm", "emplanner_carla_tpu/ops/qp_pallas.py:41"),
           _check_qp(cap, "qp_admm_speed", "emplanner_carla_tpu/ops/qp_pallas.py:41", eq),
           _check_path_obs(cap),
           _check_speed_dp(seg, v0, cfg.speed, label),
           _check_ticks(cfg, cap, "tick_lqr", "emplanner_carla_tpu/ops/tick_pallas.py:72")]
    for e in out:
        e["input"] = label
    return out


def _route_queries(town, o, d, pad_to):
    """Bench config 6b's query (``bench_all.py:146-149``): device A* and
    backtracking, then stitching, for (origins, destinations) (B,). Returns
    (route, valid, reached, x, y, n_valid, options)."""
    from emplanner_carla_tpu_torch.routing import astar

    route, valid, reached = astar.route_nodes_device(town, o, d)
    return (route, valid, reached, *astar.stitch_route_device(town, route, valid, pad_to))


def _print_entry(e):
    print(f"kernel {e['name']}: max_abs_err {e['max_abs_err']:.3g}, "
          f"kernel {e['ms']:.4f} ms (per call with its wrapper "
          f"{e['call_ms']:.4f} ms), plain {e['plain_ms']:.4f} ms, "
          f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}); "
          + ", ".join(f"{k} {e[k]}" for k in e if k in _EXTRA), flush=True)


def _counters():
    """Each kernel wrapper's launch counter, a dict {kernel name: count}."""
    from emplanner_carla_tpu_torch.ops import qp as t_qp
    from emplanner_carla_tpu_torch.planner import path_dp as t_dp
    from emplanner_carla_tpu_torch.planner import speed_planner as t_sp
    from emplanner_carla_tpu_torch.sim import closed_loop as t_cl

    return (t_qp.launches, t_dp.launches, t_cl.launches, t_sp.launches)


def _reset_counts():
    for d in _counters():
        for k in d:
            d[k] = 0


def _read_counts():
    return {k: v for d in _counters() for k, v in d.items()}


def _drive(label, run, expected: dict, reps: int):
    """Run a main path ``reps`` times, each with the launch counters taken
    from zero just before it and read just after; every count must be the
    expected one, and a call of a plain tick loop raises. Returns (last
    output, walls, counts)."""
    import torch

    from emplanner_carla_tpu_torch.sim import closed_loop as t_cl

    def refuse(*_a, **_k):
        raise AssertionError(f"{label}: the plain tick loop ran on the card's path")

    plain = {n: getattr(t_cl, n) for n in ("_full_ticks_base", "_traffic_ticks_base")}
    walls = []
    try:
        for n in plain:
            setattr(t_cl, n, refuse)
        for _ in range(reps):
            _reset_counts()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = _read_counts()
            if counts != expected:
                raise AssertionError(f"{label}: launches {counts}, expected {expected}")
    finally:
        for n, fn in plain.items():
            setattr(t_cl, n, fn)
    return out, walls, counts


def _summary(metrics, closed_loop, batch):
    import torch

    for name, a in zip(metrics._fields, metrics):
        if a.dtype.is_floating_point and not bool(torch.isfinite(a).all()):
            raise AssertionError(f"metric {name} has non-finite values")
    summ = {k: float(v) for k, v in closed_loop.summarize(metrics).items()}
    summ["collisions"] = int(metrics.collided.reshape(batch, -1).any(1).sum())
    return summ


def _assert_metrics_match(m_a, m_b, label):
    import torch

    for name, a, b in zip(type(m_a)._fields, m_a, m_b):
        a, b = a.cpu(), b.cpu()
        if a.dtype in (torch.bool, torch.int32, torch.int64):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}.{name}: {int((a != b).sum())} of "
                                     f"{a.numel()} differ")
        elif not torch.allclose(a, b, rtol=1e-5, atol=5e-3):
            raise AssertionError(f"{label}.{name}: max |diff| "
                                 f"{float((a - b).abs().max())}")


def _config1_run(seg, v0, cfg):
    """Bench config 1 (``bench_all.py:52-78``), batch-first: the speed DP,
    the convex space on its 60-point straight path and the cold speed QP.
    Returns the QP's stations s (B, n_t + 1)."""
    import torch

    from emplanner_carla_tpu_torch.planner import speed_planner

    B, dev = v0.shape[0], v0.device
    dp = speed_planner.speed_dp(seg, v0, cfg.speed)
    path_s = torch.linspace(0.0, 120.0, 60, device=dev).expand(B, 60)
    bounds = speed_planner.convex_space(dp, seg, path_s,
                                        torch.full((B, 60), 1e-3, device=dev), cfg.speed)
    return speed_planner.speed_qp(v0, torch.zeros_like(v0), *bounds, cfg.speed)[0]


def _config2_run(sc, cfg):
    """Bench config 2 (``bench_all.py:80-88``): the open-loop path plan from
    match index 0 with a cold path QP."""
    import torch

    from emplanner_carla_tpu_torch.planner import em_planner

    mi = torch.zeros(sc.ego0.x.shape[0], dtype=torch.int32, device=sc.ego0.x.device)
    return em_planner.plan_path_cycle(sc.global_path, sc.ego0, sc.obstacles, mi, cfg)


def _host_aggregates(tk):
    """The six fleet aggregates of TickMetrics (B, n_plans, plan_every),
    reduced on the host in float64."""
    import torch

    f64 = lambda a: a.detach().cpu().to(torch.float64)  # noqa: E731
    lat, B = f64(tk.lateral_err), tk.lateral_err.shape[0]
    return {
        "lateral_rmse": float(torch.sqrt((lat * lat).mean())),
        "mean_speed_kmh": float(f64(tk.speed_kmh).mean()),
        "collisions": float(tk.collided.reshape(B, -1).any(1).sum()),
        "n_scenarios": float(B),
        "infeasible_cycles": float((~tk.feasible[..., 0]).sum()),
        "segments_dropped": float(tk.segments_dropped[..., 0].sum()),
    }


def _assert_trees_equal(a, b, label, device=None):
    """Every tensor of two trees equal (and on ``device``, when given)."""
    import torch

    from emplanner_carla_tpu_torch.types import tree_leaves, tree_map

    # the skeleton's repr names every NamedTuple type and field
    skeleton = lambda t: repr(tree_map(t, lambda _: 0))  # noqa: E731
    pairs = list(zip(tree_leaves(a), tree_leaves(b)))
    if skeleton(a) != skeleton(b) or not pairs:
        raise AssertionError(f"{label}: the trees differ in structure")
    for i, (x, y) in enumerate(pairs):
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"{label}: tensor {i} differs")
        if device is not None and x.device != device:
            raise AssertionError(f"{label}: tensor {i} on {x.device}, not {device}")
    return len(pairs)


def _fleet_phase(cfg, sc, sc8, m5, zero, per_path, card):
    """The fleet and the utilities on the card: ``fleet_simulate`` over a
    one-rank NCCL group at config 5 (five timed runs; metrics identical to
    ``simulate_full``'s, aggregates equal to a float64 host reduction), its
    traffic, pixel and path modes once each; checkpoint round trips and a
    resume; the run report, the camera keyframes, ``sync`` /
    ``stage_timer`` and a ``trace`` of one cycle."""
    import glob
    import tempfile

    import torch

    from emplanner_carla_tpu_torch.parallel import fleet
    from emplanner_carla_tpu_torch.utils import checkpoint, profiling, report

    t_phase = time.perf_counter()
    mesh = fleet.make_mesh()
    if (mesh.backend, mesh.world, mesh.device.type) != ("nccl", 1, "cuda"):
        raise AssertionError(f"fleet mesh {mesh}: expected one NCCL rank on the card")
    print(f"fleet mesh: backend {mesh.backend}, world size {mesh.world}, rank "
          f"{mesh.rank}, device {mesh.device} ({torch.cuda.get_device_name(mesh.device)})",
          flush=True)
    n = cfg.loop.n_plans
    full = ("qp_admm_warm", "qp_admm_speed", "path_obs_costs", "speed_dp")
    local = fleet.shard_scenarios(sc, mesh)
    fleet.fleet_simulate(local, _with_plans(cfg, 2), mesh, full=True)   # warm-up
    torch.cuda.synchronize()
    label = "fleet_simulate config 5"
    (m, agg, carry5), walls, counts = _drive(
        label, lambda: fleet.fleet_simulate(local, cfg, mesh, full=True, return_carry=True),
        {**zero, **{k: n for k in full + ("tick_lqr",)}}, 5)
    identical = all(torch.equal(a, b) for a, b in zip(m, m5))
    if not identical:
        _assert_metrics_match(m, m5, f"{label} vs simulate_full config 5")
    agg = {k: float(v) for k, v in agg.items()}
    host = _host_aggregates(m)
    for k, v in host.items():
        exact = k not in ("lateral_rmse", "mean_speed_kmh")
        if (agg[k] != v) if exact else abs(agg[k] - v) > 1e-5 * abs(v):
            raise AssertionError(f"{label} {k}: all-reduce {agg[k]}, host {v}")
    wall = sorted(walls)[len(walls) // 2]
    per_path[label] = dict(wall_s=wall, walls_s=walls, cycles_per_s=BATCH * n / wall,
                           ms_per_cycle=wall / n * 1e3, counts=counts,
                           identical_to_simulate_full=identical, **agg)
    print(f"{label}: batch {BATCH} x {n} plans x {cfg.loop.plan_every} ticks over one "
          f"NCCL rank in {wall:.3f} s (median of {', '.join(f'{w:.3f}' for w in walls)} "
          f"s) = {BATCH * n / wall:.1f} cycles/s on [{card}]; aggregates "
          + ", ".join(f"{k} {v:.6g}" for k, v in agg.items())
          + f" (float64 host reduction: rtol 1e-5, counts exact); per-scenario metrics "
          f"{'identical to' if identical else 'within the loop bar of'} simulate_full "
          f"config 5; launches {counts}", flush=True)

    c2 = _with_plans(cfg, 2)
    carries = {}
    for label, kw, scen, kernels in (
        ("fleet_simulate config 7 (traffic, full EM)", dict(traffic=True, full=True),
         sc, full + ("tick_traffic",)),
        ("fleet_simulate config 8 (pixels, full EM)", dict(pixels=True, full=True),
         sc8, full + ("tick_lqr",)),
        ("fleet_simulate path-only", {}, sc,
         ("qp_admm_warm", "path_obs_costs", "tick_lqr")),
    ):
        loc = fleet.shard_scenarios(scen, mesh)
        (_, ag, carries[label]), walls, counts = _drive(
            label, lambda: fleet.fleet_simulate(loc, c2, mesh, return_carry=True, **kw),
            {**zero, **{k: 2 for k in kernels}}, 1)
        ag = {k: float(v) for k, v in ag.items()}
        if ag["n_scenarios"] != BATCH or not all(map(math.isfinite, ag.values())):
            raise AssertionError(f"{label}: aggregates {ag}")
        print(f"{label}: batch {BATCH} x 2 plans in {walls[0]:.3f} s on [{card}]; "
              + ", ".join(f"{k} {v:.6g}" for k, v in ag.items())
              + f"; launches {counts}", flush=True)

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        carry7 = carries["fleet_simulate config 7 (traffic, full EM)"]
        t0 = time.perf_counter()
        checkpoint.save(os.path.join(tmp, "c5"), carry5)
        n5 = _assert_trees_equal(checkpoint.restore(os.path.join(tmp, "c5"), carry5),
                                 carry5, "checkpoint config 5 LoopCarry", mesh.device)
        checkpoint.save(os.path.join(tmp, "c7"), carry7)
        r7 = checkpoint.restore(os.path.join(tmp, "c7"), carry7)
        n7 = _assert_trees_equal(r7, carry7, "checkpoint config 7 TrafficCarry", mesh.device)
        ck_s = time.perf_counter() - t0
        res = [checkpoint.resume_simulation(local.global_path, c, c2, n_plans=2, full=True,
                                            behavior="normal") for c in (carry7, r7)]
        nr = _assert_trees_equal(res[1], res[0], "resume of the restored TrafficCarry")
        print(f"checkpoint: config 5 LoopCarry ({n5} tensors) and config 7 TrafficCarry "
              f"({n7} tensors) of {BATCH} lanes saved and restored bit for bit on "
              f"{mesh.device} in {ck_s:.3f} s; resume_simulation of the restored "
              f"TrafficCarry (2 plans, full EM) identical to the in-memory resume "
              f"({nr} tensors)", flush=True)

        lane0 = type(m)(*[f[0] for f in m])
        sc0 = _first_lanes(local, BATCH, 1)
        rep = report.run_report(lane0, cfg)
        print("run_report, lane 0 of fleet_simulate config 5: " + json.dumps(rep), flush=True)
        frames = report.camera_keyframes(lane0, sc0, cfg, every=100)
        n_frames = -(-n * cfg.loop.plan_every // 100)
        # uint8 pixels are finite by type: the check is that the frames exist
        # on the card at their shape and are not blank
        if frames.device.type != "cuda" or frames.dtype != torch.uint8 \
                or tuple(frames.shape) != (n_frames, 64, 96, 3) or int(frames.max()) == 0:
            raise AssertionError(f"camera keyframes {tuple(frames.shape)} {frames.dtype}")
        print(f"camera_keyframes, lane 0 every 100 ticks: {tuple(frames.shape)} "
              f"{frames.dtype} on {frames.device}, not blank", flush=True)

        c1 = _with_plans(cfg, 1)
        times = {}
        with profiling.stage_timer("config 5 cycle", times):
            out = fleet.fleet_simulate(local, c1, mesh, full=True)
            checksum = profiling.sync(out)
        print(f"sync / stage_timer: one config 5 cycle (batch {BATCH}) "
              f"{times['config 5 cycle'] * 1e3:.3f} ms to the fetched checksum "
              f"{checksum:.6g} on [{card}]", flush=True)
        with profiling.trace(os.path.join(tmp, "trace")) as logdir:
            with profiling.annotate("fleet config 5 cycle"):
                profiling.sync(fleet.fleet_simulate(local, c1, mesh, full=True))
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        if len(files) != 1:
            raise AssertionError(f"trace: {len(files)} trace files in {logdir}")
        with open(files[0]) as fh:
            events = json.load(fh)["traceEvents"]
        kern = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        found = {k: sum(k in name for name in kern) for k in
                 ("qp_admm_kernel", "path_obs_kernel", "speed_dp_kernel", "tick_kernel")}
        regions = sum(e.get("name") == "fleet config 5 cycle" for e in events)
        if min(found.values()) == 0 or regions == 0:
            raise AssertionError(f"trace: kernel events {found}, annotate regions {regions}")
        print(f"trace of one config 5 cycle: {len(events)} events, {len(kern)} device "
              f"kernels; hand-written kernel events {found}; annotate region "
              f"'fleet config 5 cycle' x{regions}", flush=True)
    torch.distributed.destroy_process_group()
    print(f"fleet phase wall: {time.perf_counter() - t_phase:.1f} s on [{card}]", flush=True)


# ---- the edge phase: the JAX package's own edge-case scenarios, rebuilt
# from NumPy (tests/test_torch_edge_builders.py holds every builder array for
# array against the JAX tests' builders) ----

# the containment runs' loop (tests/test_feasibility.py:48-52): 8 plans and
# a 12 m lateral gate, so that the whole wall is perceived
CONTAINMENT_PLANS = 8
CONTAINMENT_GATE = 12.0
WALL_S = 25.0
# the wall's lateral offsets, one a static slot: jnp.linspace(-8.75, 8.75, 8)
# in float32 (tests/test_feasibility.py:37), whose rounding NumPy's does not
# reproduce
WALL_L = (-8.75, -6.25, -3.75, -1.2499995231628418, 1.250000238418579,
          3.750000238418579, 6.250000476837158, 8.75)
# the planted lanes of the batch and what each holds: they share the tick
# kernel's 32-lane blocks and warps and the QP kernel's 32-lane tiles with
# healthy lanes (tests/test_feasibility.py:55 the wall, :106 the wall with
# NaN obstacle slots, :140 a NaN ego speed)
PLANTED = {1: "nan_vx", 2: "wall", 3: "nan_wall", 33: "wall", 2048: "nan_vx",
           4095: "nan_wall"}
# jax.random.uniform's unit floats behind make_scenario(PRNGKey(5), ...)
# (tests/test_closed_loop.py:73): amp, pos, width (6 each), s, l (12 each),
# dyn, walk
EMERGENCY_DRAWS = (
    (0.616879940032959, 0.000664830207824707, 0.037978172302246094,
     0.1442934274673462, 0.16922831535339355, 0.43109130859375),
    (0.08242499828338623, 0.5812526941299438, 0.86997389793396,
     0.23379647731781006, 0.8386893272399902, 0.06594061851501465),
    (0.09706974029541016, 0.6954555511474609, 0.3855257034301758,
     0.21448659896850586, 0.17406606674194336, 0.9158449172973633),
    (0.08381330966949463, 0.22921323776245117, 0.11234712600708008,
     0.2685335874557495, 0.12162470817565918, 0.4554823637008667,
     0.5360288619995117, 0.47860443592071533, 0.1630462408065796,
     0.07066178321838379, 0.015344500541687012, 0.5327630043029785),
    (0.9563421010971069, 0.7585760354995728, 0.20780706405639648,
     0.5824768543243408, 0.6477830410003662, 0.4720571041107178,
     0.7611249685287476, 0.7450920343399048, 0.8192826509475708,
     0.8155168294906616, 0.5589034557342529, 0.7092293500900269),
    (0.11213433742523193,),
    (0.13088715076446533,),
)
# name: (the JAX test, plan cycles (tick loops for the stopped ego), entry)
EDGE_CASES = {
    "yield_infeasible": ("tests/test_fidelity.py:589", 5, "simulate_full"),
    "red_light_stop": ("tests/test_fidelity.py:720", 10, "simulate"),
    "walker_yield": ("tests/test_fidelity.py:773", 5, "simulate_full"),
    "npc_lane_change": ("tests/test_fidelity.py:828", 3, "simulate_traffic"),
    "stopped_behind_lead": ("tests/test_closed_loop.py:89", 3, "ticks"),
    "emergency_brake": ("tests/test_closed_loop.py:73", 30, "simulate"),
}


def _straight(n: int):
    """A straight road of n nodes 2 m apart along x: (x, y, theta, kappa)."""
    import numpy as np

    z = np.zeros(n, np.float32)
    return np.arange(n, dtype=np.float32) * np.float32(2.0), z, z.copy(), z.copy()


def _layout(cfg, path, v0: float, slots: dict, ego_xy=None):
    """A one-lane port Scenario on the CPU: ``path`` (x, y, theta, kappa),
    the ego at the path start (or at ``ego_xy``) with heading theta[0] and
    speed v0, obstacle slot k at (x, y, vx, vy) = slots[k] and valid, the
    other slots zero and invalid."""
    import numpy as np
    import torch

    from emplanner_carla_tpu_torch.sim.scenario import Scenario
    from emplanner_carla_tpu_torch.types import EgoState, Obstacles, Path

    K = cfg.n_static_obs + cfg.n_dynamic_obs
    ob = np.zeros((4, K), np.float32)
    valid = np.zeros(K, bool)
    for k, v in slots.items():
        ob[:, k] = v
        valid[k] = True
    x0, y0 = (path[0][0], path[1][0]) if ego_xy is None else ego_xy
    ego = np.array([x0, y0, path[2][0], v0, 0, 0, 0, 0, 0], np.float32)
    one = lambda a: torch.as_tensor(np.array(a))[None]  # noqa: E731
    return Scenario(Path(*[one(a) for a in path]), EgoState(*[one(a) for a in ego]),
                    Obstacles(*[one(a) for a in ob], one(valid)))


def wall_scenario(cfg, n: int = 160, nan_slots: bool = False):
    """tests/test_feasibility.py:26 ``_wall_scenario``: a straight road and
    the static slots as a wall at x = 25 across every DP row, the ego at 8
    m/s; with ``nan_slots`` slot 0's x and slot 1's y NaN (:106)."""
    if cfg.n_static_obs != len(WALL_L):
        raise ValueError(f"the wall has {len(WALL_L)} slots, the config "
                         f"{cfg.n_static_obs} static ones")
    slots = {k: (WALL_S, WALL_L[k], 0.0, 0.0) for k in range(cfg.n_static_obs)}
    sc = _layout(cfg, _straight(n), 8.0, slots)
    if nan_slots:
        sc.obstacles.x[0, 0] = float("nan")
        sc.obstacles.y[0, 1] = float("nan")
    return sc


def edge_scenario(name: str, cfg):
    """The one-lane scenario of EDGE_CASES[name] on the CPU, and its extra
    inputs: the traffic lights of the red-light stop."""
    import numpy as np
    import torch

    from emplanner_carla_tpu_torch.sim import scenario
    from emplanner_carla_tpu_torch.sim.traffic_light import TrafficLights

    d0 = cfg.n_static_obs
    if name == "yield_infeasible":      # tests/test_fidelity.py:541
        return _layout(cfg, _straight(200), 18.0, {d0: (26.0, -21.0, 0.0, 19.0)}), {}
    if name == "red_light_stop":        # red on [0, 5) s, green on [5, 10), ...
        lights = TrafficLights(*[torch.tensor([v]) for v in (
            [40.0, 0.0], [0.0, 0.0], [10.0, 1.0], [5.0, 0.0], [0.5, 1.0])],
            torch.tensor([[True, False]]))
        return _layout(cfg, _straight(200), 10.0, {}), {"lights": lights}
    if name == "walker_yield":
        return _layout(cfg, _straight(200), 10.0, {d0: (18.0, -3.4, 0.0, 1.4)}), {}
    if name == "npc_lane_change":       # a parked car, the agent NPC behind it
        return _layout(cfg, _straight(200), 5.0, {0: (60.0, 0.0, 0.0, 0.0),
                                                   d0: (20.0, 0.0, 8.0, 0.0)}), {}
    if name == "stopped_behind_lead":   # at rest 5 m behind a stopped car
        return _layout(cfg, _straight(64), 0.0, {0: (30.0, 0.0, 0.0, 0.0)},
                       ego_xy=(25.0, 0.0)), {}
    if name == "emergency_brake":       # a 100-node random road, nothing on it
        u = scenario.ScenarioUniforms(*[torch.tensor(np.array(d, np.float32))[None]
                                        for d in EMERGENCY_DRAWS[:5]],
                                      *[torch.tensor(d, dtype=torch.float32)
                                        for d in EMERGENCY_DRAWS[5:]])
        return scenario.make_scenario_from_uniforms(
            u, cfg, n_path=100, n_active_static=0, with_dynamic=False), {}
    raise KeyError(name)


def edge_cfg(name: str, cfg):
    """The config EDGE_CASES[name] runs under: ``cfg`` with its plan count
    (the stopped ego runs ``cfg`` as it is)."""
    _, n, entry = EDGE_CASES[name]
    return cfg if entry == "ticks" else _with_plans(cfg, n)


def edge_run(name: str, sc, extra: dict, cfg, device):
    """Run EDGE_CASES[name] on ``sc`` (any batch) on ``device`` through the
    port's entry point: (carry, TickMetrics of (B, n_plans, plan_every));
    the stopped ego's three tick loops (``closed_loop.run_ticks``: the
    kernel on the card) give (EgoState, TickMetrics of the last loop)."""
    import torch

    from emplanner_carla_tpu_torch.sim import closed_loop
    from emplanner_carla_tpu_torch.types import tree_to

    c = edge_cfg(name, cfg)
    entry = EDGE_CASES[name][2]
    if entry == "simulate":
        return closed_loop.simulate(*sc, c, lights=extra.get("lights"), device=device)
    if entry == "simulate_full":
        return closed_loop.simulate_full(*sc, c, device=device)
    if entry == "simulate_traffic":
        return closed_loop.simulate_traffic(*sc, c, behavior="normal", device=device)
    gp, ego, obs = tree_to(sc, device)
    B, nd = ego.x.shape[0], c.speed.n_dense
    f32 = dict(dtype=torch.float32, device=device)
    ttime = torch.arange(nd, **f32) * (c.speed.n_t * c.speed.t_step / (nd - 1))
    tspeed = torch.full((B, nd), c.loop.target_speed_kmh / 3.6, **f32)
    buf = torch.zeros((B, c.control.pid_buffer), **f32)
    cnt = torch.zeros(B, dtype=torch.int32, device=device)
    last = torch.zeros(B, **f32)
    arrived = torch.zeros(B, dtype=torch.bool, device=device)
    tru = torch.ones(B, dtype=torch.bool, device=device)
    dest_x, dest_y = gp.x[:, -1].contiguous(), gp.y[:, -1].contiguous()
    for _ in range(EDGE_CASES[name][1]):
        ego, buf, cnt, last, obs, arrived, m = closed_loop.run_ticks(
            ego, buf, cnt, last, obs, tspeed, ttime, gp, arrived, tru, tru, dest_x,
            dest_y, c)[:7]
    return ego, closed_loop.TickMetrics(*m, torch.zeros_like(cnt)[:, None].expand_as(m[0]))


def yield_cycle0(sc, cfg):
    """Cycle 0's speed stage of the yield-infeasible scenario, recomputed
    with the port's pieces as tests/test_fidelity.py:604-649 does with the
    JAX package's, on the tensors' device: (valid ST segments, s_ub and
    s_lb (B, n_t), plan-start speed and acceleration (B,), the cold speed
    QP's accelerations (B, n_t + 1))."""
    import torch

    from emplanner_carla_tpu_torch.ops import frenet
    from emplanner_carla_tpu_torch.planner import em_planner, speed_planner, trajectory
    from emplanner_carla_tpu_torch.sim import perception

    gp, ego, obs = sc
    sp, d0 = cfg.speed, cfg.n_static_obs
    target = em_planner.plan_path_cycle(gp, ego, obs, frenet.nearest_index(ego.x, ego.y, gp),
                                        cfg).target
    vx_w, vy_w = ego.v_world
    s_dot0, s_ddot0 = speed_planner.speed_plan_start(vx_w, vy_w, ego.ax, ego.ay,
                                                     target.theta[:, 0])
    s_dot0 = torch.clamp(s_dot0, min=0.0)
    path_arc = trajectory.path_arc_length(target)
    dyn_mask = perception.perceive(ego, obs, cfg.loop)[1]
    seg = speed_planner.st_graph(*frenet.dynamic_obs_frenet(
        obs.x[:, d0:], obs.y[:, d0:], obs.vx[:, d0:], obs.vy[:, d0:], target, path_arc),
        dyn_mask[:, d0:], sp)
    dp = speed_planner.speed_dp(seg, s_dot0, sp)
    s_lb, s_ub, sd_lb, sd_ub = speed_planner.convex_space(dp, seg, path_arc, target.kappa, sp)
    qa = speed_planner.speed_qp(s_dot0, s_ddot0, s_lb, s_ub, sd_lb, sd_ub, sp)[2]
    return seg.valid.sum(1), s_ub, s_lb, s_dot0, s_ddot0, qa


def assert_yield_relaxation(cycle0, cfg, lane: int = 0):
    """tests/test_fidelity.py:629-649 on one lane of :func:`yield_cycle0`:
    one ST segment; a yield (finite upper cap, zero lower bound); the cap
    more than 1 m below the float64 max-braking envelope (the relaxation
    active); the relaxed QP brakes at accel_min."""
    n_seg, s_ub, s_lb, s_dot0, s_ddot0, qa = (a[lane].detach().cpu() for a in cycle0)
    sp = cfg.speed
    if int(n_seg) != 1:
        raise AssertionError(f"yield-infeasible: {int(n_seg)} ST segments, not 1")
    if not (float(s_ub.min()) < 1e7 and float(s_lb.max()) == 0.0):
        raise AssertionError("yield-infeasible: the DP did not choose the yield")
    v, a, se, env = float(s_dot0), float(s_ddot0), 0.0, []
    for _ in range(sp.n_t):
        an = max(sp.accel_min, -2.0 * v / sp.t_step - a)
        vn = max(v + sp.t_step * 0.5 * (a + an), 0.0)
        se = se + sp.t_step * v + sp.t_step ** 2 / 3.0 * a + sp.t_step ** 2 / 6.0 * an
        env.append(se)
        v, a = vn, an
    gap = min(float(u) - e for u, e in zip(s_ub.tolist(), env))
    if not gap < -1.0:
        raise AssertionError(f"yield-infeasible: relaxation not active, gap {gap:.3f} m")
    if not float(qa.min()) <= sp.accel_min + 0.1:
        raise AssertionError(f"yield-infeasible: least planned accel {float(qa.min()):.3f}")


def assert_edge(name: str, out, cfg, lane: int = 0):
    """The JAX test's own assertions on one lane of :func:`edge_run`'s
    output (the float64 oracle's bars stay in the CPU tests)."""
    import numpy as np

    carry, m = out
    a = lambda t: t[lane].detach().cpu().numpy()  # noqa: E731
    x, y, spd = a(m.x).reshape(-1), a(m.y).reshape(-1), a(m.speed_kmh).reshape(-1)
    collided = bool(a(m.collided).any())
    t = (np.arange(x.size) + 1.0) * cfg.plant.dt
    if name == "stopped_behind_lead":
        checks = {"held at x = 25": abs(float(a(carry.x)) - 25.0) <= 1e-2,
                  "at rest": float(a(carry.vx)) < 0.05}
    elif name == "yield_infeasible":
        checks = {"hard brake": float(spd[:150].min()) < 45.0}
    elif name == "red_light_stop":
        checks = {"held for the red": float(spd[450:500].max()) < 5.0,
                  "short of the line": float(x[:500].max()) < 38.0,
                  "proceeded on green": float(x[-1]) > 55.0}
    elif name == "walker_yield":
        checks = {"yielded": float(spd.min()) < 26.0,
                  "swerved": float(np.abs(y).max()) > 2.0,
                  "clear of the walker": float(np.hypot(x - 18.0, y - (-3.4 + 1.4 * t)).min())
                  > 2.0}
    elif name == "npc_lane_change":
        d0 = cfg.n_static_obs
        checks = {"committed left": abs(float(a(carry.npc_lane.target)[d0]) - 3.5) <= 3.5e-6,
                  "slewed over": float(a(carry.npc_lane.offset)[d0]) > 3.0}
    elif name == "emergency_brake":
        checks = {"arrived": bool(a(m.arrived).any()),
                  "stopped": float(a(m.speed_kmh)[-1, -1]) < 5.0}
    else:
        raise KeyError(name)
    checks["no collision"] = not collided
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{name} ({EDGE_CASES[name][0]}): {', '.join(failed)}")


def plant_lanes(sc, cfg):
    """The batch ``sc`` (on any device) with :data:`PLANTED`'s lanes
    replaced: a NaN ego speed in the lane's own scenario; the wall, or the
    wall with NaN obstacle slots, on a straight road of the batch's path
    length in place of the lane's scenario."""
    from emplanner_carla_tpu_torch.types import tree_leaves, tree_map

    n = sc.global_path.x.shape[1]
    out = tree_map(sc, lambda t: t.clone())
    for lane, kind in PLANTED.items():
        if kind == "nan_vx":
            out.ego0.vx[lane] = float("nan")
            continue
        w = wall_scenario(cfg, n, nan_slots=kind == "nan_wall")
        for dst, src in zip(tree_leaves(out), tree_leaves(w)):
            dst[lane] = src[0].to(dst.device)
    return out


def assert_planted(kind: str, entry: str, carry, m, lane: int, cfg):
    """tests/test_feasibility.py's assertions on one planted lane. The wall
    (:55): infeasible in some cycle, feasibility constant within a cycle,
    no collision, below 5 km/h at the end and short of the wall by the
    collision radius. NaN obstacle slots (:106): every metric and the ego's
    x finite, the surviving wall slots cleared by more than the collision
    radius, and through the gap: past x = 40 in ``simulate``, where the JAX
    test measures it, past the wall elsewhere (the JAX package's own full-EM
    loops end this scenario's 8 plans at x = 39.31). A NaN ego speed (:140):
    infeasible in every cycle."""
    import numpy as np
    import torch

    from emplanner_carla_tpu_torch.sim.loop_constants import COLLISION_RADIUS

    a = lambda t: t[lane].detach().cpu()  # noqa: E731
    feas = a(m.feasible)
    if kind == "nan_vx":
        ok = {"infeasible in every cycle": not bool(feas.any())}
    elif kind == "wall":
        ok = {"infeasible in some cycle": not bool(feas.all()),
              "constant within a cycle": bool((feas == feas[:, :1]).all()),
              "no collision": not bool(a(m.collided).any()),
              "stopped": float(a(m.speed_kmh)[-1, -1]) < 5.0,
              "short of the wall": float(a(m.x)[-1, -1]) < WALL_S - COLLISION_RADIUS}
    else:
        xs, ys = a(m.x).reshape(-1).double().numpy(), a(m.y).reshape(-1).double().numpy()
        wall_l = np.linspace(-8.75, 8.75, cfg.n_static_obs)
        d_surv = min(float(np.hypot(xs - WALL_S, ys - wall_l[k]).min())
                     for k in range(2, cfg.n_static_obs))
        past = 40.0 if entry == "simulate" else WALL_S + COLLISION_RADIUS
        ego = carry.loop.ego if hasattr(carry, "loop") else carry.ego
        ok = {"finite metrics": all(bool(torch.isfinite(a(t).float()).all()) for t in m),
              "finite ego": bool(torch.isfinite(a(ego.x))),
              "survivors cleared": d_surv > COLLISION_RADIUS,
              f"past x = {past}": float(xs[-1]) > past}
    failed = [k for k, v in ok.items() if not v]
    if failed:
        raise AssertionError(f"planted {kind} in lane {lane} ({entry}): {', '.join(failed)}")


def _assert_close_nan(a, b, label):
    """Every tensor of tree ``a`` (the card's) against tree ``b`` (the CPU's)
    at the loop's bar: bool and int tensors identical, float tensors with
    NaN at the same places and the rest within rtol 1e-5 / atol 5 mm."""
    import torch

    from emplanner_carla_tpu_torch.types import tree_leaves

    pairs = list(zip(tree_leaves(a), tree_leaves(b)))
    if not pairs:
        raise AssertionError(f"{label}: nothing to compare")
    for i, (x, y) in enumerate(pairs):
        x = x.cpu()
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{label}: tensor {i} {x.dtype} {tuple(x.shape)} against "
                                 f"{y.dtype} {tuple(y.shape)}")
        if not x.dtype.is_floating_point:
            if not torch.equal(x, y):
                raise AssertionError(f"{label}: tensor {i}: {int((x != y).sum())} differ")
            continue
        nx = torch.isnan(x)
        if not torch.equal(nx, torch.isnan(y)):
            raise AssertionError(f"{label}: tensor {i}: NaN at other places")
        if not torch.allclose(x[~nx], y[~nx], rtol=1e-5, atol=5e-3):
            raise AssertionError(f"{label}: tensor {i}: max |diff| "
                                 f"{float((x[~nx] - y[~nx]).abs().max())}")


def _ego_of(out):
    """The ego state of an entry point's carry (or of the tick loops')."""
    carry = out[0]
    carry = carry.loop if hasattr(carry, "loop") else carry
    return carry.ego if hasattr(carry, "ego") else carry


def _edge_phase(cfg, sc, zero, card):
    """The edge phase. Planted lanes: ``simulate`` (config 3),
    ``simulate_full`` (config 5) and ``simulate_traffic(full=True)`` (config
    7) under the containment loop, each on the batch with PLANTED's lanes
    and on the clean batch: the healthy lanes' metrics and carry bit for bit
    the clean run's; the planted lanes meet tests/test_feasibility.py's
    assertions and equal the same lanes run on the CPU (three at a time,
    the plain versions) at the loop's bar, NaN at the same places. Then each
    of EDGE_CASES broadcast to the batch: every lane equal to lane 0 bit for
    bit, lane 0 equal to the CPU run at the loop's bar and meeting the JAX
    test's assertions; for the yield-infeasible case also its cycle-0 speed
    stage (cold path QP, path-DP costs, speed DP, cold speed QP)."""
    import torch

    from emplanner_carla_tpu_torch.sim import closed_loop
    from emplanner_carla_tpu_torch.types import tree_leaves, tree_map

    t_phase = time.perf_counter()
    rep = dataclasses.replace
    ccfg = rep(cfg, loop=rep(cfg.loop, n_plans=CONTAINMENT_PLANS,
                             lateral_gate=CONTAINMENT_GATE))
    planted = plant_lanes(sc, ccfg)
    lanes = sorted(PLANTED)
    healthy = torch.ones(BATCH, dtype=torch.bool, device="cuda")
    healthy[lanes] = False
    full = ("qp_admm_warm", "qp_admm_speed", "path_obs_costs", "speed_dp")
    for label, entry, kernels in (
        ("simulate config 3", "simulate", ("qp_admm_warm", "path_obs_costs", "tick_lqr")),
        ("simulate_full config 5", "simulate_full", full + ("tick_lqr",)),
        ("simulate_traffic config 7", "simulate_traffic", full + ("tick_traffic",)),
    ):
        fn = getattr(closed_loop, entry)
        kw = dict(behavior="normal", full=True) if entry == "simulate_traffic" else {}
        run = lambda s, dev: fn(*s, ccfg, device=dev, **kw)  # noqa: E731
        expected = {**zero, **{k: CONTAINMENT_PLANS for k in kernels}}
        clean, _, _ = _drive(f"{label}, clean", lambda: run(sc, "cuda"), expected, 1)
        out, walls, _ = _drive(f"{label}, planted", lambda: run(planted, "cuda"), expected, 1)
        leaves = list(zip(tree_leaves(out), tree_leaves(clean)))
        for i, (x, y) in enumerate(leaves):
            if x.shape[0] != BATCH or not torch.equal(x[healthy], y[healthy]):
                raise AssertionError(f"{label}: tensor {i} of a healthy lane differs from "
                                     "the clean run")
        carry, m = out
        for lane in lanes:
            assert_planted(PLANTED[lane], entry, carry, m, lane, ccfg)
        if not bool(torch.isfinite(m.lateral_err[healthy]).all()):
            raise AssertionError(f"{label}: a healthy lane's lateral error is not finite")
        for part in (lanes[:3], lanes[3:]):
            out_cpu = run(tree_map(planted, lambda t: t[part].cpu()), "cpu")
            idx = torch.tensor(part, device="cuda")
            pick = lambda t: t[idx]  # noqa: E731
            _assert_close_nan(tree_map(m, pick), out_cpu[1], f"{label} lanes {part}")
            _assert_close_nan(tree_map(_ego_of(out), pick), _ego_of(out_cpu),
                              f"{label} lanes {part} ego")
        print(f"edge phase, planted lanes in {label}: batch {BATCH} x {CONTAINMENT_PLANS} "
              f"plans, lanes {PLANTED}: the healthy lanes' {len(leaves)} metric and carry "
              "tensors bit for bit the clean run's; the planted lanes meet "
              "tests/test_feasibility.py's assertions and equal the CPU run (NaN at the "
              f"same places, the rest within rtol 1e-5 / atol 5 mm); {walls[0]:.3f} s",
              flush=True)
    path_only = ("qp_admm_warm", "path_obs_costs")
    for name, (src, n, entry) in EDGE_CASES.items():
        sc1, extra = edge_scenario(name, cfg)
        wide = lambda t: t.expand(BATCH, *t.shape[1:]).contiguous().cuda()  # noqa: E731
        big, big_extra = tree_map(sc1, wide), {k: tree_map(v, wide) for k, v in extra.items()}
        kernels = {"simulate": path_only + ("tick_lqr_lights" if extra else "tick_lqr",),
                   "simulate_full": full + ("tick_lqr",),
                   "simulate_traffic": path_only + ("tick_traffic",),
                   "ticks": ("tick_lqr",)}[entry]
        out, walls, _ = _drive(f"edge {name}", lambda: edge_run(name, big, big_extra, cfg,
                                                                "cuda"),
                               {**zero, **{k: n for k in kernels}}, 1)
        for i, x in enumerate(tree_leaves(out)):
            if not torch.equal(x, x[:1].expand_as(x)):
                raise AssertionError(f"edge {name}: tensor {i} differs between lanes")
        out_cpu = edge_run(name, sc1, extra, cfg, "cpu")
        first = lambda t: t[:1]  # noqa: E731
        _assert_close_nan(tree_map(out[1], first), out_cpu[1], f"edge {name}")
        _assert_close_nan(tree_map(_ego_of(out), first), _ego_of(out_cpu), f"edge {name} ego")
        assert_edge(name, out, edge_cfg(name, cfg))
        note = ""
        if name == "yield_infeasible":
            c = edge_cfg(name, cfg)
            cyc, _, _ = _drive("edge yield_infeasible cycle 0", lambda: yield_cycle0(big, c),
                               {**zero, **{k: 1 for k in ("qp_admm_cold_path", "path_obs_costs",
                                                          "speed_dp", "qp_admm_cold_speed")}}, 1)
            for i, x in enumerate(cyc):
                if not torch.equal(x, x[:1].expand_as(x)):
                    raise AssertionError(f"edge yield_infeasible cycle 0: output {i} differs "
                                         "between lanes")
            assert_yield_relaxation(cyc, c)
            note = ("; cycle 0's speed stage on the card: one ST segment, a yield below the "
                    "max-braking envelope, the relaxed QP braking at accel_min")
        print(f"edge phase, {name} ({src}, {entry}): batch {BATCH}, every lane lane 0's "
              f"bits, lane 0 equal to the CPU run at the loop's bar and meeting the JAX "
              f"test's assertions{note}; {walls[0]:.3f} s", flush=True)
    print(f"edge phase wall: {time.perf_counter() - t_phase:.1f} s on [{card}]", flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--summary", help="also write the end-to-end medians here (JSON)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from emplanner_carla_tpu_torch import cuda as kbuild
    from emplanner_carla_tpu_torch.config import EMConfig, mpc_feedforward_variant
    from emplanner_carla_tpu_torch.planner import speed_planner
    from emplanner_carla_tpu_torch.routing import astar
    from emplanner_carla_tpu_torch.routing import graph as graph_mod
    from emplanner_carla_tpu_torch.sim import closed_loop, pixel_loop, scenario
    from emplanner_carla_tpu_torch.types import tree_to

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = _card_line()
    t0 = time.perf_counter()
    kbuild.build_all()
    build_s = time.perf_counter() - t0
    print(card, flush=True)
    print(f"kernel build: {build_s:.1f} s for {len(kbuild.SOURCES)} sources",
          flush=True)
    for name, log in kbuild.build_log.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln
                or "spill" in ln or "entry function" in ln]
        print(f"ptxas {name}: " + " | ".join(regs), flush=True)

    cfg = EMConfig()
    assert cfg.loop.n_plans == 20 and cfg.loop.plan_every == 100
    rep = dataclasses.replace
    # BASELINE config 4 (bench_all.py:99-112) and the variants that run the
    # tick kernel's MPC and dynamic-plant branches apart
    cfg4 = rep(cfg, control=rep(cfg.control, kind="MPC"),
               plant=rep(cfg.plant, kind="dynamic"))
    cfg4_kin = rep(cfg4, plant=cfg.plant)
    cfg5_dyn = rep(cfg, plant=cfg4.plant)
    cfg4_ff = rep(cfg4, control=mpc_feedforward_variant(cfg.control),
                  plant=rep(cfg4.plant, substeps=2))
    sc = scenario.batch_scenarios(SEED, BATCH, cfg, device="cuda")
    lights = _lights_for(sc.global_path, "cuda")
    sim3 = lambda c: closed_loop.simulate(*sc, c, device="cuda")  # noqa: E731
    sim5 = lambda c: closed_loop.simulate_full(*sc, c, device="cuda")  # noqa: E731
    sim5l = lambda c: closed_loop.simulate_full(  # noqa: E731
        *sc, c, lights=lights, device="cuda")
    seg1, v01 = _bench_config1_segments(BATCH, "cuda")
    # bench config 7 (bench_all.py:157-170): simulate_traffic, normal preset,
    # full EM; also with the traffic lights and on the mix with its walker
    sc_w = scenario.batch_scenarios(SEED, BATCH, cfg, device="cuda", with_walker=True)
    sim7 = lambda c: closed_loop.simulate_traffic(  # noqa: E731
        *sc, c, behavior="normal", full=True, device="cuda")
    sim7l = lambda c: closed_loop.simulate_traffic(  # noqa: E731
        *sc, c, behavior="normal", full=True, lights=lights, device="cuda")
    sim7w = lambda c: closed_loop.simulate_traffic(  # noqa: E731
        *sc_w, c, behavior="normal", full=True, device="cuda")
    # bench config 6 (bench_all.py:123-133): simulate_full on fleets routed by
    # the device A* over grid_town_curved; the test_9 drive (tests/
    # test_town05.py:58-83): simulate_traffic on the recorded Town05 route
    # under MPC + the dynamic bicycle
    town = graph_mod.grid_town_curved()
    rs6 = scenario.routed_scenarios_device(ROUTED_SEED, BATCH, cfg, town=town,
                                           device="cuda")
    sim6 = lambda c: closed_loop.simulate_full(*rs6.scenario, c, device="cuda")  # noqa: E731
    # bench config 8 (bench_all.py:172-190): the pixel loop, full EM on the
    # camera's estimates (the column view), and its path-only mode
    sc8 = scenario.batch_scenarios(PIXEL_SEED, BATCH, cfg, device="cuda")
    sim8 = lambda c: pixel_loop.simulate_pixels(*sc8, c, full=True, device="cuda")  # noqa: E731
    sim8p = lambda c: pixel_loop.simulate_pixels(*sc8, c, device="cuda")  # noqa: E731
    sc9, _ = scenario.test9_scenario(cfg, device="cuda")
    sim9 = lambda c: closed_loop.simulate_traffic(  # noqa: E731
        *sc9, c, behavior="normal", device="cuda")

    # ---- per-kernel phase, on the third plan cycle of each path: in the
    # first, no obstacle reaches the path DP (the parked cars lie beyond the
    # 30 m static gate and the lead is not closing) ----
    entries = {}
    cap3 = _capture_cycle(sim3, cfg, n_plans=3)
    entries["qp_admm_warm"] = _check_qp(cap3, "qp_admm_warm",
                                        "emplanner_carla_tpu/ops/qp_pallas.py:41")
    entries["path_obs_costs"] = _check_path_obs(cap3)
    entries["tick_lqr"] = _check_ticks(cfg, cap3, "tick_lqr",
                                       "emplanner_carla_tpu/ops/tick_pallas.py:72")
    cap5 = _capture_cycle(sim5, cfg, n_plans=3)
    (seg, v0, _), _ = cap5["speed_dp_kernel"]
    entries["speed_dp"] = _check_speed_dp(seg, v0, cfg.speed, "simulate_full cycle 3")
    fixed = _check_speed_dp(seg1, v01, cfg.speed, "bench config 1 set")
    eq = speed_planner._speed_qp_constants(cfg.speed)[2]
    entries["qp_admm_speed"] = _check_qp(cap5, "qp_admm_speed",
                                         "emplanner_carla_tpu/ops/qp_pallas.py:41", eq)
    cap5l = _capture_cycle(sim5l, cfg, n_plans=3)
    entries["tick_lqr_lights"] = _check_ticks(
        cfg, cap5l, "tick_lqr_lights", "emplanner_carla_tpu/ops/tick_pallas.py:211")
    # the tick kernel's MPC (K5) and dynamic-plant (K6) instantiations, all on
    # config 4's third cycle
    cap4 = _capture_cycle(sim5, cfg4, n_plans=3)
    for name, c, line in (("tick_mpc_dynamic", cfg4, 436),
                          ("tick_mpc_kinematic", cfg4_kin, 436),
                          ("tick_lqr_dynamic", cfg5_dyn, 543),
                          ("tick_mpc_ff_substeps2", cfg4_ff, 436)):
        entries[name] = _check_ticks(c, cap4, name,
                                     f"emplanner_carla_tpu/ops/tick_pallas.py:{line}",
                                     tick_bar=True)
    # the same inputs with the egos displaced off the target, so that the
    # MPC's u* leaves the box and its box ADMM runs (ordinary tracking stays
    # inside it: no lane of the cycle runs the ADMM)
    saturated = _check_ticks(cfg4, _displaced(cap4), "tick_mpc_dynamic",
                             "emplanner_carla_tpu/ops/tick_pallas.py:436", tick_bar=True)
    saturated["input"] = "config 4 cycle 3, egos displaced off the target"
    # the cold QP (K1c) at its two sites
    cap1 = _capture(lambda: _config1_run(seg1, v01, cfg))
    entries["qp_admm_cold_speed"] = _check_cold_qp(cap1, "qp_admm_cold_speed", 1e-3)
    cap2 = _capture(lambda: _config2_run(sc, cfg))
    entries["qp_admm_cold_path"] = _check_cold_qp(cap2, "qp_admm_cold_path", 1e-4)
    # the agent-traffic branch (K7) on config 7's third cycle: LQR +
    # kinematic, with the lights, and MPC + the dynamic bicycle
    for name, run, c, line in (("tick_traffic", sim7, cfg, 555),
                               ("tick_traffic_lights", sim7l, cfg, 685),
                               ("tick_traffic_mpc_dynamic", sim7, cfg4, 555)):
        entries[name] = _check_traffic(c, _capture_cycle(run, c, n_plans=3), name,
                                       f"emplanner_carla_tpu/ops/tick_pallas.py:{line}")
    # the kernels on new input distributions, config 6's third cycle: routed
    # curvature (junction arcs, padded tails); printed, not in the JSON line
    extra = [fixed, saturated, *_check_new_inputs(sim6, cfg, eq, "config 6 cycle 3"),
             *_check_new_inputs(sim8, cfg, eq, "config 8 cycle 3")]
    for e in (*entries.values(), *extra):
        _print_entry(e)

    # ---- end-to-end phase: the host-bound cycle's wall varies by tens of
    # percent from run to run, so five timed runs a main path ----
    zero = {k: 0 for k in _read_counts()}
    n = cfg.loop.n_plans
    per_path = {}
    full = ("qp_admm_warm", "qp_admm_speed", "path_obs_costs", "speed_dp")
    for label, run, path_cfg, kernels, reps in (
        ("simulate config 3", sim3, cfg,
         ("qp_admm_warm", "path_obs_costs", "tick_lqr"), 5),
        ("simulate_full config 5", sim5, cfg, full + ("tick_lqr",), 5),
        ("simulate_full config 4", sim5, cfg4, full + ("tick_mpc_dynamic",), 5),
        ("simulate_traffic config 7", sim7, cfg, full + ("tick_traffic",), 5),
        ("simulate_full config 6, routed", sim6, cfg, full + ("tick_lqr",), 5),
        ("simulate_pixels config 8", sim8, cfg, full + ("tick_lqr",), 5),
        ("simulate_full config 5 + lights", sim5l, cfg, full + ("tick_lqr_lights",), 1),
        ("simulate_full config 4, kinematic plant", sim5, cfg4_kin,
         full + ("tick_mpc_kinematic",), 1),
        ("simulate_full config 5, dynamic plant", sim5, cfg5_dyn,
         full + ("tick_lqr_dynamic",), 1),
        ("simulate_full config 4, feedforward MPC, 2 substeps", sim5, cfg4_ff,
         full + ("tick_mpc_dynamic",), 1),
        ("simulate_traffic config 7 + lights", sim7l, cfg, full + ("tick_traffic_lights",), 1),
        ("simulate_traffic config 7, walkers", sim7w, cfg, full + ("tick_traffic",), 1),
        ("simulate_traffic config 7, MPC + dynamic bicycle", sim7, cfg4,
         full + ("tick_traffic_mpc_dynamic",), 1),
        ("simulate_pixels config 8, path-only", sim8p, cfg,
         ("qp_admm_warm", "path_obs_costs", "tick_lqr"), 1),
    ):
        run(_with_plans(path_cfg, 2))                    # warm-up
        torch.cuda.synchronize()
        expected = {**zero, **{k: n for k in kernels}}
        (_, metrics), walls, counts = _drive(label, lambda: run(path_cfg), expected, reps)
        if label == "simulate_full config 5":
            m5 = metrics
        pixels = {}
        if isinstance(metrics, pixel_loop.PixelMetrics):
            pixels = dict(mean_tracked=float(metrics.n_tracked.float().mean()),
                          mean_perc_err_m=float(metrics.perc_err.mean()))
            metrics = metrics.ticks
        assert tuple(metrics.x.shape) == (BATCH, n, cfg.loop.plan_every)
        wall = sorted(walls)[len(walls) // 2]
        summ = {**_summary(metrics, closed_loop, BATCH), **pixels}
        cycles_s = BATCH * n / wall
        per_path[label] = dict(wall_s=wall, walls_s=walls, cycles_per_s=cycles_s,
                               ms_per_cycle=wall / n * 1e3, counts=counts, **summ)
        print(f"{label}: batch {BATCH} x {n} plans x {cfg.loop.plan_every} ticks "
              f"in {wall:.3f} s (median of {', '.join(f'{w:.3f}' for w in walls)} s) "
              f"= {cycles_s:.1f} cycles/s on [{card}]; collisions "
              f"{summ['collisions']}/{BATCH}, lateral RMSE {summ['lateral_rmse']:.4f} m, "
              f"mean speed {summ['mean_speed_kmh']:.2f} km/h, infeasible "
              f"{summ['infeasible_frac']:.5f}, segments_dropped "
              f"{summ['segments_dropped']:.0f}"
              + "".join(f", {k} {v:.4f}" for k, v in pixels.items())
              + f", launches {counts}", flush=True)
    # a finding, not a gate: the JAX package's docstring records 0/4096
    # collisions for full=True at this scale (on its own hardware)
    print(f"config 8 collisions, full EM from pixels: port "
          f"{per_path['simulate_pixels config 8']['collisions']}/{BATCH} on [{card}]; "
          f"the JAX package records 0/4096 in this mode at this scale "
          f"(emplanner_carla_tpu/sim/pixel_loop.py:39-41)", flush=True)
    # the open-loop entries of the cold QP: one call is one batch of solves
    for label, fn, kernels, unit in (
        ("config 1 standalone S-T solve", lambda: _config1_run(seg1, v01, cfg),
         ("speed_dp", "qp_admm_cold_speed"), "solves/s"),
        ("config 2 open-loop path plan", lambda: _config2_run(sc, cfg).target.x,
         ("path_obs_costs", "qp_admm_cold_path"), "plans/s"),
    ):
        fn()                                             # warm-up
        torch.cuda.synchronize()
        out, walls, counts = _drive(label, fn, {**zero, **{k: 1 for k in kernels}}, 5)
        if not bool(torch.isfinite(out).all()) or out.shape[0] != BATCH:
            raise AssertionError(f"{label}: output {tuple(out.shape)} not finite")
        wall = sorted(walls)[len(walls) // 2]
        per_path[label] = dict(wall_s=wall, walls_s=walls, per_s=BATCH / wall,
                               unit=unit, counts=counts)
        print(f"{label}: batch {BATCH} in {wall * 1e3:.3f} ms (median of "
              f"{', '.join(f'{w * 1e3:.3f}' for w in walls)} ms) = {BATCH / wall:.1f} "
              f"{unit} on [{card}]; launches {counts}", flush=True)
    # bench config 6b (bench_all.py:135-155): the device route engine alone,
    # 4096 (origin, destination) queries over grid_town_curved, pad 256
    gen = torch.Generator(device="cpu")
    gen.manual_seed(ROUTE_QUERY_SEED)
    od = [torch.randint(0, town.n_nodes, (BATCH,), generator=gen).cuda() for _ in range(2)]
    rq = lambda: _route_queries(town, *od, ROUTE_PAD)  # noqa: E731
    rq()                                                 # warm-up
    torch.cuda.synchronize()
    out, walls, counts = _drive("config 6b device route queries", rq, zero, 5)
    reached, x6b, n6b = out[2], out[3], out[5]
    # a routed pair of two nodes stitches at least one edge (o == d: one point)
    if not bool(torch.isfinite(x6b).all()) \
            or not bool((n6b[reached & (od[0] != od[1])] >= 2).all()):
        raise AssertionError("config 6b: stitched routes not finite or empty")
    wall = sorted(walls)[len(walls) // 2]
    reached_share = float(reached.float().mean())
    per_path["config 6b device route queries"] = dict(
        wall_s=wall, walls_s=walls, per_s=BATCH / wall, unit="routes/s", counts=counts,
        reached_share=reached_share)
    print(f"config 6b device route queries: batch {BATCH} (A*, backtrack, stitch to "
          f"{ROUTE_PAD} points) in {wall * 1e3:.3f} ms (median of "
          f"{', '.join(f'{w * 1e3:.3f}' for w in walls)} ms) = {BATCH / wall:.1f} "
          f"routes/s on [{card}]; reached share {reached_share:.4f}, mean route "
          f"{float(n6b.float().mean()):.1f} points; launches {counts}", flush=True)
    # the test_9 drive, once: MPC + the dynamic bicycle, the agent NPC
    cfg9 = _with_plans(cfg4, TEST9_PLANS)
    sim9(_with_plans(cfg4, 1))                           # warm-up
    torch.cuda.synchronize()
    (_, m9), walls, counts = _drive(
        "test_9 drive", lambda: sim9(cfg9),
        {**zero, **{k: TEST9_PLANS for k in ("qp_admm_warm", "path_obs_costs",
                                             "tick_traffic_mpc_dynamic")}}, 1)
    assert tuple(m9.x.shape) == (1, TEST9_PLANS, cfg.loop.plan_every)
    summ = _summary(m9, closed_loop, 1)
    per_path["test_9 drive"] = dict(wall_s=walls[0], counts=counts, **summ)
    print(f"test_9 drive (test9_scenario, simulate_traffic, MPC + dynamic bicycle): "
          f"1 x {TEST9_PLANS} plans x {cfg.loop.plan_every} ticks in {walls[0]:.3f} s "
          f"on [{card}]; collisions {summ['collisions']}/1, lateral RMSE "
          f"{summ['lateral_rmse']:.4f} m, mean speed {summ['mean_speed_kmh']:.2f} km/h, "
          f"launches {counts}", flush=True)
    launch_src = {
        "tick_lqr_lights": ("simulate_full config 5 + lights", "tick_lqr_lights"),
        "tick_mpc_dynamic": ("simulate_full config 4", "tick_mpc_dynamic"),
        "tick_mpc_kinematic": ("simulate_full config 4, kinematic plant",
                               "tick_mpc_kinematic"),
        "tick_lqr_dynamic": ("simulate_full config 5, dynamic plant", "tick_lqr_dynamic"),
        "tick_mpc_ff_substeps2": ("simulate_full config 4, feedforward MPC, 2 substeps",
                                  "tick_mpc_dynamic"),
        "qp_admm_cold_speed": ("config 1 standalone S-T solve", "qp_admm_cold_speed"),
        "qp_admm_cold_path": ("config 2 open-loop path plan", "qp_admm_cold_path"),
        "tick_traffic": ("simulate_traffic config 7", "tick_traffic"),
        "tick_traffic_lights": ("simulate_traffic config 7 + lights", "tick_traffic_lights"),
        "tick_traffic_mpc_dynamic": ("simulate_traffic config 7, MPC + dynamic bicycle",
                                     "tick_traffic_mpc_dynamic"),
    }
    for name, e in entries.items():
        path, key = launch_src.get(name, ("simulate_full config 5", name))
        e["launches"] = per_path[path]["counts"][key]
        e["launches_from"] = path

    # ---- fleet and utilities phase ----
    _fleet_phase(cfg, sc, sc8, m5, zero, per_path, card)

    # ---- device equivalence phase ----
    small = scenario.batch_scenarios(SEED + 1, 128, cfg, device="cpu")
    small_lights = _lights_for(small.global_path, "cpu")
    for label, fn, c, kw in (
        ("simulate", closed_loop.simulate, cfg, {}),
        ("simulate_full", closed_loop.simulate_full, cfg, {}),
        ("simulate_full + lights", closed_loop.simulate_full, cfg, {"lights": small_lights}),
        ("simulate_full config 4", closed_loop.simulate_full, cfg4, {}),
        ("simulate_traffic config 7", closed_loop.simulate_traffic, cfg,
         {"behavior": "normal", "full": True}),
    ):
        eq_cfg = _with_plans(c, 2)
        _, m_gpu = fn(*small, eq_cfg, device="cuda", **kw)
        _, m_cpu = fn(*small, eq_cfg, device="cpu", **kw)
        _assert_metrics_match(m_gpu, m_cpu, f"{label} cuda_vs_cpu")
        print(f"device equivalence, {label}: 128 scenarios x 2 plans, cuda == cpu "
              "within rtol 1e-5 / atol 5 mm, decisions identical", flush=True)
    small6 = scenario.routed_scenarios_device(ROUTED_SEED + 1, 128, cfg, town=town,
                                              device="cpu").scenario
    eq_cfg = _with_plans(cfg, 2)
    _, m_gpu = closed_loop.simulate_full(*small6, eq_cfg, device="cuda")
    _, m_cpu = closed_loop.simulate_full(*small6, eq_cfg, device="cpu")
    _assert_metrics_match(m_gpu, m_cpu, "simulate_full config 6 cuda_vs_cpu")
    print("device equivalence, simulate_full config 6 (routed): 128 scenarios x 2 "
          "plans, cuda == cpu within rtol 1e-5 / atol 5 mm, decisions identical",
          flush=True)
    small8 = scenario.batch_scenarios(PIXEL_SEED + 1, 128, cfg, device="cpu")
    for label, kw in (("full EM", dict(full=True)), ("path-only", {}),
                      ("path-only, frame path", dict(columns=False))):
        _, p_gpu = pixel_loop.simulate_pixels(*small8, eq_cfg, device="cuda", **kw)
        _, p_cpu = pixel_loop.simulate_pixels(*small8, eq_cfg, device="cpu", **kw)
        tag = f"simulate_pixels {label} cuda_vs_cpu"
        _assert_metrics_match(p_gpu.ticks, p_cpu.ticks, tag)
        if not torch.equal(p_gpu.n_tracked.cpu(), p_cpu.n_tracked):
            raise AssertionError(f"{tag}: tracked counts differ")
        if not torch.allclose(p_gpu.perc_err.cpu(), p_cpu.perc_err, rtol=1e-5, atol=5e-3):
            raise AssertionError(f"{tag}: perception error differs")
        print(f"device equivalence, simulate_pixels config 8 ({label}): 128 scenarios x "
              f"2 plans, cuda == cpu within rtol 1e-5 / atol 5 mm, decisions and tracked "
              f"counts identical", flush=True)
    od_s = [t[:128].cpu() for t in od]
    r_gpu = (*astar.astar_device(town, *[t.cuda() for t in od_s]),
             *_route_queries(town, *[t.cuda() for t in od_s], ROUTE_PAD))
    r_cpu = (*astar.astar_device(town, *od_s), *_route_queries(town, *od_s, ROUTE_PAD))
    for name, a, b in zip(("parent", "found", "route", "valid", "reached", "x", "y",
                           "n_valid", "options"), r_gpu, r_cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"config 6b {name} cuda_vs_cpu: "
                                 f"{int((a.cpu() != b).sum())} differ")
    print("device equivalence, config 6b: 128 route queries, cuda == cpu: parents, "
          "routes, n_valid, options, x and y identical", flush=True)
    seg_s, v0_s = _bench_config1_segments(128, "cpu")
    v0_s = v0_s + torch.linspace(-6.0, 4.0, 128)      # other plan-start speeds
    s_gpu = _config1_run(tree_to(seg_s, "cuda"), v0_s.cuda(), cfg).cpu()
    s_cpu = _config1_run(seg_s, v0_s, cfg)
    if not torch.allclose(s_gpu, s_cpu, rtol=1e-4, atol=1e-3):
        raise AssertionError(f"config 1 cuda_vs_cpu: max |diff| "
                             f"{float((s_gpu - s_cpu).abs().max())}")
    p_gpu = _config2_run(tree_to(small, "cuda"), cfg)
    p_cpu = _config2_run(small, cfg)
    _assert_metrics_match(tree_to(p_gpu.target, "cpu"), p_cpu.target,
                          "config 2 target cuda_vs_cpu")
    if not torch.equal(p_gpu.feasible.cpu(), p_cpu.feasible):
        raise AssertionError("config 2 feasible cuda_vs_cpu differ")
    print("device equivalence, config 1 and config 2: 128 lanes, cuda == cpu (S-T "
          "stations within rtol 1e-4 / atol 1 mm; target path within rtol 1e-5 / "
          "atol 5 mm, feasibility identical)", flush=True)

    # ---- edge phase ----
    _edge_phase(cfg, sc, zero, card)

    if opts.summary:
        with open(opts.summary, "w") as fh:
            json.dump({"card": card, "paths": per_path}, fh, indent=1)
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s, the kernel build "
          f"included, on [{card}]", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries.values()]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
