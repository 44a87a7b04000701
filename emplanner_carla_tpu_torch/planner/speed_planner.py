"""S-T speed planning on batch-first tensors: ST graph -> DP -> convex space
-> warm QP -> densify (counterpart of
``emplanner_carla_tpu/planner/speed_planner.py``).

Every tensor carries the batch first: segments (B, K), DP columns (B, n_t),
QP knots (B, n_t + 1), the dense profile (B, n_dense).

Two kernels run here for CUDA tensors:

* :func:`speed_dp` launches ``csrc/speed_dp.cu`` (the port of
  ``ops/speed_dp_pallas.py speed_dp_recursion`` and its wrapper
  ``speed_dp_batched``); a CPU tensor runs :func:`_speed_dp_torch`, its
  plain version, a batch-first transcription of ``_speed_dp_xla``;
* :func:`speed_qp` solves on the warm ADMM kernel ``csrc/qp_admm.cu``
  through ``ops/qp.py`` (n 51, m 99), counted as ``qp_admm_speed``.

The DP's plain version and its kernel compute the same float32 operations in
the same order (association ``cost_prev + (obs + ref + forbidden) + acc`` as
``_speed_dp_xla`` builds it, obstacle terms folded sample-major, segment-
minor, quotients as IEEE divisions by tensors), so on the card the two agree
bit for bit. Both skip the obstacle terms of a (lane, column, segment) whose
pure-time gap to the segment is at least ``obs_danger_dist``: every such
sample costs exactly zero (the Pallas kernel's gate, :196-199). The kernel
also skips each sample outside its segment's :func:`st_gate_window` (by
:func:`st_sample_skipped`, which it mirrors), whose cost is exactly zero
too, and multiplies by ``1 / t_step`` where :func:`_exact_reciprocal` finds
the product equal to the quotient.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from emplanner_carla_tpu_torch import cuda
from emplanner_carla_tpu_torch.config import SpeedPlanConfig
from emplanner_carla_tpu_torch.ops import interp, qp
from emplanner_carla_tpu_torch.precision import require_fp32_matmul
from emplanner_carla_tpu_torch.types import STSegments, Tensor, sdiv, tdiv

BIG = 1e8

launches = {"speed_dp": 0}


def speed_plan_start(vx, vy, ax, ay, heading):
    """World velocity/acceleration projected on the path tangent (B,)."""
    tx, ty = torch.cos(heading), torch.sin(heading)
    return vx * tx + vy * ty, ax * tx + ay * ty


def st_graph(obs_s, obs_l, obs_s_dot, obs_l_dot, valid,
             cfg: SpeedPlanConfig) -> STSegments:
    """Dynamic obstacles (B, K) -> S-T occupancy segments: a crossing
    obstacle (|l_dot| >= l_dot_gate) occupies the segment between entering
    and leaving the |l| <= lateral_gate band under constant velocity, gated
    to the [t_min_gate, t_max_gate] window."""
    crossing = obs_l_dot.abs() >= cfg.l_dot_gate
    l_dot_safe = torch.where(crossing, obs_l_dot, 1.0)
    t_zero = -obs_l / l_dot_safe
    t_b1 = sdiv(cfg.lateral_gate, l_dot_safe) + t_zero
    t_b2 = sdiv(-cfg.lateral_gate, l_dot_safe) + t_zero
    t_max = torch.maximum(t_b1, t_b2)
    t_min = torch.minimum(t_b1, t_b2)
    in_window = (t_max >= cfg.t_min_gate) & (t_min <= cfg.t_max_gate)
    already_in = (t_min < 0.0) & (t_max > 0.0)
    t_in = torch.where(already_in, 0.0, t_min)
    s_in = obs_s + obs_s_dot * t_in
    s_out = obs_s + obs_s_dot * t_max
    keep = valid & crossing & in_window
    return STSegments(s_in, s_out, t_in, t_max, keep)


def top_m_segments(seg: STSegments, m: int):
    """Keep the ``m`` segments a lane enters first, valid before invalid.
    Returns (segments (B, min(m, K)), (B,) int32 count of valid segments
    dropped)."""
    K = seg.valid.shape[1]
    n_valid = seg.valid.to(torch.int32).sum(1)
    if m < K:
        key = torch.where(seg.valid, seg.t_in, float("inf"))
        # jnp.argsort is stable: ties and the inf padding keep slot order
        keep = torch.argsort(key, dim=1, stable=True)[:, :m]
        seg = STSegments(*(torch.gather(a, 1, keep) for a in seg))
    return seg, n_valid - seg.valid.to(torch.int32).sum(1)


class _Grid(NamedTuple):
    """The DP's float32 constant tables, formed on the CPU (IEEE, one op at
    a time) and shared by the plain version and the kernel."""

    s_grid: Tensor   # (n_s,) ascending stations
    t_grid: Tensor   # (n_t,) column times (c + 1) * t_step
    frac: Tensor     # (m,) edge-sample fractions q / (m - 1)
    v0e: Tensor      # (n_s,) start-edge speeds s_j / t_0
    ref0: Tensor     # (n_s,) start-edge reference-speed cost
    dv: Tensor       # (n_s, n_s) edge speed (s_j - s_k) / dt, (prev k, cur j)
    ref_tr: Tensor   # (n_s, n_s) edge reference-speed cost
    forb: Tensor     # (n_s, n_s) BIG on reverse edges, else 0


@lru_cache(maxsize=None)
def _grid(cfg: SpeedPlanConfig, device: str) -> _Grid:
    f32 = torch.float32
    sg = torch.tensor(cfg.s_grid, dtype=f32)
    t_grid = (torch.arange(cfg.n_t, dtype=f32) + 1.0) * cfg.t_step
    frac = torch.arange(cfg.n_edge_samples, dtype=f32) / (cfg.n_edge_samples - 1)
    v0e = sg / t_grid[0]
    d0 = v0e - cfg.reference_speed
    ref0 = cfg.w_ref_speed * (d0 * d0)
    dv = (sg[None, :] - sg[:, None]) / cfg.t_step
    d = dv - cfg.reference_speed
    ref_tr = cfg.w_ref_speed * (d * d)
    forb = torch.where(dv < 0.0, BIG, 0.0).to(f32)
    return _Grid(*(t.to(device) for t in
                   (sg, t_grid, frac, v0e, ref0, dv, ref_tr, forb)))


def _log_w(cfg: SpeedPlanConfig) -> float:
    """float32 log(w_obs), as ``jnp.log(cfg.w_obs)`` rounds it."""
    return float(np.log(np.float32(cfg.w_obs)))


def _collision_cost(d: Tensor, cfg: SpeedPlanConfig) -> Tensor:
    """w_obs below collision_dist; w_obs^(1.5 - d) in the danger band;
    exactly 0 beyond (``CalcCollisionCost``)."""
    band = torch.exp(_log_w(cfg) * ((cfg.obs_collision_dist + 1.0) - d))
    return torch.where(
        d < cfg.obs_collision_dist, cfg.w_obs,
        torch.where(d < cfg.obs_danger_dist, band, 0.0),
    )


def _seg_distance(s, t, si, so, ti, to) -> Tensor:
    """Distance from sample points (s, t) to one segment per lane, with one
    square root per (sample, segment): endpoint or perpendicular selection
    on squared distances (``_seg_distance``). Arguments broadcast."""
    v1s = si - s
    v1t = ti - t
    v2s = so - s
    v2t = to - t
    v3s = v2s - v1s
    v3t = v2t - v1t
    d1_sq = v1s * v1s + v1t * v1t
    d2_sq = v2s * v2s + v2t * v2t
    nrm_sq = (v3s * v3s + v3t * v3t) + 1e-24
    cross = v1s * v3t - v1t * v3s
    d_perp_sq = cross * cross * sdiv(1.0, nrm_sq)
    p1 = v1s * v3s + v1t * v3t
    p2 = v2s * v3s + v2t * v3t
    endpoint = (p1 > 0) == (p2 > 0)
    return torch.sqrt(torch.where(endpoint, torch.minimum(d1_sq, d2_sq),
                                  d_perp_sq))


# the gate's float margin, relative to the magnitudes of a segment and of the
# DP's samples: it covers the rounding of their distance (a few float32 ulps
# of those magnitudes) many times over
GATE_REL = 1e-4


def _gate_scale(cfg: SpeedPlanConfig) -> float:
    """float32 bound on every DP sample's |s| and |t|: the last station and
    the last column's end time."""
    return float(np.maximum(np.float32(cfg.s_grid[-1]),
                            np.float32(cfg.n_t) * np.float32(cfg.t_step)))


def st_gate_window(seg: STSegments, cfg: SpeedPlanConfig):
    """Per segment (B, K) the station window (lo, hi) outside which a DP
    sample's obstacle cost is exactly 0: the segment's s range widened by
    ``obs_danger_dist`` plus a margin of GATE_REL x (1 + the largest of the
    segment's |s|, |t| and :func:`_gate_scale`). A sample at least that far
    outside the range lies at least ``obs_danger_dist`` from the segment,
    and the float32 distance of ``_seg_distance`` (either form) errs by far
    less than the margin. A segment shorter than the margin gets (-inf, inf):
    there the distance's 1e-24 regulariser may dominate. NaN inputs give
    NaN bounds, which skip nothing. ``csrc/speed_dp.cu`` computes the same
    float32 operations under the same name."""
    si, so, ti, to = seg.s_in, seg.s_out, seg.t_in, seg.t_out
    scale = torch.maximum(torch.maximum(torch.maximum(si.abs(), so.abs()),
                                        torch.maximum(ti.abs(), to.abs())),
                          torch.tensor(_gate_scale(cfg), dtype=torch.float32,
                                       device=si.device))
    margin = GATE_REL * (1.0 + scale)
    reach = cfg.obs_danger_dist + margin
    v3s = so - si
    v3t = to - ti
    short = (v3s * v3s + v3t * v3t) < margin * margin
    lo = torch.where(short, -float("inf"), torch.minimum(si, so) - reach)
    hi = torch.where(short, float("inf"), torch.maximum(si, so) + reach)
    return lo, hi


def st_sample_skipped(s: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """True where a sample at station ``s`` lies outside the segment's
    window from :func:`st_gate_window`: its obstacle cost is exactly 0."""
    return (s < lo) | (s > hi)


def _exact_reciprocal(dt: float) -> bool:
    """Whether x * (1 / dt) equals x / dt for every float32 x: float32 dt is
    a power of two whose reciprocal is a normal float32 (then both round the
    same exact value)."""
    d = np.float32(dt)
    if not np.isfinite(d) or d <= 0:
        return False
    mant, _ = math.frexp(float(d))
    inv = np.float32(1.0) / d
    return bool(mant == 0.5 and np.isfinite(inv) and inv >= np.finfo(np.float32).tiny)


def _sqrt_threshold(d: float) -> float:
    """The least float32 x whose float32 square root is >= float32(d): for
    float32 x >= 0 (and NaN), ``sqrt(x) < d`` equals ``x < threshold``, since
    the correctly rounded square root is monotone."""
    d = np.float32(d)
    x = d * d
    while np.sqrt(x) >= d and x > 0:
        x = np.nextafter(x, np.float32(0))
    while np.sqrt(x) < d:
        x = np.nextafter(x, np.float32(np.inf))
    return float(x)


def _interior_distance(v1s, c1, c2, c3, c4, v3s, v3t, nrm, inv) -> Tensor:
    """``_seg_distance`` of an interior edge sample with its time-only terms
    (c1 = v1t^2, c2 = v2t^2, c3 = v1t v3s, c4 = v1t v3t) and its segment's
    terms (v3, nrm = |v3|^2 + 1e-24, inv = 1 / nrm) hoisted, v1s = s_in - s."""
    d1_sq = v1s * v1s + c1
    v2s = v1s + v3s
    d2_sq = v2s * v2s + c2
    cross = v1s * v3t - c3
    d_perp_sq = cross * cross * inv
    p1 = v1s * v3s + c4
    p2 = p1 + nrm
    endpoint = (p1 > 0) == (p2 > 0)
    return torch.sqrt(torch.where(endpoint, torch.minimum(d1_sq, d2_sq), d_perp_sq))


def _fold(acc, term):
    return term if acc is None else acc + term


def _edge_obs_tensors(seg: STSegments, cfg: SpeedPlanConfig):
    """Obstacle cost of every DP edge: (obs0 (B, n_s), obs_tr (B, n_t-1,
    n_s, n_s) as (column, prev k, cur j)).

    The start edge samples (s_j * frac_q, t_0 * frac_q); a transition edge
    of column c samples (s_k, t_start), (s_j, t_end) (rank-1 pieces A and B)
    and m-2 interior points (s_k + (s_j - s_k) fm_q, t_start + dt fm_q),
    whose time-only and segment-only terms are hoisted as in the JAX
    package's ``_edge_obs_tensors``. Sums fold sample-major, segment-minor;
    a (lane, column, segment) whose time gap to the segment is at least
    obs_danger_dist contributes exact zeros."""
    g = _grid(cfg, str(seg.s_in.device))
    K = seg.valid.shape[1]
    m, dt = cfg.n_edge_samples, cfg.t_step
    dang = cfg.obs_danger_dist
    si, so, ti, to = seg.s_in, seg.s_out, seg.t_in, seg.t_out       # (B, K)
    t0 = g.t_grid[0]
    t_start = g.t_grid[:-1]                                          # (C,)
    t_end = t_start + dt
    live0 = seg.valid & (torch.maximum(ti - t0, -to) < dang)        # (B, K)
    gap = torch.maximum(ti[:, None, :] - t_end[None, :, None],
                        t_start[None, :, None] - to[:, None, :])    # (B, C, K)
    live = seg.valid[:, None, :] & (gap < dang)

    def cost(d, on):
        return torch.where(on, _collision_cost(d, cfg), 0.0)

    obs0 = None
    for q in range(m):
        s_q = g.s_grid * g.frac[q]                                   # (n_s,)
        t_q = t0 * g.frac[q]
        for k in range(K):
            d = _seg_distance(s_q, t_q, si[:, k, None], so[:, k, None],
                              ti[:, k, None], to[:, k, None])        # (B, n_s)
            obs0 = _fold(obs0, cost(d, live0[:, k, None]))

    cost_a = cost_b = None
    for k in range(K):
        f = [a[:, k, None, None] for a in (si, so, ti, to)]          # (B, 1, 1)
        on = live[:, :, k, None]
        d_a = _seg_distance(g.s_grid, t_start[:, None], *f)          # (B, C, n_s)
        d_b = _seg_distance(g.s_grid, t_end[:, None], *f)
        cost_a = _fold(cost_a, cost(d_a, on))
        cost_b = _fold(cost_b, cost(d_b, on))
    obs_tr = cost_a[:, :, :, None] + cost_b[:, :, None, :]           # (B, C, k, j)

    v3s = so - si                                                    # (B, K)
    v3t = to - ti
    nrm = (v3s * v3s + v3t * v3t) + 1e-24
    inv = sdiv(1.0, nrm)
    sg = g.s_grid
    cost_c = None
    for q in range(1, m - 1):
        fm = g.frac[q]
        t_p = t_start + dt * fm                                      # (C,)
        s_mid = sg[:, None] + (sg[None, :] - sg[:, None]) * fm       # (k, j)
        for k in range(K):
            v1t = ti[:, k, None] - t_p                               # (B, C)
            v2t = to[:, k, None] - t_p
            c1 = (v1t * v1t)[:, :, None, None]
            c2 = (v2t * v2t)[:, :, None, None]
            c3 = (v1t * v3s[:, k, None])[:, :, None, None]
            c4 = (v1t * v3t[:, k, None])[:, :, None, None]
            v1s = (si[:, k, None, None] - s_mid)[:, None]            # (B, 1, k, j)
            d = _interior_distance(
                v1s, c1, c2, c3, c4,
                *(a[:, k, None, None, None] for a in (v3s, v3t, nrm, inv)))
            cost_c = _fold(cost_c, cost(d, live[:, :, k, None, None]))  # (B, C, k, j)
    if cost_c is not None:
        obs_tr = obs_tr + cost_c
    return obs0, obs_tr


def _acc_cost(a: Tensor, cfg: SpeedPlanConfig) -> Tensor:
    a2 = a * a
    ok = (a < cfg.accel_max) & (a > cfg.accel_min)
    return torch.where(ok, cfg.w_accel * a2,
                       (cfg.accel_penalty * cfg.w_accel) * a2)


class SpeedDPResult(NamedTuple):
    s: Tensor          # (B, n_t) chosen s per t column (0 past the end)
    t: Tensor          # (B, n_t) column times
    valid: Tensor      # (B, n_t) columns up to the DP terminal column
    end_index: Tensor  # (B,) int32 terminal column


def speed_dp(seg: STSegments, plan_start_s_dot: Tensor,
             cfg: SpeedPlanConfig) -> SpeedDPResult:
    """Speed decision DP over the (n_s x n_t) lattice: the kernel
    ``csrc/speed_dp.cu`` for CUDA tensors, :func:`_speed_dp_torch` on the
    CPU."""
    if plan_start_s_dot.is_cuda:
        return speed_dp_kernel(seg, plan_start_s_dot, cfg)
    return _speed_dp_torch(seg, plan_start_s_dot, cfg)


def _speed_dp_torch(seg: STSegments, v0: Tensor,
                    cfg: SpeedPlanConfig) -> SpeedDPResult:
    """Plain PyTorch version of the DP (``_speed_dp_xla``, batch first).

    Rows are stations ascending. Each column keeps, per station, the first
    minimum over predecessors of ``cost_prev + (obs + ref + forbidden) +
    acc`` (the acceleration term from the carried arrival speed); the
    terminal is the best of the right column and the s_max row of every
    column, ties to the later column; then the backtrack."""
    g = _grid(cfg, str(v0.device))
    n_s, n_t = cfg.n_s, cfg.n_t
    B = v0.shape[0]
    obs0, obs_tr = _edge_obs_tensors(seg, cfg)
    a0 = (g.v0e[None, :] - v0[:, None]) / g.t_grid[0].expand(B, n_s)
    cost = (obs0 + g.ref0) + _acc_cost(a0, cfg)                      # (B, n_s)
    sdot = g.v0e.expand(B, n_s)
    static = (obs_tr + g.ref_tr) + g.forb                            # (B, C, k, j)
    cols = torch.arange(n_s, device=v0.device)
    tops = [cost[:, -1]]
    args = []
    for c in range(n_t - 1):
        accel = tdiv(g.dv[None, :, :] - sdot[:, :, None], cfg.t_step)
        total = (cost[:, :, None] + static[:, c]) + _acc_cost(accel, cfg)
        best = torch.argmin(total, dim=1)                            # (B, j)
        cost = torch.gather(total, 1, best[:, None, :])[:, 0]
        sdot = g.dv[best, cols]
        args.append(best)
        tops.append(cost[:, -1])

    best_right = torch.argmin(cost, dim=1)
    right_cost = torch.gather(cost, 1, best_right[:, None])[:, 0]
    top = torch.stack(tops, 1)                                       # (B, n_t)
    best_top_col = (n_t - 1) - torch.argmin(top.flip(1), dim=1)      # last min
    top_cost = torch.gather(top, 1, best_top_col[:, None])[:, 0]
    use_top = top_cost <= right_cost
    end_col = torch.where(use_top, best_top_col, n_t - 1)
    end_row = torch.where(use_top, n_s - 1, best_right)

    rows = [None] * n_t
    row = end_row
    for c in range(n_t - 1, -1, -1):
        on = c <= end_col
        this = torch.where(end_col == c, end_row, row)
        rows[c] = torch.where(on, this, -1)
        if c > 0:
            prev = torch.gather(args[c - 1], 1, this[:, None])[:, 0]
            row = torch.where(on, prev, this)
    rows = torch.stack(rows, 1)
    valid = torch.arange(n_t, device=v0.device)[None, :] <= end_col[:, None]
    s_out = torch.where(valid, g.s_grid[torch.clamp(rows, min=0)], 0.0)
    return SpeedDPResult(s_out, g.t_grid.expand(B, n_t), valid,
                         end_col.to(torch.int32))


# the speed-DP kernel's limits (csrc/speed_dp.cu, whose launcher checks the
# same): segment slots, stations, columns and interior samples an edge, with
# 5 * K and (n_edge_samples - 2) * K at most n_s
DP_K_MAX, DP_NS_MAX, DP_NT_MAX, DP_Q_MAX = 8, 64, 32, 8
# lanes a block of the kernel holds
DP_BLOCK_LANES = 1


def check_dp_kernel_limits(K: int, cfg: SpeedPlanConfig) -> None:
    """Raise ``ValueError`` naming the speed-DP kernel's limit that K
    segment slots under ``cfg`` are past."""
    n_s, n_t, q = cfg.n_s, cfg.n_t, cfg.n_edge_samples - 2
    if not (1 <= K <= DP_K_MAX and 2 <= n_s <= DP_NS_MAX and 2 <= n_t <= DP_NT_MAX
            and 0 <= q <= DP_Q_MAX and 5 * K <= n_s and q * K <= n_s):
        raise ValueError(
            f"the speed-DP kernel (csrc/speed_dp.cu) holds 1..{DP_K_MAX} segment "
            f"slots, 2..{DP_NS_MAX} stations, 2..{DP_NT_MAX} columns and "
            f"0..{DP_Q_MAX} interior samples an edge, with 5 * slots and samples "
            f"* slots at most the stations; got {K} slots, {n_s} stations, {n_t} "
            f"columns, {q} interior samples")


@lru_cache(maxsize=None)
def _kernel_constants(cfg: SpeedPlanConfig):
    """(the kernel's float parameters, whether 1 / t_step is exact)."""
    exact = _exact_reciprocal(cfg.t_step)
    fparams = (
        cfg.t_step, cfg.w_accel, cfg.accel_penalty * cfg.w_accel,
        cfg.accel_min, cfg.accel_max, cfg.w_obs, cfg.obs_collision_dist,
        cfg.obs_danger_dist, _log_w(cfg), cfg.obs_collision_dist + 1.0, BIG,
        float(np.float32(1.0) / np.float32(cfg.t_step)) if exact else 0.0,
        _sqrt_threshold(cfg.obs_collision_dist), _sqrt_threshold(cfg.obs_danger_dist),
        _gate_scale(cfg), GATE_REL,
    )
    return fparams, exact


def speed_dp_kernel(seg: STSegments, v0: Tensor,
                    cfg: SpeedPlanConfig) -> SpeedDPResult:
    """Launch ``csrc/speed_dp.cu``: the whole DP (obstacle edge costs, the
    column recursion, termination and backtrack) in one kernel, one block a
    lane. Raises
    ``ValueError`` past the kernel's limits (checked first) or for a tensor
    of the wrong dtype, shape or device."""
    dev = v0.device
    B, K = seg.valid.shape
    check_dp_kernel_limits(K, cfg)
    n_s, n_t = cfg.n_s, cfg.n_t
    if not v0.is_cuda or v0.dtype != torch.float32 or tuple(v0.shape) != (B,):
        raise ValueError(f"v0: need a float32 CUDA tensor of shape {(B,)}, got "
                         f"{v0.dtype} {tuple(v0.shape)} on {v0.device}")
    for name, a in zip(STSegments._fields, seg):
        if not a.is_cuda or tuple(a.shape) != (B, K):
            raise ValueError(f"seg.{name}: need a CUDA tensor of shape {(B, K)}")
    g = _grid(cfg, str(dev))
    seg_in = torch.stack(
        [seg.s_in, seg.s_out, seg.t_in, seg.t_out, seg.valid.to(torch.float32)], 1
    ).contiguous()                                                   # (B, 5, K)
    v0 = v0.contiguous()
    s_out = torch.empty((B, n_t), dtype=torch.float32, device=dev)
    valid = torch.empty((B, n_t), dtype=torch.bool, device=dev)
    end = torch.empty((B,), dtype=torch.int32, device=dev)
    ptrs = [seg_in, v0, g.s_grid, g.dv, g.ref_tr, g.v0e, g.ref0, s_out, valid, end]
    p_arr = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
    fparams, exact = _kernel_constants(cfg)
    f_arr = (ctypes.c_float * len(fparams))(*fparams)
    i_arr = (ctypes.c_int * 6)(B, K, n_s, n_t, cfg.n_edge_samples, int(exact))
    fn = cuda.function("speed_dp", "speed_dp", (ctypes.c_void_p,) * 4)
    err = fn(p_arr, f_arr, i_arr, cuda.stream_of(v0))
    cuda.check(err, "speed_dp")
    launches["speed_dp"] += 1
    return SpeedDPResult(s_out, g.t_grid.expand(B, n_t), valid, end)


def convex_space(dp: SpeedDPResult, seg: STSegments, path_s: Tensor,
                 path_kappa: Tensor, cfg: SpeedPlanConfig):
    """Bounds (s_lb, s_ub, s_dot_lb, s_dot_ub), each (B, n_t), for the speed
    QP: s_dot_ub from the lateral-acceleration limit at the DP stations; per
    segment the DP decision at its mid time either caps s_ub (yield) or
    raises s_lb (overtake) along its line over the buffered column window
    [t_lb - 2 (floor 3), t_ub + 2 (cap the DP end)]."""
    n_t = cfg.n_t
    B = dp.s.shape[0]
    dev = dp.s.device
    s_lb = torch.zeros((B, n_t), dtype=torch.float32, device=dev)
    s_ub = torch.full((B, n_t), BIG, dtype=torch.float32, device=dev)
    kappa_at = interp.interp(dp.s, path_s, path_kappa.abs())
    s_dot_ub = torch.sqrt(sdiv(cfg.max_lateral_accel, kappa_at + 1e-10))
    s_dot_ub = torch.where(dp.valid, s_dot_ub, BIG)
    s_dot_lb = torch.zeros((B, n_t), dtype=torch.float32, device=dev)

    obs_t = 0.5 * (seg.t_in + seg.t_out)                             # (B, K)
    obs_s = 0.5 * (seg.s_in + seg.s_out)
    span = seg.t_out - seg.t_in
    denom = torch.where(span.abs() < 1e-6, 1.0, span)
    obs_speed = (seg.s_out - seg.s_in) / denom
    s_end_val = torch.gather(dp.s, 1, dp.end_index[:, None].long())
    dp_s_clean = torch.where(dp.valid, dp.s, s_end_val)
    dp_s_full = torch.cat([torch.zeros_like(dp_s_clean[:, :1]), dp_s_clean], 1)
    w_obs = interp.uniform_hat(obs_t, 0.0, cfg.t_step, n_t + 1)      # (B, K, n_t+1)
    dp_s_at_obs = (w_obs * dp_s_full[:, None, :]).sum(-1)
    yield_to = obs_s > dp_s_at_obs                                   # (B, K)

    col = torch.arange(n_t, device=dev)
    t_lb_idx = (dp.t[:, None, :] <= seg.t_in[:, :, None]).sum(-1) - 1
    t_lb_idx = torch.clamp(t_lb_idx, 0, n_t - 1)
    t_ub_idx = (dp.t[:, None, :] <= seg.t_out[:, :, None]).sum(-1) - 1
    t_ub_idx = torch.clamp(t_ub_idx, 0, n_t - 1)
    t_lb_idx = torch.clamp(t_lb_idx - 2, min=3)
    t_ub_idx = torch.minimum(t_ub_idx + 2, dp.end_index[:, None].long())
    in_win = (
        (col >= t_lb_idx[:, :, None]) & (col <= t_ub_idx[:, :, None])
        & seg.valid[:, :, None]
    )                                                                # (B, K, n_t)
    line_s = seg.s_in[:, :, None] + obs_speed[:, :, None] * (
        dp.t[:, None, :] - seg.t_in[:, :, None]
    )
    ub_cand = torch.where(in_win & yield_to[:, :, None], line_s, BIG)
    lb_cand = torch.where(in_win & ~yield_to[:, :, None], line_s, -BIG)
    s_ub = torch.minimum(s_ub, ub_cand.min(dim=1).values)
    s_lb = torch.maximum(s_lb, lb_cand.max(dim=1).values)
    return s_lb, s_ub, s_dot_lb, s_dot_ub


def _speed_qp_constants(cfg: SpeedPlanConfig):
    """Constant P and A for the full-horizon speed QP (a verbatim copy)."""
    n = cfg.n_t + 1  # knots incl. the start
    nv = 3 * n
    dt = cfg.t_step

    P = np.zeros((nv, nv))
    for i in range(n):
        P[3 * i + 1, 3 * i + 1] += cfg.w_qp_v_ref
        P[3 * i + 2, 3 * i + 2] += cfg.w_qp_s_dot2
    for i in range(n - 1):
        a, b = 3 * i + 2, 3 * i + 5
        P[a, a] += cfg.w_qp_jerk
        P[b, b] += cfg.w_qp_jerk
        P[a, b] -= cfg.w_qp_jerk
        P[b, a] -= cfg.w_qp_jerk
    P *= 2.0

    # piecewise-jerk continuity (speed_planning_test.py:444-452)
    Aeq = np.zeros((2 * (n - 1), nv))
    for i in range(n - 1):
        Aeq[2 * i, 3 * i : 3 * i + 6] = [1, dt, dt**2 / 3, -1, 0, dt**2 / 6]
        Aeq[2 * i + 1, 3 * i : 3 * i + 6] = [0, 1, dt / 2, 0, -1, dt / 2]
    # no reverse: s_i - s_{i+1} <= 0 (speed_planning_test.py:455-461)
    A_mono = np.zeros((n - 1, nv))
    for i in range(n - 1):
        A_mono[i, 3 * i] = 1.0
        A_mono[i, 3 * i + 3] = -1.0
    # per-variable box rows (identity) — convex space, accel box, start pin
    A_box = np.eye(nv)
    A = np.concatenate([Aeq, A_mono, A_box])
    eq_mask = np.zeros(A.shape[0], bool)
    eq_mask[: 2 * (n - 1)] = True                    # continuity
    base = 2 * (n - 1) + (n - 1)
    eq_mask[base : base + 3] = True                  # start-state pin rows
    return P.astype(np.float32), A.astype(np.float32), eq_mask


@lru_cache(maxsize=None)
def _speed_solver(cfg: SpeedPlanConfig, warm: bool = True):
    """The solver of the speed-QP family: warm (launches counted as
    qp_admm_speed) or cold (qp_admm_cold_speed)."""
    P_np, A_np, eq_mask = _speed_qp_constants(cfg)
    n = cfg.n_t + 1
    q_typ = np.zeros(3 * n)
    q_typ[1::3] = -2.0 * cfg.w_qp_v_ref * cfg.reference_speed
    return qp.make_prefactored_qp(
        P_np, A_np, eq_mask, q_typical=q_typ,
        iters_per_phase=max(2 * cfg.admm_iters // 3, 60),
        warm=warm,
        warm_iters_per_phase=max(cfg.warm_admm_iters // 3, 1),
        name="qp_admm_speed" if warm else "qp_admm_cold_speed",
    )


def qp_dims(cfg: SpeedPlanConfig) -> tuple[int, int]:
    """(variables, constraint rows) of the speed QP: (51, 99) by default."""
    n = cfg.n_t + 1
    nv = 3 * n
    return nv, 2 * (n - 1) + (n - 1) + nv  # continuity + no-reverse + box


def warm_state_init(cfg: SpeedPlanConfig, batch: int, device="cpu"):
    """Zero ADMM state for the speed QP (seed for the first cycle)."""
    nv, m = qp_dims(cfg)
    return qp.warm_zero_state(nv, m, batch, device)


def _envelope(v0: Tensor, a0: Tensor, a_limit: float, cfg: SpeedPlanConfig):
    """Exact discrete reachable extreme of (s, v) over n_t steps under the
    QP's continuity model with a at ``a_limit`` (braking keeps v >= 0)."""
    dt = cfg.t_step
    s_i = torch.zeros_like(v0)
    v_i = torch.clamp(v0, min=0.0)
    a_i = a0
    s_env, v_env = [], []
    for _ in range(cfg.n_t):
        a_next = torch.full_like(v0, a_limit)
        if a_limit < 0.0:
            a_next = torch.maximum(a_next, tdiv(-2.0 * v_i, dt) - a_i)
        v_next = torch.clamp(v_i + dt * 0.5 * (a_i + a_next), min=0.0)
        s_next = s_i + dt * v_i + dt * dt / 3.0 * a_i + dt * dt / 6.0 * a_next
        s_i, v_i, a_i = s_next, v_next, a_next
        s_env.append(s_next)
        v_env.append(v_next)
    return torch.stack(s_env, 1), torch.stack(v_env, 1)


def speed_qp(plan_start_s_dot, plan_start_s_dot2, s_lb, s_ub, s_dot_lb,
             s_dot_ub, cfg: SpeedPlanConfig, warm_state=None):
    """Smooth s(t) inside the convex space, warm-started from the carried
    ADMM state, or cold from zero when ``warm_state`` is None. Plan start
    (B,), bounds (B, n_t). Returns (s, s_dot, s_dot2) each (B, n_t + 1),
    the knot times t (n_t + 1,) and the new state (None for a cold
    solve)."""
    q, l, u = speed_qp_problem(plan_start_s_dot, plan_start_s_dot2, s_lb, s_ub,
                               s_dot_lb, s_dot_ub, cfg)
    t = torch.arange(cfg.n_t + 1, dtype=torch.float32,
                     device=q.device) * cfg.t_step
    if warm_state is None:
        x, new_state = _speed_solver(cfg, warm=False)(q, l, u), None
    else:
        x, new_state = _speed_solver(cfg)(q, l, u, warm_state)
    return x[:, 0::3], x[:, 1::3], x[:, 2::3], t, new_state


def speed_qp_problem(plan_start_s_dot, plan_start_s_dot2, s_lb, s_ub, s_dot_lb,
                     s_dot_ub, cfg: SpeedPlanConfig):
    """The speed QP's per-lane vectors (q (B, n), l, u (B, m)). The caps are
    relaxed to the reachable max-braking envelope and the floors to the
    max-acceleration envelope, so the QP stays feasible."""
    n = cfg.n_t + 1
    nv = 3 * n
    B = plan_start_s_dot.shape[0]
    dev = plan_start_s_dot.device
    f32 = torch.float32
    margin = 1e-2

    s_min_env, v_min_env = _envelope(plan_start_s_dot, plan_start_s_dot2,
                                     cfg.accel_min, cfg)
    s_max_env, v_max_env = _envelope(plan_start_s_dot, plan_start_s_dot2,
                                     cfg.accel_max, cfg)
    s_ub = torch.maximum(s_ub, s_min_env + margin)
    s_dot_ub = torch.maximum(s_dot_ub, v_min_env + margin)
    s_lb = torch.minimum(s_lb, torch.clamp(s_max_env - margin, min=0.0))
    s_dot_lb = torch.minimum(s_dot_lb, torch.clamp(v_max_env - margin, min=0.0))

    q = torch.zeros((B, nv), dtype=f32, device=dev)
    q[:, 1::3] = -2.0 * cfg.w_qp_v_ref * cfg.reference_speed
    zero = torch.zeros((B, 1), dtype=f32, device=dev)
    lb = torch.stack([
        torch.cat([zero, s_lb], 1),
        torch.cat([plan_start_s_dot[:, None], s_dot_lb], 1),
        torch.cat([plan_start_s_dot2[:, None],
                   torch.full((B, n - 1), cfg.accel_min, dtype=f32, device=dev)], 1),
    ], 2).reshape(B, nv)
    ub = torch.stack([
        torch.cat([zero, s_ub], 1),
        torch.cat([plan_start_s_dot[:, None], s_dot_ub], 1),
        torch.cat([plan_start_s_dot2[:, None],
                   torch.full((B, n - 1), cfg.accel_max, dtype=f32, device=dev)], 1),
    ], 2).reshape(B, nv)
    n_eq, n_mono = 2 * (n - 1), n - 1
    l = torch.cat([torch.zeros((B, n_eq), dtype=f32, device=dev),
                   torch.full((B, n_mono), -BIG, dtype=f32, device=dev), lb], 1)
    u = torch.cat([torch.zeros((B, n_eq + n_mono), dtype=f32, device=dev), ub], 1)
    return q, l.contiguous(), u.contiguous()


@lru_cache(maxsize=None)
def _densify_constants(n_knots: int, cfg: SpeedPlanConfig, device: str):
    """Dense sample times tq (nd,) and the constant Hermite selectors
    (S, A_v, A_a, B_a, C_a), built in NumPy as the JAX package builds them,
    rounded to float32 and transposed to (n_knots, nd) on ``device``."""
    dt = cfg.t_step
    nd = cfg.n_dense
    tq = np.linspace(0.0, (n_knots - 1) * dt, nd).astype(np.float32)
    j = np.clip((tq / dt).astype(np.int32), 0, n_knots - 2)
    x = tq - j * dt
    S = np.zeros((nd, n_knots), np.float32)
    S[np.arange(nd), j] = 1.0
    S1 = np.zeros((nd, n_knots), np.float32)
    S1[np.arange(nd), j + 1] = 1.0
    D = (S1 - S) / dt  # jerk = D @ s_dot2
    A_v = x[:, None] * S
    A_a = (0.5 * x**2)[:, None] * S + (x**3 / 6.0)[:, None] * D
    B_a = x[:, None] * S + (0.5 * x**2)[:, None] * D
    C_a = S + x[:, None] * D
    mats = tuple(torch.as_tensor(np.asarray(a, np.float32).T.copy(), device=device)
                 for a in (S, A_v, A_a, B_a, C_a))
    return torch.as_tensor(tq, device=device), mats


def densify_speed(s, s_dot, s_dot2, t, cfg: SpeedPlanConfig):
    """Densify the QP knots (B, n_knots) to n_dense points by exact piecewise-
    constant-jerk interpolation: on the uniform knot grid the cubic is a
    constant Hermite-selector matmul. Returns (s, v, a) each (B, n_dense)
    and the dense times tq (n_dense,), the same for every lane."""
    require_fp32_matmul(s)
    tq, (S, A_v, A_a, B_a, C_a) = _densify_constants(s.shape[-1], cfg,
                                                     str(s.device))
    sel = s @ S
    v_sel = s_dot @ S
    s_d = sel + s_dot @ A_v + s_dot2 @ A_a
    v_d = v_sel + s_dot2 @ B_a
    a_d = s_dot2 @ C_a
    return s_d, v_d, a_d, tq
