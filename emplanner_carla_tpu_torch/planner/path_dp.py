"""S-L path dynamic programming on batch-first tensors (counterpart of
``emplanner_carla_tpu/planner/path_dp.py``).

Transition edges connect grid nodes with zero boundary derivatives, so
every edge's quintic is the smoothstep between its endpoint l values: the
(rows, rows, samples) geometry and the smoothness cost are constants
(:func:`_transition_geometry`, a verbatim NumPy copy). Per scenario the work
is the obstacle cost of every edge and a min-plus recursion over the
columns. Ties resolve to the first minimum, as in the reference.

The transition-edge obstacle costs dispatch on the device:
:func:`transition_obstacle_costs` launches ``csrc/path_obs.cu`` (the port
of ``ops/path_obs_pallas.py transition_obstacle_costs_batched``) for CUDA
tensors and runs :func:`_transition_obstacle_costs_torch` for CPU tensors.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from emplanner_carla_tpu_torch import cuda
from emplanner_carla_tpu_torch.config import PathPlanConfig
from emplanner_carla_tpu_torch.ops import quintic
from emplanner_carla_tpu_torch.types import Tensor, tdiv

launches = {"path_obs_costs": 0}


def grid_l_values(cfg: PathPlanConfig) -> np.ndarray:
    """Row index -> lateral offset l_i = ((rows+1)/2 - 1 - i) * sample_l
    (``path_planning.py:326``); row 0 is the far left (l > 0)."""
    i = np.arange(cfg.rows)
    return (((cfg.rows + 1) / 2 - 1) - i) * cfg.sample_l


def _smoothstep_samples(cfg: PathPlanConfig):
    """Constant sample tensors for the zero-derivative transition edges at
    u_k = k/10, k = 0..9 (``path_planning.py:492-493``)."""
    u = np.arange(cfg.n_edge_samples) / cfg.n_edge_samples
    S = 10 * u**3 - 15 * u**4 + 6 * u**5
    dS = 30 * u**2 - 60 * u**3 + 30 * u**4
    ddS = 60 * u - 180 * u**2 + 120 * u**3
    dddS = 60 - 360 * u + 360 * u**2
    return u, S, dS, ddS, dddS


def _transition_geometry(cfg: PathPlanConfig):
    """Constant (rows, rows, samples) l tensor for k -> i edges, the scalar
    smoothness + reference cost kernel (rows, rows), and the sample u."""
    l = grid_l_values(cfg)
    u, S, dS, ddS, dddS = _smoothstep_samples(cfg)
    h = cfg.sample_s
    dl_vals = l[None, :, None] - l[:, None, None]  # (k, i, 1): end - start
    l_s = l[:, None, None] + dl_vals * S[None, None, :]  # (k, i, m)
    dl_s = dl_vals * dS[None, None, :] / h
    ddl_s = dl_vals * ddS[None, None, :] / h**2
    dddl_s = dl_vals * dddS[None, None, :] / h**3
    smooth = (
        cfg.w_dl * np.sum(dl_s**2, -1)
        + cfg.w_ddl * np.sum(ddl_s**2, -1)
        + cfg.w_dddl * np.sum(dddl_s**2, -1)
    )  # (k, i)
    ref_cost = cfg.w_ref * np.sum(l_s**2, -1)  # (k, i)
    return l_s.astype(np.float32), (smooth + ref_cost).astype(np.float32), u


@lru_cache(maxsize=None)
def _geometry_on(cfg: PathPlanConfig, device: str):
    trans_l, trans_base, u = _transition_geometry(cfg)
    return (
        torch.as_tensor(trans_l, device=device),
        torch.as_tensor(trans_base, device=device),
        torch.as_tensor(u.astype(np.float32), device=device),
        torch.as_tensor(grid_l_values(cfg).astype(np.float32), device=device),
    )


@lru_cache(maxsize=None)
def _kernel_tables(cfg: PathPlanConfig, device: str):
    """The obstacle-cost kernel's constant inputs: the lateral table as
    (samples, rows*rows) and the sample offsets u*h (float32 products, as
    the plain version forms them)."""
    trans_l, _, u, _ = _geometry_on(cfg, device)
    rr = cfg.rows * cfg.rows
    tl = trans_l.reshape(rr, cfg.n_edge_samples).T.contiguous()
    return tl, (u * float(cfg.sample_s)).contiguous()


def _obs_cost(d2: Tensor, valid: Tensor, cfg: PathPlanConfig) -> Tensor:
    """Masked per-edge obstacle cost. d2: (..., samples, K); valid (B, K)
    broadcast. w_collision if any sample is inside danger_dist, plus the
    5000/d^2 band cost (``cal_obs_cost``, ``path_planning.py:588-609``)."""
    danger2 = cfg.danger_dist**2
    safe2 = cfg.safe_dist**2
    collide = (d2 <= danger2).any(dim=-2)
    band = (d2 > danger2) & (d2 < safe2)
    band_cost = torch.where(
        band, cfg.danger_cost_num / torch.clamp(d2, min=1e-6), 0.0
    ).sum(dim=-2)
    per_obs = torch.where(collide, cfg.w_collision, 0.0) + band_cost
    return torch.where(valid, per_obs, 0.0).sum(dim=-1)


def transition_obstacle_costs(obs_s, obs_l, obs_valid, plan_start_s,
                              cfg: PathPlanConfig) -> Tensor:
    """Obstacle cost of every transition edge, (B, cols-1, rows, rows):
    the kernel on CUDA, the plain version on the CPU."""
    if obs_s.is_cuda:
        return transition_obstacle_costs_kernel(
            obs_s, obs_l, obs_valid, plan_start_s, cfg
        )
    return _transition_obstacle_costs_torch(
        obs_s, obs_l, obs_valid, plan_start_s, cfg
    )


def _transition_obstacle_costs_torch(obs_s, obs_l, obs_valid, plan_start_s,
                                     cfg: PathPlanConfig) -> Tensor:
    """Plain PyTorch version, (B, cols-1, rows, rows).

    An obstacle can cost only the two consecutive transition edges whose
    samples come within safe_dist of it in s (n1 = floor((r+safe)/h) and
    n1-1, r relative to plan_start_s). Each (slot, candidate) evaluates the
    10 samples against the (rows x rows) lateral table; the band cost folds
    over the samples in ascending order and the scatter into columns folds
    slot-outer, candidate-inner: the accumulation order of the JAX package's
    XLA form and of the CUDA kernel. Every operation is a separately rounded
    IEEE float32 op, so on the card it equals the kernel bit for bit.
    """
    rows, cols, m = cfg.rows, cfg.cols, cfg.n_edge_samples
    h = float(cfg.sample_s)
    dev = obs_s.device
    trans_l, _, u, _ = _geometry_on(cfg, str(dev))
    span = h * (m - 1) / m
    assert 2 * cfg.safe_dist + span < 2 * h, (
        "sparse path-DP edge costs assume an obstacle reaches <= 2 edges"
    )
    B, K = obs_s.shape
    r = obs_s - plan_start_s[:, None]                        # (B, K)
    n1 = torch.floor(tdiv(r + cfg.safe_dist, h))
    cand_n = torch.stack([n1 - 1.0, n1], dim=1)              # (B, 2, K)
    n_lo = tdiv(r - cfg.safe_dist - span, h)
    cand_ok = (
        (cand_n >= 1.0)
        & (cand_n <= float(cols - 1))
        & (cand_n >= n_lo[:, None, :])
        & obs_valid[:, None, :]
    )                                                        # (B, 2, K)
    uh = u * h                                               # (m,) f32
    base = plan_start_s[:, None, None] + cand_n * h          # (B, 2, K)
    # lateral part (K, rows*rows, m) is edge-column invariant
    tl = trans_l.reshape(rows * rows, m)
    danger2 = float(cfg.danger_dist) ** 2
    safe2 = float(cfg.safe_dist) ** 2
    collide = torch.zeros((B, 2, K, rows * rows), dtype=torch.bool, device=dev)
    band_cost = torch.zeros((B, 2, K, rows * rows), dtype=torch.float32,
                            device=dev)
    num = torch.full((B, 2, K, rows * rows), float(cfg.danger_cost_num),
                     dtype=torch.float32, device=dev)
    for q in range(m):
        ds = obs_s[:, None, :] - (base + uh[q])              # (B, 2, K)
        ds2 = ds * ds
        dl = obs_l[:, :, None] - tl[None, None, :, q]        # (B, K, RR)
        dl2 = dl * dl
        d2q = ds2[..., None] + dl2[:, None]                  # (B, 2, K, RR)
        collide = collide | (d2q <= danger2)
        band_cost = band_cost + torch.where(
            (d2q > danger2) & (d2q < safe2),
            num / torch.clamp(d2q, min=1e-6),
            0.0,
        )
    per_obs = torch.where(collide, float(cfg.w_collision), 0.0) + band_cost
    # where (not multiply) so garbage/NaN in padded slots cannot poison the
    # scatter (0 * nan = nan)
    per_obs = torch.where(cand_ok[..., None], per_obs, 0.0)
    col_ids = torch.arange(cols - 1, dtype=torch.float32, device=dev)
    onehot = cand_ok[..., None] & (
        (cand_n[..., None] - 1.0) == col_ids
    )                                                        # (B, 2, K, cols-1)
    out = torch.zeros((B, cols - 1, rows * rows), dtype=torch.float32,
                      device=dev)
    for k in range(K):
        for c in range(2):
            out = out + torch.where(
                onehot[:, c, k, :, None], per_obs[:, c, k, None, :], 0.0
            )
    return out.reshape(B, cols - 1, rows, rows)


# transition columns (cfg.cols - 1) the path-DP obstacle-cost kernel holds
# (csrc/path_obs.cu)
OBS_COLS_MAX = 16


def transition_obstacle_costs_kernel(obs_s, obs_l, obs_valid, plan_start_s,
                                     cfg: PathPlanConfig) -> Tensor:
    """Launch ``csrc/path_obs.cu``: one thread per (lane, lateral edge).
    Raises ``ValueError`` past the kernel's column limit (checked first) or
    for a tensor of the wrong dtype, shape or device."""
    rows, cols, m = cfg.rows, cfg.cols, cfg.n_edge_samples
    if not 1 <= cols - 1 <= OBS_COLS_MAX:
        raise ValueError(f"the path-DP obstacle-cost kernel (csrc/path_obs.cu) holds "
                         f"1..{OBS_COLS_MAX} transition columns (cols - 1), got "
                         f"{cols - 1}")
    B, K = obs_s.shape
    for t, nm, dt in ((obs_s, "obs_s", torch.float32),
                      (obs_l, "obs_l", torch.float32),
                      (obs_valid, "obs_valid", torch.bool)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous() \
                or tuple(t.shape) != (B, K):
            raise ValueError(f"{nm}: need a contiguous {dt} CUDA tensor of "
                             f"shape {(B, K)}, got {t.dtype} {tuple(t.shape)}")
    if (not plan_start_s.is_cuda or plan_start_s.dtype != torch.float32
            or tuple(plan_start_s.shape) != (B,)
            or not plan_start_s.is_contiguous()):
        raise ValueError("plan_start_s: need a contiguous float32 (B,) CUDA tensor")
    tl, uh = _kernel_tables(cfg, str(obs_s.device))          # (m, RR), (m,)
    out = torch.empty((B, cols - 1, rows, rows), dtype=torch.float32,
                      device=obs_s.device)
    h = float(cfg.sample_s)
    span = h * (m - 1) / m
    fn = cuda.function("path_obs", "path_obs_costs", (ctypes.c_void_p,) * 7
                       + (ctypes.c_int,) * 5 + (ctypes.c_float,) * 7
                       + (ctypes.c_void_p,))
    err = fn(
        cuda.ptr(obs_s), cuda.ptr(obs_l), cuda.ptr(obs_valid),
        cuda.ptr(plan_start_s), cuda.ptr(tl), cuda.ptr(uh), cuda.ptr(out),
        B, K, rows * rows, cols - 1, m,
        h, span, float(cfg.safe_dist), float(cfg.danger_dist) ** 2,
        float(cfg.safe_dist) ** 2, float(cfg.danger_cost_num),
        float(cfg.w_collision),
        cuda.stream_of(obs_s),
    )
    cuda.check(err, "path_obs_costs")
    launches["path_obs_costs"] += 1
    return out


def path_dp(obs_s, obs_l, obs_valid, plan_start_s, plan_start_l,
            plan_start_dl, plan_start_ddl, cfg: PathPlanConfig):
    """S-L DP over the (rows x cols) lattice. Obstacles (B, K), plan start
    (B,). Returns (dp_s (B, cols), dp_l (B, cols), feasible (B,)); with no
    valid obstacle the result is the straight line l = 0."""
    rows, cols = cfg.rows, cfg.cols
    h = cfg.sample_s
    dev = obs_s.device
    _, trans_base, u, l_grid = _geometry_on(cfg, str(dev))

    # start edges: general quintic from the plan-start state, (B, rows, m)
    zeros_r = torch.zeros(rows, device=dev)
    coeff = quintic.hermite_coeffs(
        plan_start_l[:, None], plan_start_dl[:, None], plan_start_ddl[:, None],
        l_grid[None, :], zeros_r, zeros_r, h,
    )                                                        # (B, rows, 6)
    l0, dl0, ddl0, dddl0 = quintic.eval_with_derivs(
        coeff[:, :, None, :], u, h
    )
    start_smooth = (
        cfg.w_dl * (dl0 * dl0).sum(-1)
        + cfg.w_ddl * (ddl0 * ddl0).sum(-1)
        + cfg.w_dddl * (dddl0 * dddl0).sum(-1)
        + cfg.w_ref * (l0 * l0).sum(-1)
    )                                                        # (B, rows)

    s0_samples = plan_start_s[:, None] + u * h               # (B, m)
    dss = obs_s[:, None, None, :] - s0_samples[:, None, :, None]
    dll = obs_l[:, None, None, :] - l0[:, :, :, None]
    d2_start = dss * dss + dll * dll                         # (B, rows, m, K)
    start_obs = _obs_cost(d2_start, obs_valid[:, None, :], cfg)   # (B, rows)

    trans_obs = transition_obstacle_costs(
        obs_s, obs_l, obs_valid, plan_start_s, cfg
    )                                                        # (B, c-1, r, r)

    keep_right = torch.where(
        torch.arange(rows, device=dev) < (rows // 2),
        cfg.keep_right_penalty, 0.0,
    ).to(torch.float32)
    cost0 = start_smooth + start_obs + keep_right
    edge_costs = trans_base + trans_obs + keep_right

    # min-plus recursion over columns, first-min argmin
    cost = cost0
    args = []
    for j in range(cols - 1):
        total = cost[:, :, None] + edge_costs[:, j]          # (B, k, i)
        arg = torch.argmin(total, dim=1)
        cost = torch.gather(total, 1, arg[:, None, :])[:, 0]
        args.append(arg)

    end_row = torch.argmin(cost, dim=1)
    feasible = cost.min(dim=1).values <= cfg.w_collision
    col_rows = [end_row]
    row = end_row
    for arg in reversed(args):
        row = torch.gather(arg, 1, row[:, None])[:, 0]
        col_rows.append(row)
    col_rows = torch.stack(col_rows[::-1], dim=1)            # (B, cols)
    dp_l = l_grid[col_rows]
    any_obs = obs_valid.any(dim=1)
    dp_l = torch.where(any_obs[:, None], dp_l, 0.0)
    dp_s = plan_start_s[:, None] + (
        torch.arange(cols, dtype=torch.float32, device=dev) + 1.0
    ) * h
    return dp_s, dp_l, feasible | ~any_obs


def enriched_length(cfg: PathPlanConfig) -> int:
    """Number of densified samples: cols x ceil(sample_s/res) + 1."""
    per_seg = int(np.ceil(cfg.sample_s / cfg.sampling_res))
    return cfg.cols * per_seg + 1


def enrich_dp(dp_s, dp_l, plan_start_s, plan_start_l, plan_start_dl,
              plan_start_ddl, cfg: PathPlanConfig):
    """Densify the DP polyline on its quintic segments (``enrich_DP_s_l``).
    Segment 0 starts at the plan start with its true derivatives; the others
    join DP nodes with zero-derivative knots. Returns (s, l), each
    (B, enriched_length(cfg))."""
    per_seg = int(np.ceil(cfg.sample_s / cfg.sampling_res))
    h = cfg.sample_s
    dev = dp_s.device
    u = torch.arange(per_seg, dtype=torch.float32, device=dev) \
        * cfg.sampling_res / h

    seg_start_l = torch.cat([plan_start_l[:, None], dp_l[:, :-1]], 1)
    seg_end_l = dp_l
    seg_start_s = torch.cat([plan_start_s[:, None], dp_s[:, :-1]], 1)

    zeros = torch.zeros_like(dp_l)
    start_dl = torch.cat([plan_start_dl[:, None], zeros[:, : cfg.cols - 1]], 1)
    start_ddl = torch.cat([plan_start_ddl[:, None], zeros[:, : cfg.cols - 1]], 1)
    coeff = quintic.hermite_coeffs(
        seg_start_l, start_dl, start_ddl, seg_end_l, zeros, zeros, h
    )                                                        # (B, cols, 6)
    l_seg = quintic.eval_poly(coeff[:, :, None, :], u)       # (B, cols, per_seg)
    s_seg = seg_start_s[:, :, None] + u * h

    B = dp_s.shape[0]
    s = torch.cat([s_seg.reshape(B, -1), dp_s[:, -1:]], 1)
    l = torch.cat([l_seg.reshape(B, -1), dp_l[:, -1:]], 1)
    return s, l
