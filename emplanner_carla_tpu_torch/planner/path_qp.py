"""Convex corridor + piecewise-jerk path QP (counterpart of
``emplanner_carla_tpu/planner/path_qp.py``).

The constant matrices are built once in NumPy (:func:`_qp_constants`, a
verbatim copy); per cycle the work is one batched ADMM solve, warm from the
carried state in the closed loops or cold in the open-loop plan, which runs
the CUDA kernel ``csrc/qp_admm.cu`` for CUDA tensors (see ``ops/qp.py``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from emplanner_carla_tpu_torch.config import PathPlanConfig
from emplanner_carla_tpu_torch.ops import qp
from emplanner_carla_tpu_torch.types import Tensor

BIG = 1e8  # stand-in for the reference's +-1e5 free bounds (path_planning.py:145)


def corridor(dp_s, dp_l, obs_s, obs_l, obs_valid, cfg: PathPlanConfig):
    """l bounds per DP station (``cal_lmin_lmax``). Stations (B, n),
    obstacles (B, K). The stations covering [obs_s - L/2, obs_s + L/2]
    (extended by the index offset on the exit side) are clamped on the side
    opposite the DP decision. Returns (l_min, l_max), each (B, n)."""
    n = dp_s.shape[-1]
    off = cfg.corridor_index_offset
    idx_min = torch.argmin(
        (dp_s[:, None, :] - (obs_s - cfg.obs_length / 2)[:, :, None]).abs(), dim=-1
    )                                                        # (B, K)
    idx_max = torch.argmin(
        (dp_s[:, None, :] - (obs_s + cfg.obs_length / 2)[:, :, None]).abs(), dim=-1
    ) + off
    idx_ctr = torch.argmin((dp_s[:, None, :] - obs_s[:, :, None]).abs(), dim=-1)
    path_l_at_obs = torch.gather(dp_l, 1, idx_ctr)
    pass_low = path_l_at_obs < obs_l                         # pass on the smaller-l side

    station = torch.arange(n, device=dp_s.device)
    in_range = (
        (station >= idx_min[:, :, None])
        & (station <= idx_max[:, :, None])
        & obs_valid[:, :, None]
    )                                                        # (B, K, n)
    ub_cand = torch.where(
        in_range & pass_low[:, :, None], (obs_l - cfg.obs_width / 2)[:, :, None], BIG
    )
    lb_cand = torch.where(
        in_range & ~pass_low[:, :, None], (obs_l + cfg.obs_width / 2)[:, :, None], -BIG
    )
    l_max = torch.clamp(ub_cand.min(dim=1).values, max=cfg.corridor_halfwidth)
    l_min = torch.clamp(lb_cand.max(dim=1).values, min=-cfg.corridor_halfwidth)
    return l_min, l_max


def _qp_constants(n: int, ds: float, cfg: PathPlanConfig):
    """Constant P and A for the piecewise-jerk QP with soft corridor rows.

    Variables: x = [l, dl, ddl] x n stations followed by n corridor slacks.
    Returns (P, A, eq_mask, front_index, back_index).
    """
    nv = 3 * n

    P = np.zeros((nv, nv))
    for i in range(n):
        P[3 * i, 3 * i] += cfg.w_qp_l + cfg.w_qp_centre
        P[3 * i + 1, 3 * i + 1] += cfg.w_qp_dl
        P[3 * i + 2, 3 * i + 2] += cfg.w_qp_ddl
    for i in range(n - 1):
        a, b = 3 * i + 2, 3 * i + 5
        P[a, a] += cfg.w_qp_dddl
        P[b, b] += cfg.w_qp_dddl
        P[a, b] -= cfg.w_qp_dddl
        P[b, a] -= cfg.w_qp_dddl
    P[3 * n - 3, 3 * n - 3] += cfg.w_qp_end_l
    P[3 * n - 2, 3 * n - 2] += cfg.w_qp_end_dl
    P[3 * n - 1, 3 * n - 1] += cfg.w_qp_end_ddl
    P = 2.0 * P

    Aeq = np.zeros((2 * (n - 1), nv))
    for i in range(n - 1):
        Aeq[2 * i, 3 * i : 3 * i + 6] = [1, ds, ds**2 / 3, -1, 0, ds**2 / 6]
        Aeq[2 * i + 1, 3 * i : 3 * i + 6] = [0, 1, ds / 2, 0, -1, ds / 2]

    n_total = nv + n

    def widen(M):
        out = np.zeros((M.shape[0], n_total))
        out[:, :nv] = M
        return out

    P = widen(widen(P).T)
    for i in range(n):
        P[nv + i, nv + i] = 2.0 * cfg.w_slack
    Aeq = widen(Aeq)

    d1, d2 = cfg.host_d1, cfg.host_d2
    A_in = np.zeros((4 * n, n_total))
    A_sub = np.array(
        [
            [1, d1, 0],
            [1, -d2, 0],
            [-1, -d1, 0],
            [-1, d2, 0],
        ]
    )
    for i in range(n):
        A_in[4 * i : 4 * i + 4, 3 * i : 3 * i + 3] = A_sub
        A_in[4 * i : 4 * i + 4, nv + i] = -1.0

    A_pin = np.zeros((6, n_total))
    for k in range(3):
        A_pin[k, k] = 1.0
        A_pin[3 + k, nv - 3 + k] = 1.0

    A_sl = np.zeros((n, n_total))
    for i in range(n):
        A_sl[i, nv + i] = 1.0

    A = np.concatenate([Aeq, A_in, A_pin, A_sl])
    eq_mask = np.zeros(A.shape[0], bool)
    eq_mask[: 2 * (n - 1)] = True
    eq_mask[2 * (n - 1) + 4 * n : 2 * (n - 1) + 4 * n + 6] = True
    front_index = int(np.ceil(d1 / ds))
    back_index = int(np.ceil(d2 / ds))
    return (
        P.astype(np.float32),
        A.astype(np.float32),
        eq_mask,
        front_index,
        back_index,
    )


@lru_cache(maxsize=None)
def _solver_for(n: int, ds: float, cfg: PathPlanConfig, warm: bool = True):
    """Prefactored solver for this (n, ds, cfg) family: warm (launches
    counted as qp_admm_warm) or cold (qp_admm_cold_path)."""
    P_np, A_np, eq_mask, front_index, back_index = _qp_constants(n, ds, cfg)
    q_typ = np.zeros(3 * n + n)
    q_typ[0 : 3 * n : 3] = -2.0 * cfg.w_qp_centre * 2.0  # centre offsets ~ 2 m
    solve = qp.make_prefactored_qp(
        P_np, A_np, eq_mask, q_typical=q_typ,
        iters_per_phase=max(2 * cfg.admm_iters // 3, 60),
        warm=warm,
        warm_iters_per_phase=max(cfg.warm_admm_iters // 3, 1),
        name="qp_admm_warm" if warm else "qp_admm_cold_path",
    )
    return solve, front_index, back_index


def qp_dims(n: int) -> tuple[int, int]:
    """(variables, constraint rows) of the n-station path QP."""
    return 4 * n, 2 * (n - 1) + 4 * n + 6 + n


def warm_state_init(n: int, batch: int, device="cpu"):
    """Zero ADMM state for the n-station path QP."""
    n_var, m = qp_dims(n)
    return qp.warm_zero_state(n_var, m, batch, device)


def path_qp(l_min, l_max, plan_start_l, plan_start_dl, plan_start_ddl,
            cfg: PathPlanConfig, ds: float, warm_state=None):
    """Smooth l(s) inside the corridor (``Quadratic_planning``), warm-started
    from the carried ADMM state, or cold from zero when ``warm_state`` is
    None. l_min/l_max (B, n); plan start (B,). Returns (l, dl, ddl) each
    (B, n) and the new state (None for a cold solve)."""
    B, n = l_min.shape
    dev = l_min.device
    warm = warm_state is not None
    solve, front_index, back_index = _solver_for(n, ds, cfg, warm)
    nv = 3 * n

    centre = 0.5 * (l_min + l_max)
    q = torch.zeros((B, nv + n), dtype=torch.float32, device=dev)
    q[:, 0:nv:3] = -2.0 * cfg.w_qp_centre * centre

    i = torch.arange(n, device=dev)
    i_front = torch.clamp(i + front_index, max=n - 1)
    i_back = torch.clamp(i - back_index, min=0)
    hw = cfg.host_w / 2
    ub_f = l_max[:, i_front] - hw
    lb_b = -l_min[:, i_back] - hw
    b_sub = torch.stack([ub_f, ub_f, lb_b, lb_b], dim=-1).reshape(B, 4 * n)

    start = torch.stack([plan_start_l, plan_start_dl, plan_start_ddl], dim=1)
    end = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    zc = torch.zeros((B, 2 * (n - 1)), dtype=torch.float32, device=dev)
    u = torch.cat([zc, b_sub, start, end,
                   torch.full((B, n), BIG, dtype=torch.float32, device=dev)], 1)
    l = torch.cat([zc, torch.full((B, 4 * n), -BIG, dtype=torch.float32, device=dev),
                   start, end, torch.zeros((B, n), dtype=torch.float32, device=dev)], 1)

    if warm:
        x, new_state = solve(q, l.contiguous(), u.contiguous(), warm_state)
    else:
        x, new_state = solve(q, l.contiguous(), u.contiguous()), None
    return x[:, 0:nv:3], x[:, 1:nv:3], x[:, 2:nv:3], new_state
