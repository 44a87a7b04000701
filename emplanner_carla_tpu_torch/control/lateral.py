"""Lateral control: LQR (+feedforward) and the condensed MPC (counterpart
of ``emplanner_carla_tpu/control/lateral.py``).

The gain K(Vx) depends on one scalar, so the discrete Riccati equation is
solved once on a dense Vx grid in float64 NumPy (:func:`lqr_gain_table`, a
verbatim copy) and a control tick lerps the table. The condensed MPC is
table-driven the same way: :func:`mpc_tables` and :func:`_ustar_tables`
(verbatim copies) hold every Vx-dependent matrix, and a tick lerps them,
forms the unconstrained optimum u* = W1 e + kappa w2, and runs the box ADMM
only where u* leaves the box. :func:`mpc_steer_exact` builds the condensed
QP per tick, the check of the table path.

The lerps, u*, f and the ADMM are written as explicit sums in one order,
and every division is an IEEE quotient (``types.tdiv``): the tick kernel
``csrc/tick_lqr.cu`` computes the same expressions term for term.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from emplanner_carla_tpu_torch.config import ControlConfig, VehicleParams
from emplanner_carla_tpu_torch.ops import qp
from emplanner_carla_tpu_torch.precision import require_fp32_matmul
from emplanner_carla_tpu_torch.types import EgoState, Path, Tensor, sdiv, tdiv

MPC_RHO = 1.0


def safe_vx(s: EgoState, cfg: ControlConfig) -> Tensor:
    """Vx clamped away from the model singularity (``controller.py:103-109``)."""
    return torch.where(
        s.vx < 0, torch.clamp(s.vx, max=-cfg.min_vx),
        torch.clamp(s.vx, min=cfg.min_vx),
    )


def tracking_error(s: EgoState, target: Path, cfg: ControlConfig):
    """Predicted-pose tracking error e = (e_d, e_d', e_phi, e_phi') (each
    (B,)), the projection curvature and the match index
    (``controller.py:488-567``): full first-minimum argmin over the path.
    ``cfg.raw_heading_error`` takes e_phi = phi - theta_r (the feedforward
    variant, ``controller.py:891``), else sin(phi - theta_r)."""
    vx = safe_vx(s, cfg)
    ts = cfg.ts_predict
    cphi, sphi = torch.cos(s.phi), torch.sin(s.phi)
    x = s.x + (vx * cphi - s.vy * sphi) * ts
    y = s.y + (s.vy * cphi + vx * sphi) * ts
    phi = s.phi + s.omega * ts

    ddx = target.x - x[:, None]
    ddy = target.y - y[:, None]
    idx = torch.argmin(ddx * ddx + ddy * ddy, dim=1, keepdim=True)
    xm = torch.gather(target.x, 1, idx)[:, 0]
    ym = torch.gather(target.y, 1, idx)[:, 0]
    thm = torch.gather(target.theta, 1, idx)[:, 0]
    kappa = torch.gather(target.kappa, 1, idx)[:, 0]
    tx, ty = torch.cos(thm), torch.sin(thm)
    nx, ny = -ty, tx
    dx, dy = x - xm, y - ym
    e_d = nx * dx + ny * dy
    e_s = tx * dx + ty * dy
    theta_r = thm + kappa * e_s
    dph = phi - theta_r
    cd, sd = torch.cos(dph), torch.sin(dph)
    e_d_dot = s.vy * cd + vx * sd
    e_phi = dph if cfg.raw_heading_error else sd
    s_dot = (vx * cd - s.vy * sd) / (1.0 - kappa * e_d)
    e_phi_dot = s.omega - kappa * s_dot
    return (e_d, e_d_dot, e_phi, e_phi_dot), kappa, idx[:, 0].to(torch.int32)


def lqr_feedforward(k3: Tensor, kappa: Tensor, vx: Tensor,
                    vp: VehicleParams) -> Tensor:
    """delta_f = kappa (a + b - b K3 - (b/Cf + a K3/Cr - a/Cr) m Vx^2/(a+b))
    (``controller.py:569-583``; no spurious pi/180). ``k3`` is K[0, 2]."""
    a, b, cf, cr, m = vp.a, vp.b, vp.cf, vp.cr, vp.mass
    return kappa * (
        a + b - b * k3
        - tdiv((b / cf + tdiv(a * k3, cr) - a / cr) * (m * vx * vx), a + b)
    )


@lru_cache(maxsize=None)
def lqr_gain_table(vp: VehicleParams, cfg: ControlConfig, n: int = 128,
                   v_max: float = 30.0):
    """K(Vx) lookup table from the float64 DARE on a Vx grid.
    Returns (vx_grid (n,), K_table (n, 4)) as float32 NumPy."""
    vx_grid = np.linspace(cfg.min_vx, v_max, n)
    Q = np.diag(cfg.lqr_q).astype(np.float64)
    R = np.array([[cfg.lqr_r]], np.float64)
    a, b, cf, cr, m, iz = vp.a, vp.b, vp.cf, vp.cr, vp.mass, vp.iz
    Ks = np.zeros((n, 4))
    for i, vx in enumerate(vx_grid):
        A = np.zeros((4, 4))
        A[0, 1] = 1.0
        A[1, 1] = (cf + cr) / (m * vx)
        A[1, 2] = -(cf + cr) / m
        A[1, 3] = (a * cf - b * cr) / (m * vx)
        A[2, 3] = 1.0
        A[3, 1] = (a * cf - b * cr) / (iz * vx)
        A[3, 2] = -(a * cf - b * cr) / iz
        A[3, 3] = (a * a * cf + b * b * cr) / (iz * vx)
        B = np.zeros((4, 1))
        B[1, 0] = -cf / m
        B[3, 0] = -a * cf / iz
        ts = cfg.ts_discretize
        T = np.linalg.inv(np.eye(4) - 0.5 * ts * A)
        Ad = T @ (np.eye(4) + 0.5 * ts * A)
        Bd = T @ B * ts
        P = Q.copy()
        for _ in range(cfg.riccati_iters * 4):
            P_new = (
                Ad.T @ P @ Ad
                - (Ad.T @ P @ Bd)
                @ np.linalg.inv(R + Bd.T @ P @ Bd)
                @ (Bd.T @ P @ Ad)
                + Q
            )
            if np.abs(P_new - P).max() < 1e-9:
                P = P_new
                break
            P = P_new
        Ks[i] = (np.linalg.inv(Bd.T @ P @ Bd + R) @ (Bd.T @ P @ Ad))[0]
    return vx_grid.astype(np.float32), Ks.astype(np.float32)


@lru_cache(maxsize=None)
def gain_table_on(vp: VehicleParams, cfg: ControlConfig, device: str):
    vx_grid, K = lqr_gain_table(vp, cfg)
    return (float(vx_grid[0]), float(vx_grid[1] - vx_grid[0]),
            torch.as_tensor(K, device=device))


def _lerp_weights(vx: Tensor, v0: float, dv: float, n: int):
    """Row i0 (B,) and weight w (B,) of the uniform grid v0 + i*dv at vx."""
    pos = torch.clamp(tdiv(vx - v0, dv), 0.0, n - 1.0)
    i0 = torch.clamp(pos.to(torch.int64), 0, n - 2)
    return i0, pos - i0.to(pos.dtype)


def _lerp(table: Tensor, i0: Tensor, w: Tensor) -> Tensor:
    """table (n, ...) at rows i0 (B,) with weights w (B,) -> (B, ...)."""
    w = w.reshape(w.shape + (1,) * (table.dim() - 1))
    return table[i0] * (1.0 - w) + table[i0 + 1] * w


def lqr_steer(s: EgoState, target: Path, vp: VehicleParams, cfg: ControlConfig):
    """One LQR lateral step -> (normalized steer (B,), match index)."""
    require_fp32_matmul(s.x)
    vx = safe_vx(s, cfg)
    v0, dv, table = gain_table_on(vp, cfg, str(s.x.device))
    K = _lerp(table, *_lerp_weights(vx, v0, dv, table.shape[0]))  # (B, 4)
    (e0, e1, e2, e3), kappa, idx = tracking_error(s, target, cfg)
    ke = K[:, 0] * e0 + K[:, 1] * e1 + K[:, 2] * e2 + K[:, 3] * e3
    delta = -ke + lqr_feedforward(K[:, 2], kappa, vx, vp)
    steer = torch.clamp(tdiv(delta, vp.max_steer_rad), -cfg.steer_limit,
                        cfg.steer_limit)
    return steer, idx


@lru_cache(maxsize=None)
def mpc_tables(vp: VehicleParams, cfg: ControlConfig, n: int = 64,
               v_max: float = 30.0, rho: float = 1.0):
    """Trace-time MPC condensed-matrix tables over a Vx grid: H = C'Q_bar C
    + R_bar, the error map G1 = C'Q_bar M and the feedforward map g2 =
    C'Q_bar Cc_unit (Cc at kappa = 1) depend on Vx alone.

    Returns NumPy: (vx_grid (n,), Minv (n,u,u) = inv(2H + rho I),
    G1 (n,u,4), g2 (n,u), Hinv2 (n,u,u) = inv(2H)) with u = mpc_n * mpc_p."""
    N, P_w, nx = cfg.mpc_n, cfg.mpc_p, 4
    nu = N * P_w
    a, b, cf, cr, m, iz = vp.a, vp.b, vp.cf, vp.cr, vp.mass, vp.iz
    ts = cfg.ts_discretize
    Q = np.diag(cfg.mpc_q)
    F = np.diag(cfg.mpc_f)
    Qbar = np.zeros(((N + 1) * nx, (N + 1) * nx))
    for i in range(N):
        Qbar[i * nx : (i + 1) * nx, i * nx : (i + 1) * nx] = Q
    Qbar[N * nx :, N * nx :] = F
    Rbar = np.eye(nu) * cfg.mpc_r

    vx_grid = np.linspace(cfg.min_vx, v_max, n)
    Minv_t = np.zeros((n, nu, nu))
    G1_t = np.zeros((n, nu, nx))
    g2_t = np.zeros((n, nu))
    Hinv2_t = np.zeros((n, nu, nu))
    for gi, vx in enumerate(vx_grid):
        A = np.zeros((4, 4))
        A[0, 1] = 1.0
        A[1, 1] = (cf + cr) / (m * vx)
        A[1, 2] = -(cf + cr) / m
        A[1, 3] = (a * cf - b * cr) / (m * vx)
        A[2, 3] = 1.0
        A[3, 1] = (a * cf - b * cr) / (iz * vx)
        A[3, 2] = -(a * cf - b * cr) / iz
        A[3, 3] = (a * a * cf + b * b * cr) / (iz * vx)
        B = np.zeros((4, 1))
        B[1, 0] = -cf / m
        B[3, 0] = -a * cf / iz
        Cv = np.zeros((4, 1))
        Cv[1, 0] = (a * cf + b * cr) / (m * vx) - vx
        Cv[3, 0] = (a * a * cf + b * b * cr) / (iz * vx)
        T = np.linalg.inv(np.eye(4) - 0.5 * ts * A)
        Ad = T @ (np.eye(4) + 0.5 * ts * A)
        Bd = T @ B * ts
        Cd_unit = T @ Cv * ts * vx  # kappa = 1

        M = np.zeros(((N + 1) * nx, nx))
        M[0:nx] = np.eye(nx)
        for i in range(1, N + 1):
            M[i * nx : (i + 1) * nx] = Ad @ M[(i - 1) * nx : i * nx]
        Cc = np.zeros(((N + 1) * nx, 1))
        for i in range(1, N + 1):
            Cc[i * nx : (i + 1) * nx] = Ad @ Cc[(i - 1) * nx : i * nx] + Cd_unit
        Bp = np.tile(Bd, (1, P_w))
        Cmat = np.zeros(((N + 1) * nx, nu))
        pow_rows = [Bp]
        for _ in range(N - 1):
            pow_rows.append(Ad @ pow_rows[-1])
        for i in range(1, N + 1):
            for j in range(i):
                Cmat[i * nx : (i + 1) * nx, j * P_w : (j + 1) * P_w] = pow_rows[
                    i - 1 - j
                ]
        H = Cmat.T @ Qbar @ Cmat + Rbar
        Minv_t[gi] = np.linalg.inv(2.0 * H + rho * np.eye(nu))
        G1_t[gi] = Cmat.T @ Qbar @ M
        g2_t[gi] = (Cmat.T @ Qbar @ Cc)[:, 0]
        Hinv2_t[gi] = np.linalg.inv(2.0 * H)
    return (
        vx_grid.astype(np.float32),
        Minv_t.astype(np.float32),
        G1_t.astype(np.float32),
        g2_t.astype(np.float32),
        Hinv2_t.astype(np.float32),
    )


@lru_cache(maxsize=None)
def _ustar_tables(vp: VehicleParams, cfg: ControlConfig, rho: float = 1.0):
    """The unconstrained optimum folded into the error and curvature maps:
    u* = -inv(2H) f = W1 @ e + kappa * w2 with W1 = -2 inv(2H) G1 (n,u,4)
    and w2 = -2 inv(2H) g2 (n,u)."""
    _, _, G1_np, g2_np, Hinv2_np = mpc_tables(vp, cfg, rho=rho)
    W1 = -2.0 * np.einsum("nij,njk->nik", Hinv2_np, G1_np)
    w2 = -2.0 * np.einsum("nij,nj->ni", Hinv2_np, g2_np)
    return W1.astype(np.float32), w2.astype(np.float32)


def mpc_kernel_table(vp: VehicleParams, cfg: ControlConfig) -> np.ndarray:
    """The MPC tables as the tick kernel reads them: one float32 row per grid
    point, [Minv (nu*nu) | G1 (nu*4) | g2 (nu) | W1 (nu*4) | w2 (nu)]."""
    _, Minv, G1, g2, _ = mpc_tables(vp, cfg, rho=MPC_RHO)
    W1, w2 = _ustar_tables(vp, cfg, rho=MPC_RHO)
    n = Minv.shape[0]
    return np.ascontiguousarray(np.concatenate(
        [Minv.reshape(n, -1), G1.reshape(n, -1), g2, W1.reshape(n, -1), w2], 1
    ), np.float32)


@lru_cache(maxsize=None)
def mpc_tables_on(vp: VehicleParams, cfg: ControlConfig, device: str):
    """(v0, dv, dict of the lerped tables Minv, G1, g2, W1, w2 and the
    kernel's packed table) on ``device``."""
    vx_grid, Minv, G1, g2, _ = mpc_tables(vp, cfg, rho=MPC_RHO)
    W1, w2 = _ustar_tables(vp, cfg, rho=MPC_RHO)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    tabs = dict(Minv=t(Minv), G1=t(G1), g2=t(g2), W1=t(W1), w2=t(w2),
                packed=t(mpc_kernel_table(vp, cfg)))
    return float(vx_grid[0]), float(vx_grid[1] - vx_grid[0]), tabs


def _map_e(T: Tensor, e, kappa: Tensor, t2: Tensor) -> Tensor:
    """T (B, nu, 4) e + kappa t2 (B, nu), summed left to right."""
    acc = T[:, :, 0] * e[0][:, None]
    for k in range(1, 4):
        acc = acc + T[:, :, k] * e[k][:, None]
    return acc + kappa[:, None] * t2


def mpc_admm(Minv: Tensor, f: Tensor, z: Tensor, u_d: Tensor, iters: int):
    """``iters`` box-ADMM steps x = Minv (rho (z - u_d) - f),
    z = clip(x + u_d, -1, 1), u_d += x - z from (z, u_d); the products summed
    left to right over the columns of Minv (B, nu, nu). Returns (z, u_d)."""
    nu = f.shape[1]
    for _ in range(iters):
        v = MPC_RHO * (z - u_d) - f
        x = Minv[:, :, 0] * v[:, 0:1]
        for j in range(1, nu):
            x = x + Minv[:, :, j] * v[:, j:j + 1]
        z_new = torch.clamp(x + u_d, -1.0, 1.0)
        u_d = u_d + x - z_new
        z = z_new
    return z, u_d


def mpc_steer_table(s, target, vp, cfg, warm, iters):
    """Table-driven MPC tick -> (steer, idx, (z, u_d), ran (B,) bool, the
    lanes whose u* left the box and ran ``iters`` box-ADMM steps). ``warm``
    is (z, u_d) of (B, nu), or None for zeros."""
    require_fp32_matmul(s.x)
    vx = safe_vx(s, cfg)
    e, kappa, idx = tracking_error(s, target, cfg)
    v0, dv, tb = mpc_tables_on(vp, cfg, str(s.x.device))
    i0, w = _lerp_weights(vx, v0, dv, tb["g2"].shape[0])
    # unconstrained fast path: exact whenever box-interior
    ustar = _map_e(_lerp(tb["W1"], i0, w), e, kappa, _lerp(tb["w2"], i0, w))
    interior = (ustar.abs() <= 1.0).all(1)
    if warm is None:
        z = torch.zeros_like(ustar)
        u_d = torch.zeros_like(ustar)
    else:
        z, u_d = warm
    ran = ~interior
    if bool(ran.any()):
        # the JAX package runs the ADMM for every lane and keeps it where
        # u* leaves the box; interior lanes' results are discarded either way
        f = 2.0 * _map_e(_lerp(tb["G1"], i0, w), e, kappa, _lerp(tb["g2"], i0, w))
        z, u_d = mpc_admm(_lerp(tb["Minv"], i0, w), f, z, u_d, iters)
    steer = torch.where(interior, ustar[:, 0], z[:, 0])
    steer = torch.clamp(steer, -cfg.steer_limit, cfg.steer_limit)
    # next tick's warm state: at an interior optimum the ADMM fixed point is
    # x = z = u*, u_d = 0
    warm_z = torch.where(interior[:, None], ustar, z)
    warm_ud = torch.where(interior[:, None], torch.zeros_like(u_d), u_d)
    return steer, idx, (warm_z, warm_ud), ran


def mpc_steer(s: EgoState, target: Path, vp: VehicleParams, cfg: ControlConfig):
    """One cold-started MPC lateral step (``cfg.mpc_admm_iters`` from
    zeros) -> (steer, idx)."""
    steer, idx, _, _ = mpc_steer_table(s, target, vp, cfg, None,
                                        cfg.mpc_admm_iters)
    return steer, idx


def mpc_steer_warm(s: EgoState, target: Path, vp: VehicleParams,
                   cfg: ControlConfig, warm):
    """Warm-started MPC step -> (steer, idx, (z, u_d)): ``warm`` is the
    previous tick's ADMM state (zeros at a cycle's first tick), and
    ``cfg.mpc_warm_admm_iters`` replace the cold count."""
    steer, idx, state, _ = mpc_steer_table(s, target, vp, cfg, warm,
                                            cfg.mpc_warm_admm_iters)
    return steer, idx, state


def error_state_model(vx: Tensor, vp: VehicleParams):
    """Continuous A (B, 4, 4), B (4, 1), C (B, 4, 1) of the error dynamics
    (``controller.py:115-149``)."""
    a, b, cf, cr, m, iz = vp.a, vp.b, vp.cf, vp.cr, vp.mass, vp.iz
    Bn = vx.shape[0]
    A = torch.zeros((Bn, 4, 4), dtype=vx.dtype, device=vx.device)
    A[:, 0, 1] = 1.0
    A[:, 1, 1] = sdiv(cf + cr, m * vx)
    A[:, 1, 2] = -(cf + cr) / m
    A[:, 1, 3] = sdiv(a * cf - b * cr, m * vx)
    A[:, 2, 3] = 1.0
    A[:, 3, 1] = sdiv(a * cf - b * cr, iz * vx)
    A[:, 3, 2] = -(a * cf - b * cr) / iz
    A[:, 3, 3] = sdiv(a * a * cf + b * b * cr, iz * vx)
    B = torch.zeros((4, 1), dtype=vx.dtype, device=vx.device)
    B[1, 0] = -cf / m
    B[3, 0] = -a * cf / iz
    C = torch.zeros((Bn, 4, 1), dtype=vx.dtype, device=vx.device)
    C[:, 1, 0] = sdiv(a * cf + b * cr, m * vx) - vx
    C[:, 3, 0] = sdiv(a * a * cf + b * b * cr, iz * vx)
    return A, B, C


def discretize(A: Tensor, B: Tensor, ts: float):
    """Bilinear (Tustin) discretization (``controller.py:160-164``): A
    (..., 4, 4), B (..., 4, 1) -> (A_d, B_d, T)."""
    require_fp32_matmul(A)
    eye = torch.eye(4, dtype=A.dtype, device=A.device)
    T = torch.linalg.inv(eye - 0.5 * ts * A)
    return T @ (eye + 0.5 * ts * A), T @ B * ts, T


def riccati_gain(A_d: Tensor, B_d: Tensor, Q: Tensor, R: Tensor, iters: int) -> Tensor:
    """K (..., 1, 4) from the discrete Riccati iteration, fixed trip count
    (``controller.py:457-486``), on batches of (A_d, B_d)."""
    require_fp32_matmul(A_d)
    At, Bt = A_d.transpose(-1, -2), B_d.transpose(-1, -2)
    P = Q.expand(*A_d.shape[:-2], *Q.shape[-2:])
    for _ in range(iters):
        BtPB = Bt @ P @ B_d + R
        P = At @ P @ A_d - (At @ P @ B_d) @ torch.linalg.inv(BtPB) @ (Bt @ P @ A_d) + Q
    return torch.linalg.inv(Bt @ P @ B_d + R) @ (Bt @ P @ A_d)


def mpc_steer_exact(s: EgoState, target: Path, vp: VehicleParams,
                    cfg: ControlConfig):
    """The per-tick-constructed condensed MPC (``controller.py:253-311``):
    Tustin discretization, the prediction matrices, H and E, and the cold
    box QP ``qp.solve_box_qp``. Plain PyTorch only; it checks the table
    path. -> (steer, idx)."""
    require_fp32_matmul(s.x)
    N, P_w, nx = cfg.mpc_n, cfg.mpc_p, 4
    nu = N * P_w
    ts = cfg.ts_discretize
    vx = safe_vx(s, cfg)
    Bn = vx.shape[0]
    dev, dt = vx.device, vx.dtype
    A, B, C = error_state_model(vx, vp)
    e, kappa, idx = tracking_error(s, target, cfg)
    eye = torch.eye(4, dtype=dt, device=dev)
    A_d, B_d, T = discretize(A, B, ts)                       # B_d (B, 4, 1)
    C_d = (T @ C) * ts * kappa[:, None, None] * vx[:, None, None]

    M_rows = [eye.expand(Bn, 4, 4)]
    cc_rows = [torch.zeros((Bn, 4, 1), dtype=dt, device=dev)]
    for _ in range(N):
        M_rows.append(A_d @ M_rows[-1])
        cc_rows.append(A_d @ cc_rows[-1] + C_d)
    M = torch.cat(M_rows, 1)                                 # (B, (N+1)4, 4)
    Cc = torch.cat(cc_rows, 1)                               # (B, (N+1)4, 1)
    pow_rows = [B_d.expand(Bn, 4, P_w)]
    for _ in range(N - 1):
        pow_rows.append(A_d @ pow_rows[-1])
    Cmat = torch.zeros((Bn, (N + 1) * nx, nu), dtype=dt, device=dev)
    for i in range(1, N + 1):
        for j in range(i):
            Cmat[:, i * nx:(i + 1) * nx, j * P_w:(j + 1) * P_w] = pow_rows[i - 1 - j]

    Qbar = torch.block_diag(*([torch.diag(torch.tensor(cfg.mpc_q, dtype=dt))] * N
                              + [torch.diag(torch.tensor(cfg.mpc_f, dtype=dt))])).to(dev)
    Rbar = torch.eye(nu, dtype=dt, device=dev) * cfg.mpc_r
    CtQ = Cmat.transpose(1, 2) @ Qbar
    H = CtQ @ Cmat + Rbar
    e_col = torch.stack(e, 1)[:, :, None]
    E = CtQ @ Cc + CtQ @ M @ e_col
    ones = torch.ones(nu, dtype=dt, device=dev)
    u = qp.solve_box_qp(2.0 * H, (2.0 * E)[:, :, 0], -ones, ones,
                        iters=cfg.mpc_admm_iters)
    # the QP box |u| <= 1 is the normalized actuator range: no rescale
    steer = torch.clamp(u[:, 0], -cfg.steer_limit, cfg.steer_limit)
    return steer, idx
