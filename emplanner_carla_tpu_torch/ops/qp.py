"""Prefactored ADMM for constant-matrix QPs (counterpart of
``emplanner_carla_tpu/ops/qp.py``: ``prefactor_constants``, the warm and
cold contracts of ``make_prefactored_qp``, ``warm_zero_state``,
``solve_box_qp``, the general OSQP-splitting ``solve_qp`` and
``kkt_residuals``).

For the planner QPs the quadratic form P and the constraint matrix A are
fixed; only (q, l, u) vary per scenario. Everything matrix-shaped happens
once in float64 NumPy (:func:`prefactor_constants`, a verbatim copy); a solve
is a fixed 3-phase rho ladder of matmuls and clips on batch-first tensors.
The warm solver carries the scaled-space ADMM state across replan cycles,
the cold one starts from zero (z clipped to [l, u]) and runs the longer
cold iteration count:

    warm: solve(q (B, n), l (B, m), u (B, m), (x_s, z, y)) -> (x, (x_s, z, y))
    cold: solve(q, l, u) -> x

A solve dispatches on the device of ``q``: a CUDA tensor launches the
hand-written kernel ``csrc/qp_admm.cu`` (the port of the JAX package's
fused Pallas kernel, ``ops/qp_pallas.py make_pallas_qp``; the cold solve
hands it a zero state), a CPU tensor runs :func:`warm_ladder_torch`, the
plain PyTorch version of the same iteration. The kernel runs its products
on the tensor cores from TF32 pieces (the lane operand split in two, the
constant in three), from constants that :func:`kernel_constants` pads and
lays out for it; it holds at most :data:`KERNEL_N_MAX` variables
and :data:`KERNEL_M_MAX` constraint rows.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from emplanner_carla_tpu_torch import cuda
from emplanner_carla_tpu_torch.precision import require_fp32_matmul
from emplanner_carla_tpu_torch.types import Tensor

__all__ = [
    "prefactor_constants", "make_prefactored_qp", "PrefactoredQP",
    "warm_ladder_torch", "warm_admm_kernel", "warm_zero_state", "solve_box_qp",
    "kernel_layout", "kernel_constants", "check_kernel_limits", "solve_qp",
    "kkt_residuals",
]

# the kernel's tile and limits (csrc/qp_admm.cu): 32 lanes a block, n <= 104
# variables and m <= 184 constraint rows (its register tiles and its shared
# memory, at most 232,448 bytes a block on the H100)
KERNEL_LANES = 32
KERNEL_N_MAX = 104
KERNEL_M_MAX = 184
SMEM_BYTES_MAX = 232_448

# one counter per call site: the path QP and the speed QP, warm and cold, run
# the same kernel
launches = {"qp_admm_warm": 0, "qp_admm_speed": 0, "qp_admm_cold_path": 0,
            "qp_admm_cold_speed": 0}


def prefactor_constants(
    P_np,
    A_np,
    eq_mask_np,
    q_typical=None,
    rho_schedule=(0.1, 1.0, 6.0),
    sigma: float = 1e-6,
    rho_eq_scale: float = 1e3,
):
    """Float64 Ruiz equilibration + per-phase factorization of a constant
    (P, A) QP family. Returns (Pt, At, D, E, c, phases) as NumPy."""
    P0 = np.asarray(P_np, np.float64)
    A0 = np.asarray(A_np, np.float64)
    eq = np.asarray(eq_mask_np, bool)
    n = P0.shape[0]

    D = np.ones(n)
    E = np.ones(A0.shape[0])
    c = 1.0
    for _ in range(15):
        Ps = c * (D[:, None] * P0 * D[None, :])
        As = E[:, None] * A0 * D[None, :]
        col = np.maximum(np.abs(Ps).max(axis=0), np.abs(As).max(axis=0))
        D /= np.sqrt(np.maximum(col, 1e-8))
        row = np.abs(E[:, None] * A0 * D[None, :]).max(axis=1)
        E /= np.sqrt(np.maximum(row, 1e-8))
        Ps = c * (D[:, None] * P0 * D[None, :])
        # cost scaling must see the *linear* term too: with |q| >> |P| the
        # scaled problem is cost-dominated and a fixed rho ladder stalls.
        # q varies per instance, so callers pass a representative magnitude.
        cost_norm = np.mean(np.abs(Ps).max(axis=0))
        if q_typical is not None:
            cost_norm = max(
                cost_norm, np.abs(c * D * np.asarray(q_typical, np.float64)).max()
            )
        c /= max(np.sqrt(max(cost_norm, 1e-8)), 1e-4)
    Pt = c * (D[:, None] * P0 * D[None, :])
    At = E[:, None] * A0 * D[None, :]

    phases = []
    for rho in rho_schedule:
        rho_vec = np.where(eq, rho * rho_eq_scale, rho)
        K = Pt + sigma * np.eye(n) + (At.T * rho_vec) @ At
        phases.append(
            (rho_vec.astype(np.float32), np.linalg.inv(K).astype(np.float32))
        )
    return (
        Pt.astype(np.float32),
        At.astype(np.float32),
        D.astype(np.float32),
        E.astype(np.float32),
        float(c),
        phases,
    )


class PrefactoredQP:
    """A constant-matrix solver: ``solve(q, l, u, state) -> (x, state)``
    when ``warm``, else ``solve(q, l, u) -> x`` from the zero state.

    Holds the float32 constants as NumPy and their tensors per device."""

    def __init__(self, At, D, E, c, phases, iters_per_phase, sigma, alpha,
                 name="qp_admm_warm", warm=True):
        self.name = name                  # key of its launch counter
        self.warm = warm
        self.At = At                      # (m, n)
        self.D = D                        # (n,)
        self.E = E                        # (m,)
        self.c = np.float32(c)
        self.rho = np.stack([rv for rv, _ in phases])     # (P, m)
        self.Kinv = np.stack([Ki for _, Ki in phases])    # (P, n, n)
        self.iters = int(iters_per_phase)
        self.sigma = float(sigma)
        self.alpha = float(alpha)
        self.m, self.n = At.shape
        self._dev: dict = {}

    def consts(self, device) -> dict:
        key = str(device)
        if key not in self._dev:
            t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
            self._dev[key] = dict(
                At=t(self.At), D=t(self.D), E=t(self.E), rho=t(self.rho),
                Kinv=t(self.Kinv),
            )
        return self._dev[key]

    def kernel_consts(self, device) -> dict:
        """The kernel's constants on ``device``: :func:`kernel_constants`'s
        padded A and Kinv^T and A's block lists, beside :meth:`consts`."""
        key = str(device) + ":kernel"
        if key not in self._dev:
            A_pad, KT_pad, blocks = kernel_constants(self.At, self.Kinv)
            self._dev[key] = dict(
                A_pad=torch.as_tensor(A_pad, device=device),
                KT_pad=torch.as_tensor(KT_pad, device=device),
                blocks=torch.as_tensor(blocks, device=device),
                layout=kernel_layout(self.n, self.m))
        return self._dev[key]

    def __call__(self, q: Tensor, l: Tensor, u: Tensor, state=None):
        if not self.warm:
            # the cold start is the warm ladder from zeros: z is clipped to
            # [l, u] at entry
            state = warm_zero_state(self.n, self.m, q.shape[0], q.device)
        if q.is_cuda:
            out = warm_admm_kernel(self, q, l, u, state)
        else:
            out = warm_ladder_torch(self, q, l, u, state)
        return out if self.warm else out[0]


def make_prefactored_qp(
    P_np,
    A_np,
    eq_mask_np,
    q_typical=None,
    iters_per_phase: int = 100,
    rho_schedule=(0.1, 1.0, 6.0),
    sigma: float = 1e-6,
    rho_eq_scale: float = 1e3,
    alpha: float = 1.6,
    warm: bool = False,
    warm_iters_per_phase: int | None = None,
    name: str = "qp_admm_warm",
) -> PrefactoredQP:
    """Build a solver of the QP family min 1/2 x'Px + q'x, l <= Ax <= u (the
    JAX factory): with ``warm`` it runs ``warm_iters_per_phase`` (default
    ``iters_per_phase``) from the carried state, seeded with
    :func:`warm_zero_state`; without, ``iters_per_phase`` from zero.
    ``name`` keys the call site's launch counter in :data:`launches`."""
    _, At, D, E, c, phases = prefactor_constants(
        P_np, A_np, eq_mask_np, q_typical, rho_schedule, sigma, rho_eq_scale
    )
    iters = (warm_iters_per_phase
             if warm and warm_iters_per_phase is not None else iters_per_phase)
    return PrefactoredQP(At, D, E, c, phases, iters, sigma, alpha, name, warm)


def warm_ladder_torch(solver: PrefactoredQP, q, l, u, state):
    """Plain PyTorch version of the warm ladder: scale by (D, E, c), run
    ``iters`` ADMM steps per rho phase, unscale. Batch-first (B, n)/(B, m)."""
    require_fp32_matmul(q)
    k = solver.consts(q.device)
    At, D, E = k["At"], k["D"], k["E"]
    c = torch.tensor(solver.c, device=q.device)
    sigma, alpha = solver.sigma, solver.alpha
    qs = c * (D * q)
    ls = E * l
    us = E * u
    x, z, y = state
    z = torch.clamp(z, ls, us)
    for ph in range(solver.rho.shape[0]):
        rho = k["rho"][ph]
        KinvT = k["Kinv"][ph].T
        for _ in range(solver.iters):
            rhs = sigma * x - qs + (rho * z - y) @ At
            x = rhs @ KinvT
            Ax = x @ At.T
            Ax_rel = alpha * Ax + (1.0 - alpha) * z
            z_new = torch.clamp(Ax_rel + y / rho, ls, us)
            y = y + rho * (Ax_rel - z_new)
            z = z_new
    return D * x, (x, z, y)


def kernel_layout(n: int, m: int) -> dict:
    """Shapes of the kernel's shared-memory layout for an (n, m) QP, as
    ``csrc/qp_admm.cu`` computes them: n and m padded to the MMA's 8
    (``n8``, ``m8``); the row pitches at which every shared-memory access of
    a warp is free of bank conflicts: A's ``pa`` and the lane-operand
    staging tiles' ``pv_m``, ``pv_n`` (k8 when k8 / 8 is odd, else k8 + 8: 8
    or 24 mod 32), Kinv^T's ``pk`` (n8 + 4: 4 or 12 mod 16) and the scaled
    bounds' ``pl`` (2 m8, plus 16 where that is a multiple of 32); and the
    block's shared-memory bytes: A, one phase's Kinv^T, the bounds and the
    three staging tiles of 32 lanes, and (at most) A's block lists."""
    n8, m8 = -(-n // 8) * 8, -(-m // 8) * 8
    row = lambda k: k if (k // 8) % 2 else k + 8  # noqa: E731
    pa, pk, pl = row(n8), n8 + 4, 2 * m8 + (16 if (2 * m8) % 32 == 0 else 0)
    kn, km = n8 // 8, m8 // 8
    floats = (m8 * pa + n8 * pk + KERNEL_LANES * (pl + row(m8) + 2 * row(n8))
              + kn + km + 2 + 2 * kn * km)
    return dict(n8=n8, m8=m8, pa=pa, pk=pk, pv_m=row(m8), pv_n=row(n8), pl=pl,
                smem_bytes=4 * floats)


def kernel_constants(At: np.ndarray, Kinv: np.ndarray):
    """The kernel's constants, NumPy: A (m, n) zero-padded to (m8, pa) and
    each phase's Kinv (P, n, n) transposed and zero-padded to (P, n8, pk),
    float32; and int32 lists of A's 8 x 8 blocks that are not all zero,
    which the A^T v and A x products run over (the A matrices of the
    planner's QPs are banded: 58 of the path QP's 299 blocks, 25 of the
    speed QP's 91). The lists are ``[off1 | off3 | list1 | list3]``: for
    column tile j of A^T v, the block rows i of A from ``list1``, at
    ``blocks[off1[j]:off1[j + 1]]``; for row tile i of A x, the block columns
    j, at ``blocks[kn + 1:][off3[i]:off3[i + 1]]`` (kn = n8 / 8). Padding and
    skipped blocks are exact zeros, so every product is unchanged."""
    m, n = At.shape
    L = kernel_layout(n, m)
    A_pad = np.zeros((L["m8"], L["pa"]), np.float32)
    A_pad[:m, :n] = At
    KT_pad = np.zeros((Kinv.shape[0], L["n8"], L["pk"]), np.float32)
    KT_pad[:, :n, :n] = np.swapaxes(Kinv, 1, 2)
    kn, km = L["n8"] // 8, L["m8"] // 8
    nz = A_pad[:, :L["n8"]].reshape(km, 8, kn, 8).any(axis=(1, 3))   # (km, kn)
    list1 = [np.flatnonzero(nz[:, j]) for j in range(kn)]
    list3 = [np.flatnonzero(nz[i, :]) for i in range(km)]
    # off1 indexes the array, off3 the array past off1; list1 follows off3
    off1 = kn + km + 2 + np.concatenate([[0], np.cumsum([len(a) for a in list1])])
    off3 = off1[-1] - (kn + 1) + np.concatenate([[0], np.cumsum([len(a) for a in list3])])
    blocks = np.concatenate([off1, off3, *list1, *list3]).astype(np.int32)
    return A_pad, KT_pad, blocks


def check_kernel_limits(n: int, m: int) -> None:
    """Raise ``ValueError`` naming the QP kernel's limit that an (n, m) QP
    is past."""
    if not (1 <= n <= KERNEL_N_MAX and 1 <= m <= KERNEL_M_MAX):
        raise ValueError(
            f"the QP kernel (csrc/qp_admm.cu) holds 1..{KERNEL_N_MAX} variables "
            f"and 1..{KERNEL_M_MAX} constraint rows, got n {n}, m {m}")


def _check(t: Tensor, shape, name: str) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 CUDA tensor, "
                         f"got {t.dtype} on {t.device}")


def warm_admm_kernel(solver: PrefactoredQP, q, l, u, state):
    """Launch ``csrc/qp_admm.cu`` on the current stream: the whole ladder
    (scaling, 3 phases x ``iters``, unscaling) from ``state`` in one kernel,
    counted under the solver's call site. Raises ``ValueError`` before the
    launch for a QP past the kernel's limits (checked first), then for a
    tensor of the wrong dtype, shape or device."""
    n, m = solver.n, solver.m
    check_kernel_limits(n, m)
    require_fp32_matmul(q)
    B = q.shape[0]
    x0, z0, y0 = state
    for t, shp, nm in ((q, (B, n), "q"), (l, (B, m), "l"), (u, (B, m), "u"),
                       (x0, (B, n), "x_s"), (z0, (B, m), "z"),
                       (y0, (B, m), "y")):
        _check(t, shp, nm)
    k = solver.consts(q.device)
    kk = solver.kernel_consts(q.device)
    x = torch.empty((B, n), dtype=torch.float32, device=q.device)
    xs = torch.empty_like(x)
    z = torch.empty((B, m), dtype=torch.float32, device=q.device)
    y = torch.empty_like(z)
    fn = cuda.function("qp_admm", "qp_admm_warm", (ctypes.c_void_p,) * 12
                       + (ctypes.c_int,) + (ctypes.c_void_p,) * 4
                       + (ctypes.c_int,) * 6 + (ctypes.c_float,) * 3
                       + (ctypes.c_void_p,))
    err = fn(
        cuda.ptr(kk["A_pad"]), cuda.ptr(kk["KT_pad"]), cuda.ptr(k["rho"]),
        cuda.ptr(k["D"]), cuda.ptr(k["E"]),
        cuda.ptr(q), cuda.ptr(l), cuda.ptr(u),
        cuda.ptr(x0), cuda.ptr(z0), cuda.ptr(y0),
        cuda.ptr(kk["blocks"]), kk["blocks"].numel(),
        cuda.ptr(x), cuda.ptr(xs), cuda.ptr(z), cuda.ptr(y),
        B, n, m, kk["layout"]["pa"], int(solver.rho.shape[0]), solver.iters,
        float(solver.c), solver.sigma, solver.alpha,
        cuda.stream_of(q),
    )
    cuda.check(err, "qp_admm_warm")
    launches[solver.name] += 1
    return x, (xs, z, y)


def warm_zero_state(n: int, m: int, batch: int, device="cpu"):
    """Initial scaled-space ADMM state (x_s, z, y), zeros of (B, n)/(B, m)."""
    z = lambda k: torch.zeros((batch, k), dtype=torch.float32, device=device)  # noqa: E731
    return (z(n), z(m), z(m))


def solve_box_qp(H: Tensor, f: Tensor, lb: Tensor, ub: Tensor, iters: int = 80,
                 rho: float = 1.0) -> Tensor:
    """Box-constrained QP min 1/2 x'Hx + f'x, lb <= x <= ub, by ADMM with a
    prefactored x-update (the JAX package's ``solve_box_qp``). H (B, n, n),
    f (B, n), bounds broadcastable to f. Returns the box-feasible iterate
    z (B, n). Plain PyTorch: the per-tick MPC of ``mpc_steer_exact``."""
    require_fp32_matmul(f)
    n = f.shape[-1]
    M = torch.linalg.inv(H + rho * torch.eye(n, dtype=f.dtype, device=f.device))
    z = torch.clamp(torch.zeros_like(f), lb, ub)
    u = torch.zeros_like(f)
    for _ in range(iters):
        x = (M @ (rho * (z - u) - f)[..., None])[..., 0]
        z = torch.clamp(x + u, lb, ub)
        u = u + x - z
    return z


def _mv(M: Tensor, v: Tensor) -> Tensor:
    return (M @ v[..., None])[..., 0]


def _inf_norm(v: Tensor) -> Tensor:
    return v.abs().amax(-1)


def solve_qp(P: Tensor, q: Tensor, A: Tensor, l: Tensor, u: Tensor,
             iters: int = 120, rho: float = 1.0, sigma: float = 1e-6,
             rho_eq_scale: float = 1e3, alpha: float = 1.6, rho_updates: int = 4,
             polish: bool = True) -> Tensor:
    """General QP by OSQP splitting, min 1/2 x'Px + q'x s.t. l <= Ax <= u,
    for a batch of problems (the JAX package's ``solve_qp``): q (B, n); P
    (B, n, n), A (B, m, n), l and u (B, m), each also without the batch
    axis when the lanes share it. Equality rows (l == u) get rho *
    ``rho_eq_scale``; over-relaxation ``alpha``. Ruiz equilibration, then
    ``rho_updates`` phases of ``iters / rho_updates`` ADMM steps with rho
    rescaled by sqrt of the normalised primal/dual residual ratio between
    phases, then (``polish``) one exact KKT solve on the active set, kept
    where it is finite and no less feasible. Plain PyTorch. Returns x
    (B, n)."""
    require_fp32_matmul(q)
    Bn, n = q.shape
    m = l.shape[-1]
    P0, A0 = P.expand(Bn, n, n), A.expand(Bn, m, n)
    l0, u0 = l.expand(Bn, m), u.expand(Bn, m)
    q0 = q
    dt, dev = q.dtype, q.device
    is_eq = (u0 - l0).abs() < 1e-9
    eye_n = torch.eye(n, dtype=dt, device=dev)
    inner_iters = max(iters // max(rho_updates, 1), 1)

    # Ruiz equilibration (OSQP sec. 5.1): variables D, rows E, cost c
    D = torch.ones((Bn, n), dtype=dt, device=dev)
    E = torch.ones((Bn, m), dtype=dt, device=dev)
    c = torch.ones((Bn,), dtype=dt, device=dev)
    for _ in range(10):
        Ps = c[:, None, None] * (D[:, :, None] * P0 * D[:, None, :])
        As = E[:, :, None] * A0 * D[:, None, :]
        col_norm = torch.maximum(Ps.abs().amax(1), As.abs().amax(1))
        D = D / torch.sqrt(torch.clamp(col_norm, min=1e-8))
        row_norm = (E[:, :, None] * A0 * D[:, None, :]).abs().amax(2)
        E = E / torch.sqrt(torch.clamp(row_norm, min=1e-8))
        Ps = c[:, None, None] * (D[:, :, None] * P0 * D[:, None, :])
        cost_norm = torch.maximum(Ps.abs().amax(1).mean(-1),
                                  (c[:, None] * D * q0).abs().amax(-1))
        c = c / torch.clamp(torch.sqrt(torch.clamp(cost_norm, min=1e-8)), min=1e-4)
    P = c[:, None, None] * (D[:, :, None] * P0 * D[:, None, :])
    q = c[:, None] * (D * q0)
    A = E[:, :, None] * A0 * D[:, None, :]
    At = A.transpose(1, 2)
    l, u = E * l0, E * u0

    x = torch.zeros_like(q)
    z = torch.clamp(torch.zeros_like(l), l, u)
    y = torch.zeros_like(l)
    rho_s = torch.full((Bn,), rho, dtype=dt, device=dev)
    for _ in range(max(rho_updates, 1)):
        rho_vec = torch.where(is_eq, rho_s[:, None] * rho_eq_scale, rho_s[:, None])
        K = P + sigma * eye_n + (At * rho_vec[:, None, :]) @ A
        Kinv = torch.linalg.inv(K)
        for _ in range(inner_iters):
            rhs = sigma * x - q + _mv(At, rho_vec * z - y)
            x = _mv(Kinv, rhs)
            # one refinement step against the float32 inverse's error
            x = x + _mv(Kinv, rhs - _mv(K, x))
            Ax_rel = alpha * _mv(A, x) + (1.0 - alpha) * z
            z_new = torch.clamp(Ax_rel + y / rho_vec, l, u)
            y = y + rho_vec * (Ax_rel - z_new)
            z = z_new
        # OSQP's rho update: rho *= sqrt(prim_res_norm / dual_res_norm)
        Ax, Px, Aty = _mv(A, x), _mv(P, x), _mv(At, y)
        r_prim = _inf_norm(Ax - z)
        r_dual = _inf_norm(Px + q + Aty)
        prim_scale = torch.clamp(torch.maximum(_inf_norm(Ax), _inf_norm(z)), min=1e-6)
        dual_scale = torch.maximum(torch.maximum(_inf_norm(Px), _inf_norm(Aty)),
                                   torch.clamp(_inf_norm(q), min=1e-6))
        ratio = (r_prim / prim_scale) / torch.clamp(r_dual / dual_scale, min=1e-12)
        rho_s = torch.clamp(rho_s * torch.sqrt(ratio), 1e-4, 1e4)

    x = D * x  # un-scale the primal iterate
    if polish:
        # in the original problem's space; the duals map back as E y / c
        x = _polish(P0, q0, A0, l0, u0, x, E * y / c[:, None], sigma)
    return x


def _polish(P, q, A, l, u, x, y, sigma):
    """OSQP-style polish: one exact KKT solve on the active set (rows with
    |y| > 1e-6 and every equality row; inactive rows zeroed out of the
    constraint block, their multipliers pinned to 0 by a unit diagonal),
    with one refinement pass. Lanes where it is not finite, or violates the
    constraints by more than 1e-4 beyond the ADMM point, keep x."""
    n = q.shape[-1]
    is_eq = (u - l).abs() < 1e-9
    act_u = (y > 1e-6) | is_eq
    act_l = (y < -1e-6) & ~is_eq
    act = act_u | act_l
    b = torch.where(act_u, u, l)
    A_m = A * act[:, :, None].to(A.dtype)
    Dd = torch.where(act, sigma, 1.0).to(q.dtype)
    eye_n = torch.eye(n, dtype=q.dtype, device=q.device)
    K = torch.cat([torch.cat([P + sigma * eye_n, A_m.transpose(1, 2)], 2),
                   torch.cat([A_m, -torch.diag_embed(Dd)], 2)], 1)
    rhs = torch.cat([-q, torch.where(act, b, 0.0)], 1)
    sol, info = torch.linalg.solve_ex(K, rhs)
    fix, info2 = torch.linalg.solve_ex(K, rhs - _mv(K, sol))
    x_pol = (sol + fix)[:, :n]

    def viol(xx):
        Ax = _mv(A, xx)
        return (torch.clamp(Ax - u, min=0.0) + torch.clamp(l - Ax, min=0.0)).amax(-1)

    ok = (info == 0) & (info2 == 0) & torch.isfinite(x_pol).all(-1)
    ok = ok & (viol(x_pol) <= viol(x) + 1e-4)
    return torch.where(ok[:, None], x_pol, x)


def kkt_residuals(P: Tensor, q: Tensor, A: Tensor, l: Tensor, u: Tensor, x: Tensor):
    """Primal/dual feasibility diagnostics of a batch of solutions x (B, n):
    (max constraint violation (B,), gradient P x + q (B, n))."""
    Ax = _mv(A, x)
    prim = torch.clamp(Ax - u, min=0.0) + torch.clamp(l - Ax, min=0.0)
    return prim.abs().amax(-1), _mv(P, x) + q
