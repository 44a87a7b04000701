"""The QP kernel's precision scheme and limits, on the CPU.

``csrc/qp_admm.cu`` forms its three products on the tensor cores from TF32
pieces: the lane operand split in two (rounded to nearest, ties away), the
constant in three (exactly), five piece products in three partial sums a
k-step, the k-steps summed in float32. A torch
emulation of that arithmetic (``torch_port_helpers.warm_ladder_split``) is
held here against the plain ladder ``ops.qp.warm_ladder_torch`` at the K1
bars of each site: x, x_s and z at rtol 1e-4 / atol 1e-4 at the path site and
atol 1e-3 at the speed site, y within 1 % of its magnitude (at the speed site
on the inequality rows, the equality rows by the next solve within 5e-3);
cold, x at the site's bar; and no farther from the exact (float64) ladder
than twice the plain ladder's own round-off. Also: the split's bits, the
host layout of the kernel's constants and the wrapper's limit checks."""

import numpy as np
import pytest
import torch

from emplanner_carla_tpu_torch.config import EMConfig
from emplanner_carla_tpu_torch.ops import qp as t_qp
from emplanner_carla_tpu_torch.planner import path_qp, speed_planner
from emplanner_carla_tpu_torch.types import STSegments
from torch_port_helpers import (
    assert_qp_close, assert_within_roundoff, np_of, split2, split3, t32, tf32_round,
    warm_ladder_f64, warm_ladder_split,
)

CFG = EMConfig()
B = 16
N_ST = 25  # path-QP stations: n 100, m 179


def _path_problem(solver, rng):
    """Path-site inputs (as the card test's): centre pulls on the offsets,
    corridor boxes, pinned start and end rows, continuity rows."""
    n = N_ST
    q = np.zeros((B, solver.n), np.float32)
    q[:, 0:3 * n:3] = -500.0 * rng.normal(size=(B, n))
    start = rng.normal(size=(B, 3)) * 0.5
    u = np.concatenate([np.zeros((B, 2 * (n - 1))), rng.uniform(0, 8, (B, 4 * n)),
                        start, np.zeros((B, 3)), np.full((B, n), 1e8)], 1)
    l = np.concatenate([np.zeros((B, 2 * (n - 1))), np.full((B, 4 * n), -1e8),
                        start, np.zeros((B, 3)), np.zeros((B, n))], 1)
    return [t32(a) for a in (q, l, u)]


def _speed_problem():
    """Speed-site inputs: bench config 1's two-segment set (as
    ``test_torch_cold_qp.py``'s) tiled to the batch, with spread plan-start
    speeds, through the port's S-T DP and convex space."""
    rows = ([20.0, 35.0, 0, 0], [25.0, 38.0, 0, 0], [2.0, 4.0, 0, 0], [5.0, 6.5, 0, 0])
    seg = STSegments(*(t32(np.tile(np.asarray(r, np.float32), (B, 1))) for r in rows),
                     torch.as_tensor(np.tile([True, True, False, False], (B, 1))))
    v0 = torch.linspace(4.0, 14.0, B)
    dp = speed_planner.speed_dp(seg, v0, CFG.speed)
    path_s = torch.linspace(0.0, 120.0, 60).expand(B, 60)
    bounds = speed_planner.convex_space(dp, seg, path_s, torch.full((B, 60), 1e-3),
                                        CFG.speed)
    return speed_planner.speed_qp_problem(v0, torch.zeros(B), *bounds, CFG.speed)


def test_tf32_split_bits():
    """TF32 rounding as cvt.rna.tf32.f32: the low 13 mantissa bits zero, the
    nearest TF32 value, ties away from zero; the lane operand's two pieces
    reconstruct x within 2^-22 relative, the constant's three exactly."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor((rng.normal(size=4096) * 10.0 ** rng.uniform(-6, 6, 4096))
                        .astype(np.float32))
    hi, lo = split2(x)
    for piece in (hi, lo):
        assert int((piece.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    xd, hd = x.double(), hi.double()
    ulp = 2.0 ** (torch.floor(torch.log2(xd.abs())) - 10)   # TF32's ulp at x
    assert bool(((xd - hd).abs() <= ulp / 2).all())
    assert float(((hd + lo.double() - xd).abs() / xd.abs()).max()) <= 2.0 ** -22
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], dtype=torch.float32)
    assert tf32_round(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    h3, m3, l3 = split3(x)
    for piece in (h3, m3, l3):
        assert int((piece.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert torch.equal(h3.double() + m3.double() + l3.double(), xd)


@pytest.mark.parametrize("site,warm", [("path", True), ("path", False),
                                       ("speed", True), ("speed", False)])
def test_split_ladder_holds_k1_bar(site, warm):
    """The kernel's split arithmetic against the plain float32 ladder, and
    against the exact (float64) ladder within twice the plain ladder's
    round-off: the path site warm (3 x 15 iterations) and cold (3 x 80), the
    speed site warm (3 x 40) and cold (3 x 80), at B 16."""
    rng = np.random.default_rng(5)
    if site == "path":
        solver = path_qp._solver_for(N_ST, 4.0, CFG.path, warm)[0]
        q, l, u = _path_problem(solver, rng)
        atol, y_rows = 1e-4, None
    else:
        solver = speed_planner._speed_solver(CFG.speed, warm=warm)
        q, l, u = _speed_problem()
        atol = 1e-3
        y_rows = ~speed_planner._speed_qp_constants(CFG.speed)[2]
    assert solver.iters == ((15 if site == "path" else 40) if warm else 80)
    if warm and site == "path":
        state = tuple(t32(rng.normal(size=(B, k)) * 0.1)
                      for k in (solver.n, solver.m, solver.m))
    else:
        state = t_qp.warm_zero_state(solver.n, solver.m, B)
    x_s, st_s = warm_ladder_split(solver, q, l, u, state)
    x_p, st_p = t_qp.warm_ladder_torch(solver, q, l, u, state)
    assert_within_roundoff((x_s, st_s), [(x_p, st_p)],
                           warm_ladder_f64(solver, q, l, u, state))
    if not warm:
        np.testing.assert_allclose(np_of(x_s), np_of(x_p), rtol=1e-4, atol=atol)
        return
    assert_qp_close(np_of(x_s), [np_of(a) for a in st_s], np_of(x_p),
                    [np_of(a) for a in st_p], atol=atol, y_rows=y_rows)
    if site == "speed":
        # the equality rows' dual, held by what it does: the next solve
        x_s2, st_s2 = warm_ladder_split(solver, q, l, u, st_s)
        x_p2, st_p2 = t_qp.warm_ladder_torch(solver, q, l, u, st_p)
        assert_qp_close(np_of(x_s2), [np_of(a) for a in st_s2], np_of(x_p2),
                        [np_of(a) for a in st_p2], atol=5e-3, y_rows=y_rows)


@pytest.mark.parametrize("n,m", [(100, 179), (51, 99), (104, 184), (8, 8)])
def test_kernel_layout(n, m):
    """The kernel's padded constants hold A and Kinv^T exactly with zero
    padding, and A's block lists name exactly its nonzero 8 x 8 blocks; the
    pitches give conflict-free shared-memory reads (A's and the staging
    tiles' rows 8 or 24 mod 32, Kinv^T's 4 or 12 mod 16, the bounds' 16 mod
    32) and the block
    fits the H100's shared memory up to the limits."""
    rng = np.random.default_rng(n)
    At = rng.normal(size=(m, n)).astype(np.float32)
    At[np.abs(np.arange(m)[:, None] * n / m - np.arange(n)[None, :]) > 6] = 0.0  # banded
    Kinv = rng.normal(size=(3, n, n)).astype(np.float32)
    L = t_qp.kernel_layout(n, m)
    A_pad, KT_pad, blocks = t_qp.kernel_constants(At, Kinv)
    kn, km = L["n8"] // 8, L["m8"] // 8
    nz = A_pad[:, :L["n8"]].reshape(km, 8, kn, 8).any(axis=(1, 3))
    off3 = blocks[kn + 1:]
    assert [list(blocks[blocks[j]:blocks[j + 1]]) for j in range(kn)] == \
        [list(np.flatnonzero(nz[:, j])) for j in range(kn)]
    assert [list(off3[off3[i]:off3[i + 1]]) for i in range(km)] == \
        [list(np.flatnonzero(nz[i])) for i in range(km)]
    assert A_pad.shape == (L["m8"], L["pa"]) and KT_pad.shape == (3, L["n8"], L["pk"])
    assert np.array_equal(A_pad[:m, :n], At) and np.array_equal(KT_pad[:, :n, :n],
                                                                Kinv.transpose(0, 2, 1))
    assert not A_pad[m:].any() and not A_pad[:, n:].any()
    assert not KT_pad[:, n:].any() and not KT_pad[:, :, n:].any()
    assert L["pa"] % 32 in (8, 24) and L["pk"] % 16 in (4, 12) and L["pl"] % 32 == 16
    assert L["pv_m"] % 32 in (8, 24) and L["pv_n"] % 32 in (8, 24)
    assert L["pv_m"] >= L["m8"] and L["pv_n"] >= L["n8"] and L["pl"] >= 2 * L["m8"]
    assert L["smem_bytes"] <= t_qp.SMEM_BYTES_MAX
    # Kinv rhs: a warp's B-fragment loads (thread lane: g = lane // 4,
    # tig = lane % 4; rows k + 2 tig, col g) touch 32 distinct banks
    g, tig = np.arange(32) // 4, np.arange(32) % 4
    assert len(set((2 * tig * L["pk"] + g) % 32)) == 32
    # A x reads A by (row g, cols k + 2 tig, + 1) as one 8-byte load per thread:
    # each half warp covers 32 distinct banks
    for half in (slice(0, 16), slice(16, 32)):
        banks = ((g[half] * L["pa"] + 2 * tig[half])[:, None] + np.arange(2)) % 32
        assert len(set(banks.ravel())) == 32


@pytest.mark.parametrize("n,m", [(105, 20), (20, 185)])
def test_warm_admm_kernel_over_limit_raises(n, m):
    """Past the kernel's limits the wrapper raises a ValueError that names
    them, before it looks at the tensors' device (here the CPU)."""
    rng = np.random.default_rng(1)
    phases = [(np.ones(m, np.float32), np.eye(n, dtype=np.float32))]
    solver = t_qp.PrefactoredQP(rng.normal(size=(m, n)).astype(np.float32),
                                np.ones(n, np.float32), np.ones(m, np.float32), 1.0,
                                phases, 5, 1e-6, 1.6)
    args = (torch.zeros(2, n), torch.zeros(2, m), torch.zeros(2, m),
            t_qp.warm_zero_state(n, m, 2))
    with pytest.raises(ValueError, match=f"{t_qp.KERNEL_N_MAX} variables and "
                                         f"1..{t_qp.KERNEL_M_MAX} constraint rows"):
        t_qp.warm_admm_kernel(solver, *args)


def test_warm_admm_kernel_checks_tensors():
    """Inside the limits, a tensor of the wrong dtype, shape or device raises
    a ValueError before any launch."""
    solver = speed_planner._speed_solver(CFG.speed)
    n, m = solver.n, solver.m
    st = t_qp.warm_zero_state(n, m, 2)
    good = (torch.zeros(2, n), torch.zeros(2, m), torch.zeros(2, m))
    with pytest.raises(ValueError, match="shape"):
        t_qp.warm_admm_kernel(solver, torch.zeros(2, n + 1), *good[1:], st)
    with pytest.raises(ValueError, match="float32 CUDA"):
        t_qp.warm_admm_kernel(solver, good[0].double(), *good[1:], st)
    with pytest.raises(ValueError, match="float32 CUDA"):
        t_qp.warm_admm_kernel(solver, *good, st)
