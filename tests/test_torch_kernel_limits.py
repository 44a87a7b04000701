"""Each CUDA kernel's size limits, named before the launch: every wrapper
raises a ValueError that states the limit a call is past, and does so before
it looks at the tensors' device, so these run on the CPU. (The QP kernel's
limits are tested in ``test_torch_qp_split.py``.)"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from emplanner_carla_tpu_torch.config import EMConfig
from emplanner_carla_tpu_torch.planner import path_dp, speed_planner
from emplanner_carla_tpu_torch.sim import closed_loop
from emplanner_carla_tpu_torch.types import STSegments

CFG = EMConfig()
B = 2


def _tick_args(K, NB):
    """The shapes the tick wrappers read first: ego (B,), obstacles (B, K),
    a PID buffer (B, NB), a 96-point target and the speed profile."""
    z = lambda *s: torch.zeros(*s)  # noqa: E731
    ego = SimpleNamespace(x=z(B))
    obs = SimpleNamespace(x=z(B, K))
    target = SimpleNamespace(x=z(B, 96))
    return (ego, z(B, NB), None, None, obs, z(B, 401), None, target, None, None,
            None, None, None, CFG)


@pytest.mark.parametrize("K,NB,match", [(17, 60, "16 obstacle slots"),
                                        (12, 65, "PID buffer of 1..64")])
@pytest.mark.parametrize("entry", ["run_ticks_kernel", "run_traffic_ticks_kernel"])
def test_tick_wrappers_name_their_limits(entry, K, NB, match):
    """Every tick entry point (K3-K6 and the agent branch K7) checks the
    obstacle slots and the PID depth first."""
    extra = {"traffic": None} if entry == "run_traffic_ticks_kernel" else {}
    with pytest.raises(ValueError, match=match):
        getattr(closed_loop, entry)(*_tick_args(K, NB), **extra)


def test_tick_table_and_mpc_limits():
    """The LQR gain table (256 rows), the MPC variables (16) and the MPC
    tables' shared memory (232,448 bytes a block)."""
    closed_loop.check_tick_kernel_limits(12, 60, 128)
    closed_loop.check_tick_kernel_limits(12, 60, 64, nu=12)
    with pytest.raises(ValueError, match="2..256 rows"):
        closed_loop.check_tick_kernel_limits(12, 60, 257)
    with pytest.raises(ValueError, match="16 MPC variables"):
        closed_loop.check_tick_kernel_limits(12, 60, 64, nu=18)
    with pytest.raises(ValueError, match="shared memory"):
        closed_loop.check_tick_kernel_limits(12, 60, 300, nu=16)


@pytest.mark.parametrize("n_tab,nu,np_fit", [(128, 0, 832), (64, 12, 512)])
def test_tick_target_path_limit(n_tab, nu, np_fit):
    """The lanes' target paths are staged in shared memory beside the PID
    rings and the tables: up to 832 nodes under LQR and 512 under MPC at
    nu 12 fit a block, one node more raises, naming the path nodes."""
    closed_loop.check_tick_kernel_limits(12, 60, n_tab, nu, NP=np_fit)
    with pytest.raises(ValueError, match=f"{np_fit + 1} path nodes"):
        closed_loop.check_tick_kernel_limits(12, 60, n_tab, nu, NP=np_fit + 1)


@pytest.mark.parametrize("n_tab,nu,static,dynamic", [
    (128, 0, 12_288, 10_240),
    # the one-float LQR table an MPC block declares, which ptxas drops
    (64, 12, 8_192 + 4, 10_240 + 89_088),
])
def test_tick_kernel_smem_at_main_path_shapes(n_tab, nu, static, dynamic):
    """tick_kernel_smem at the main paths' 25-node target paths against the
    kernel's own count: its static arrays (PID rings; the LQR gain table)
    and dyn_floats (the MPC tables, the target paths, the lerped Minv and
    v), the figures ptxas and the launch report on the card."""
    assert closed_loop.tick_kernel_smem(n_tab, nu, 25) == static + dynamic


@pytest.mark.parametrize("K,cfg,match", [
    (9, CFG.speed, "1..8 segment slots"),
    (4, dataclasses.replace(CFG.speed, n_t=33), "2..32 columns"),
    (4, dataclasses.replace(CFG.speed, n_edge_samples=11), "0..8 interior samples"),
])
def test_speed_dp_wrapper_names_its_limits(K, cfg, match):
    seg = STSegments(*(torch.zeros(B, K) for _ in range(4)),
                     torch.zeros(B, K, dtype=torch.bool))
    with pytest.raises(ValueError, match=match):
        speed_planner.speed_dp_kernel(seg, torch.zeros(B), cfg)


def test_path_obs_wrapper_names_its_limit():
    cfg = dataclasses.replace(CFG.path, cols=18)
    z = torch.zeros(B, 4)
    with pytest.raises(ValueError, match="1..16 transition columns"):
        path_dp.transition_obstacle_costs_kernel(z, z, z.bool(), torch.zeros(B), cfg)
    # inside the limit the device check follows
    with pytest.raises(ValueError, match="CUDA"):
        path_dp.transition_obstacle_costs_kernel(z, z, z.bool(), torch.zeros(B), CFG.path)
