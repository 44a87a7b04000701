"""PyTorch port, NPC agents: each function of the port's ``sim/npc.py``
against its JAX function under ``jax.vmap`` (over lanes, then slots), on
inputs made from a seed with NumPy and the JAX scenario's 96-node global
paths. Bar: decisions (lane targets, corridor flags, match indices)
identical; floats within rtol 1e-5 / atol 1e-5 (XLA and PyTorch order the
same float32 operations alike; XLA:CPU may fuse a multiply-add)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emplanner_carla_tpu.config import EMConfig as JCfg
from emplanner_carla_tpu.sim import npc as j_npc
from emplanner_carla_tpu.sim import scenario as j_sc
from emplanner_carla_tpu.types import EgoState as JEgo
from emplanner_carla_tpu_torch import convert
from emplanner_carla_tpu_torch.sim import npc as t_npc
from emplanner_carla_tpu_torch.types import EgoState
from torch_port_helpers import np_of, t32

JC = JCfg(loop=dataclasses.replace(JCfg().loop, n_plans=2, plan_every=20))
TC = convert.config_from_dict(dataclasses.asdict(JC))
B, K, M = 6, 5, 7
RTOL = ATOL = 1e-5
BEHAVIORS = ("cautious", "normal", "aggressive")


def _close(a, b, name):
    np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=RTOL, atol=ATOL,
                               err_msg=name)


def _vmap2(fn, in_axes_inner):
    """jax.vmap over lanes, then slots (``in_axes_inner`` for the slot axis)."""
    return jax.jit(jax.vmap(jax.vmap(fn, in_axes=in_axes_inner)))


def _npc_ego(rng, gp):
    """(B, K) NPC states near the lanes' paths: positions up to 3 m off the
    path near random nodes, speeds 0-14 m/s, headings near the path's."""
    n = gp.x.shape[1]
    node = rng.integers(5, n - 40, (B, K))
    rows = np.arange(B)[:, None]
    th = np.asarray(gp.theta)[rows, node]
    lat = rng.uniform(-3.0, 3.0, (B, K))
    x = np.asarray(gp.x)[rows, node] - lat * np.sin(th) + rng.uniform(-1, 1, (B, K))
    y = np.asarray(gp.y)[rows, node] + lat * np.cos(th)
    phi = th + rng.uniform(-0.3, 0.3, (B, K))
    v = rng.uniform(0.0, 14.0, (B, K))
    z = np.zeros((B, K), np.float32)
    f = [np.asarray(a, np.float32) for a in (x, y, phi, v)]
    return f + [z] * 5, node.astype(np.int32)


@pytest.fixture(scope="module")
def paths():
    sc = j_sc.batch_scenarios(jax.random.PRNGKey(11), B, JC, n_path=96)
    return sc.global_path


@pytest.mark.parametrize("name", BEHAVIORS)
def test_preset_matches_jax(name):
    ref = j_npc.preset(name)
    out = t_npc.preset(name)
    for a, b in zip(out, ref):
        assert a.dtype == torch.float32
        assert np.float32(a.item()) == np.asarray(b)
    assert t_npc.preset_floats(name) == j_npc.preset_floats(name)


@pytest.mark.parametrize("name", BEHAVIORS)
def test_idm_accel_matches_jax(name):
    rng = np.random.default_rng(1)
    v, vl = rng.uniform(0, 16, (2, B, K)).astype(np.float32)
    gap = rng.uniform(-1, 60, (B, K)).astype(np.float32)
    gap[0, 0] = 1e4                                # nothing ahead
    ref = _vmap2(lambda a, b, c: j_npc.idm_accel(a, b, c, j_npc.preset(name)),
                 (0, 0, 0))(v, vl, gap)
    out = t_npc.idm_accel(t32(v), t32(vl), t32(gap), t_npc.preset(name))
    _close(out, ref, "idm_accel")


@pytest.mark.parametrize("name", BEHAVIORS)
def test_lane_change_decision_matches_jax(name):
    rng = np.random.default_rng(2)
    off = rng.choice([0.0, 1.2, 3.5, -3.5], (B, K)).astype(np.float32)
    tgt = rng.choice([0.0, 3.5, -3.5], (B, K)).astype(np.float32)
    gap = rng.uniform(0, 60, (B, K)).astype(np.float32)
    vl = rng.uniform(0, 16, (B, K)).astype(np.float32)
    vs = rng.uniform(0, 14, (B, K)).astype(np.float32)
    free = rng.uniform(size=(3, B, K)) < 0.5

    def jfn(o, t, g, l, s, f0, f1, f2):
        return j_npc.lane_change_decision(j_npc.LaneState(o, t), g, l, s, f0, f1, f2,
                                          j_npc.preset(name))

    ref = _vmap2(jfn, (0,) * 8)(off, tgt, gap, vl, vs, *free)
    out = t_npc.lane_change_decision(
        t_npc.LaneState(t32(off), t32(tgt)), t32(gap), t32(vl), t32(vs),
        *[torch.as_tensor(f) for f in free], t_npc.preset(name))
    np.testing.assert_array_equal(np_of(out.offset), np.asarray(ref.offset))
    np.testing.assert_array_equal(np_of(out.target), np.asarray(ref.target))
    # every branch met: left, right, merge back, hold
    moved = np_of(out.target) != tgt
    assert moved.any() and not moved.all()


def test_lateral_offset_and_slew_match_jax(paths):
    rng = np.random.default_rng(3)
    ego_np, node = _npc_ego(rng, paths)
    gp = convert.path_from_numpy(paths)
    ref = jax.jit(jax.vmap(lambda g, e, i: jax.vmap(
        lambda ee, ii: j_npc.lateral_offset_on_path(ee, g, ii))(e, i)))(
        paths, JEgo(*ego_np), node)
    out = t_npc.lateral_offset_on_path(EgoState(*[t32(a) for a in ego_np]), gp,
                                       torch.as_tensor(node))
    _close(out, ref, "lateral_offset")
    off = rng.uniform(-3.5, 3.5, (B, K)).astype(np.float32)
    tgt = rng.choice([0.0, 3.5, -3.5], (B, K)).astype(np.float32)
    ref = j_npc.slew_lane(j_npc.LaneState(jnp.asarray(off), jnp.asarray(tgt)), JC.plant.dt)
    out = t_npc.slew_lane(t_npc.LaneState(t32(off), t32(tgt)), TC.plant.dt)
    _close(out.offset, ref.offset, "slew offset")
    np.testing.assert_array_equal(np_of(out.target), np.asarray(ref.target))


@pytest.mark.parametrize("shift", [0.0, 3.5, -2.0])
def test_lead_info_and_corridor_free_match_jax(paths, shift):
    """Others (B, M) around each NPC (B, K), with per-slot validity; one
    other sits exactly where the ego-like last entry sits (a tie that the
    first index wins)."""
    rng = np.random.default_rng(4)
    ego_np, _ = _npc_ego(rng, paths)
    ox = ego_np[0][:, :1] + rng.uniform(-15, 30, (B, M)).astype(np.float32)
    oy = ego_np[1][:, :1] + rng.uniform(-6, 6, (B, M)).astype(np.float32)
    ox[:, -1], oy[:, -1] = ox[:, 2], oy[:, 2]
    ov = rng.uniform(0, 12, (B, M)).astype(np.float32)
    valid = rng.uniform(size=(B, K, M)) < 0.8
    sh = np.full((B, K), shift, np.float32) + rng.uniform(-0.5, 0.5, (B, K)).astype(np.float32)

    def jlead(e, x, y, v, ok, s):
        return j_npc.lead_info(e, x, y, v, ok, lateral_shift=s)

    inner = (JEgo(*[0] * 9), None, None, None, 0, 0)
    ref_gap, ref_v = jax.jit(jax.vmap(jax.vmap(jlead, in_axes=inner)))(
        JEgo(*ego_np), ox, oy, ov, valid, sh)
    te = EgoState(*[t32(a) for a in ego_np])
    args = (t32(ox)[:, None], t32(oy)[:, None])
    gap, v = t_npc.lead_info(te, *args, t32(ov)[:, None], torch.as_tensor(valid), t32(sh))
    _close(gap, ref_gap, "gap")
    _close(v, ref_v, "lead speed")
    assert (np_of(gap) < 1e4).any() and (np_of(gap) == 1e4).any()

    ref_free = jax.jit(jax.vmap(jax.vmap(
        lambda e, s, x, y, ok: j_npc.corridor_free(e, s, x, y, ok),
        in_axes=(JEgo(*[0] * 9), 0, None, None, 0))))(JEgo(*ego_np), sh, ox, oy, valid)
    free = t_npc.corridor_free(te, t32(sh), *args, torch.as_tensor(valid))
    np.testing.assert_array_equal(np_of(free), np.asarray(ref_free))
    assert free.any() and not free.all()


@pytest.mark.parametrize("name", BEHAVIORS)
def test_npc_step_matches_jax(paths, name):
    rng = np.random.default_rng(5)
    ego_np, node = _npc_ego(rng, paths)
    active = rng.uniform(size=(B, K)) < 0.8
    gap = rng.uniform(0, 60, (B, K)).astype(np.float32)
    vl = rng.uniform(0, 16, (B, K)).astype(np.float32)
    lane = rng.choice([0.0, 1.75, 3.5], (B, K)).astype(np.float32)
    idx0 = np.maximum(node - rng.integers(0, 6, (B, K)), 0).astype(np.int32)

    def jstep(g, e, i, a, gp_, v_, off):
        st = j_npc.NPCState(e, i, a)
        return j_npc.npc_step(st, g, gp_, v_, j_npc.preset(name), JC.vehicle,
                              JC.plant.dt, lane_offset=off)

    inner = (None, JEgo(*[0] * 9), 0, 0, 0, 0, 0)
    ref = jax.jit(jax.vmap(jax.vmap(jstep, in_axes=inner)))(
        paths, JEgo(*ego_np), idx0, active, gap, vl, lane)
    st = t_npc.NPCState(EgoState(*[t32(a) for a in ego_np]), torch.as_tensor(idx0),
                        torch.as_tensor(active))
    out = t_npc.npc_step(st, convert.path_from_numpy(paths), t32(gap), t32(vl),
                         t_npc.preset(name), TC.vehicle, TC.plant.dt, t32(lane))
    np.testing.assert_array_equal(np_of(out.path_index), np.asarray(ref.path_index))
    np.testing.assert_array_equal(np_of(out.active), np.asarray(ref.active))
    for f in EgoState._fields:
        _close(getattr(out.ego, f), getattr(ref.ego, f), f"ego.{f}")
    assert (np_of(out.path_index) != idx0).any()
