"""Shared pieces of the PyTorch-port tests (tests/test_torch_*.py): the
card fixture, NumPy round trips and the metric comparison bar."""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile

import math

import numpy as np
import pytest
import torch

from emplanner_carla_tpu_torch.sim import camera as t_cam

# The suite runs in several worker processes (pytest-xdist), and each
# imports every test file. torch's default of one intra-op thread per core
# in each of them oversubscribes the machine and slows every worker, the
# JAX tests' and the float64 oracle's included; the port's tests use small
# shapes that one thread serves.
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The card, or a skip: the port's CUDA kernels run only on a GPU with
    nvcc (decided at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def t32(a, device="cpu"):
    return torch.as_tensor(np.array(a, np.float32), device=device)


def np_of(t):
    return t.detach().cpu().numpy()


def first_lanes(x, B: int, n: int):
    """The first n lanes of every batch-major (B, ...) tensor in x (nested
    tuples, NamedTuples, dicts); everything else as it is."""
    if isinstance(x, torch.Tensor):
        return x[:n].contiguous() if x.dim() and x.shape[0] == B else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[first_lanes(v, B, n) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(first_lanes(v, B, n) for v in x)
    if isinstance(x, dict):
        return {k: first_lanes(v, B, n) for k, v in x.items()}
    return x


def tensors_of(x):
    """Every tensor in x (nested tuples, NamedTuples, lists), in order."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from tensors_of(v)


def assert_metrics_match(m_port, m_jax, fields, label=""):
    """The closed loop's equivalence bar (``__graft_entry__._assert_metrics_match``):
    bool/int channels identical; float channels within rtol 1e-5 and a
    5 mm absolute tolerance, because float32 operation order differs
    between PyTorch and XLA and the closed loop amplifies last-ulp
    differences."""
    for name in fields:
        a = np_of(getattr(m_port, name))
        b = np.asarray(getattr(m_jax, name))
        assert a.shape == b.shape, f"{label}{name}: {a.shape} != {b.shape}"
        if b.dtype == np.bool_ or np.issubdtype(b.dtype, np.integer):
            assert np.array_equal(a, b), (
                f"{label}{name}: {int(np.sum(a != b))} of {a.size} differ"
            )
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=5e-3,
                                       err_msg=f"{label}{name}")


def _arr(t):
    return np_of(t) if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_tick_bar(out_port, out_ref):
    """One cycle's tick loop at the JAX package's own kernel-vs-scan bar
    (``tests/test_tick_pallas.py``): ego x, y, vx and the PID buffer within
    1e-3, heading within 5e-4 (lanes near the MPC's box boundary compound
    operation-order differences), obstacle x within 1e-4, the x metric
    within 1e-3 and the lateral error within 2e-3; the PID count, arrival
    and the collided / arrived / feasible channels identical. Both outputs
    are (ego, buffer, count, last error, obstacles, arrived, metrics, ...)
    with the metrics indexable as TickMetrics' first eight channels, as
    tensors on any device or as arrays."""
    ego_a, buf_a, cnt_a, _, obs_a, arr_a, m_a = out_port[:7]
    ego_b, buf_b, cnt_b, _, obs_b, arr_b, m_b = out_ref[:7]
    for name, a, b, atol in (
        ("x", ego_a.x, ego_b.x, 1e-3), ("y", ego_a.y, ego_b.y, 1e-3),
        ("phi", ego_a.phi, ego_b.phi, 5e-4), ("vx", ego_a.vx, ego_b.vx, 1e-3),
        ("pid_buffer", buf_a, buf_b, 1e-3), ("obs.x", obs_a.x, obs_b.x, 1e-4),
        ("metric x", m_a[0], m_b[0], 1e-3), ("lateral_err", m_a[3], m_b[3], 2e-3),
    ):
        np.testing.assert_allclose(_arr(a), _arr(b), atol=atol, err_msg=name)
    for name, a, b in (("pid_count", cnt_a, cnt_b), ("arrived", arr_a, arr_b),
                       ("collided", m_a[5], m_b[5]), ("arrived metric", m_a[6], m_b[6]),
                       ("feasible", m_a[7], m_b[7])):
        np.testing.assert_array_equal(_arr(a), _arr(b), err_msg=name)


def assert_traffic_bar(out_port, out_ref):
    """The agent-traffic tick loop (K7) at the JAX package's kernel-vs-scan
    traffic bar: :func:`assert_tick_bar` for the ego, then NPC indices and
    lane targets identical, lane offsets within 1e-5, NPC positions and
    velocities within 1e-3. Both outputs are as :func:`assert_tick_bar`'s,
    then (MPC state, NPC indices, lane offsets, lane targets)."""
    assert_tick_bar(out_port, out_ref)
    idx_a, off_a, tgt_a = out_port[8:11]
    idx_b, off_b, tgt_b = out_ref[8:11]
    np.testing.assert_array_equal(_arr(idx_a), _arr(idx_b), err_msg="npc index")
    np.testing.assert_array_equal(_arr(tgt_a), _arr(tgt_b), err_msg="lane target")
    np.testing.assert_allclose(_arr(off_a), _arr(off_b), rtol=0, atol=1e-5,
                               err_msg="lane offset")
    for f in ("x", "y", "vx", "vy"):
        np.testing.assert_allclose(_arr(getattr(out_port[4], f)), _arr(getattr(out_ref[4], f)),
                                   rtol=0, atol=1e-3, err_msg=f"obs.{f}")


def assert_qp_close(x_a, st_a, x_b, st_b, atol=1e-4, y_rows=None):
    """K1 bar: x, x_s and z at rtol 1e-4 / atol 1e-4 (float32 dot order
    differs between the implementations). The dual y is held to 1% of its
    own magnitude: on the equality rows rho is scaled by 1e3, so the dual
    update amplifies last-ulp differences of A x by that factor every
    iteration and y random-walks between operation orders (the JAX
    package's own Pallas-vs-XLA test makes the same observation).
    ``y_rows`` (a bool mask over the rows) limits the y comparison to those
    rows; the caller then checks the others by what they do."""
    np.testing.assert_allclose(x_a, x_b, rtol=1e-4, atol=atol, err_msg="x")
    np.testing.assert_allclose(st_a[0], st_b[0], rtol=1e-4, atol=atol, err_msg="x_s")
    np.testing.assert_allclose(st_a[1], st_b[1], rtol=1e-4, atol=atol, err_msg="z")
    ya, yb = st_a[2], st_b[2]
    if y_rows is not None:
        ya, yb = ya[..., y_rows], yb[..., y_rows]
    np.testing.assert_allclose(ya, yb, rtol=0, atol=1e-2 * np.abs(yb).max(),
                               err_msg="y")


def warm_ladder_f64(solver, q, l, u, state):
    """The warm ladder of ``ops.qp.warm_ladder_torch`` in float64 on the CPU,
    from the same float32 inputs, constants and scalars: the exact result
    that every float32 implementation of the ladder approximates."""
    k = solver.consts("cpu")
    At, D, E = (k[name].double() for name in ("At", "D", "E"))
    q, l, u = (a.detach().cpu().double() for a in (q, l, u))
    x, z, y = (a.detach().cpu().double() for a in state)
    sigma, alpha = float(np.float32(solver.sigma)), float(np.float32(solver.alpha))
    qs = float(solver.c) * (D * q)
    ls, us = E * l, E * u
    z = torch.clamp(z, ls, us)
    for ph in range(solver.rho.shape[0]):
        rho = k["rho"][ph].double()
        KinvT = k["Kinv"][ph].double().T
        for _ in range(solver.iters):
            x = (sigma * x - qs + (rho * z - y) @ At) @ KinvT
            Ax_rel = alpha * (x @ At.T) + (1.0 - alpha) * z
            z_new = torch.clamp(Ax_rel + y / rho, ls, us)
            y = y + rho * (Ax_rel - z_new)
            z = z_new
    return D * x, (x, z, y)


def assert_within_roundoff(out, plains, exact, factor=2.0):
    """x, x_s and z of ``out`` ((x, (x_s, z, y)), e.g. the QP kernel's) no
    farther from ``exact`` (:func:`warm_ladder_f64`) in max abs than
    ``factor`` times the farthest of ``plains``: float32 implementations of
    the same ladder (the plain version on the card and on the CPU), whose
    distance from the exact result is float32's own round-off on this input,
    as the rho ladder amplifies it."""
    def parts(o):
        return [np.asarray(np_of(a), np.float64) for a in (o[0], o[1][0], o[1][1])]

    ref = parts(exact)
    floor = np.max([[np.abs(a - r).max() for a, r in zip(parts(p), ref)]
                    for p in plains], axis=0)
    for name, a, r, f in zip(("x", "x_s", "z"), parts(out), ref, floor):
        err = np.abs(a - r).max()
        assert err <= factor * f, (
            f"{name}: {err:.3e} from the float64 ladder, float32 round-off "
            f"{f:.3e} (x {factor})")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (and the QP
    kernel does on the int32 view): to nearest at mantissa bit 13, ties away
    from zero, the low 13 mantissa bits zeroed."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split2(x: torch.Tensor):
    """The QP kernel's lane-operand split: x = hi + lo + O(2^-22 |x|), both
    TF32, rounded to nearest."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def split3(x: torch.Tensor):
    """The QP kernel's constant-operand split, by truncation: x = hi + mid +
    lo exactly, each TF32 (11 + 11 + 2 significant bits)."""
    mask = torch.tensor(~0x1FFF, dtype=torch.int32)
    hi = (x.contiguous().view(torch.int32) & mask).view(torch.float32)
    r = x - hi
    mid = (r.view(torch.int32) & mask).view(torch.float32)
    return hi, mid, r - mid


def mm_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (lanes x k) @ b (k x cols) as the QP kernel forms it on the tensor
    cores: a split in two TF32 pieces (:func:`split2`), b in three
    (:func:`split3`); per k-step of 8, the five piece products above 2^-24 in
    three partial sums (ah*bl + al*bm, ah*bm + al*bh, ah*bh), each rounded to
    float32 here (the kernel unbiases the tensor cores' truncation of the
    largest), added, and the k-steps summed in float32 in order."""
    K = a.shape[1]
    pad = -K % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    ah, al = (p.double().reshape(a.shape[0], -1, 8) for p in split2(a))
    bh, bm, bl = (p.double().reshape(-1, 8, b.shape[1]) for p in split3(b))
    blk = lambda x, y: torch.einsum("bkj,kjn->kbn", x, y)  # noqa: E731
    ps = (blk(ah, bl) + blk(al, bm)).float()
    pm = (blk(ah, bm) + blk(al, bh)).float()
    p = (ps + pm) + blk(ah, bh).float()
    acc = torch.zeros_like(p[0])
    for pk in p:
        acc = acc + pk
    return acc


def warm_ladder_split(solver, q, l, u, state):
    """The QP kernel's arithmetic in plain PyTorch on the CPU: the warm ladder
    of ``ops.qp.warm_ladder_torch`` with its three products formed by
    :func:`mm_split` and y / rho as y * (1 / rho)."""
    k = solver.consts(q.device)
    At, D, E = k["At"], k["D"], k["E"]
    c = torch.tensor(solver.c)
    sigma, alpha = solver.sigma, solver.alpha
    qs = c * (D * q)
    ls, us = E * l, E * u
    x, z, y = state
    z = torch.clamp(z, ls, us)
    for ph in range(solver.rho.shape[0]):
        rho = k["rho"][ph]
        rinv = 1.0 / rho
        KinvT = k["Kinv"][ph].T
        for _ in range(solver.iters):
            x = mm_split(sigma * x - qs + mm_split(rho * z - y, At), KinvT)
            Ax_rel = alpha * mm_split(x, At.T) + (1.0 - alpha) * z
            z_new = torch.clamp(Ax_rel + y * rinv, ls, us)
            y = y + rho * (Ax_rel - z_new)
            z = z_new
    return D * x, (x, z, y)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CHILD = (
    "import pickle, sys\n"
    "with open(sys.argv[1], 'rb') as fh:\n"
    "    fn, args = pickle.load(fh)\n"
    "out = fn(*args)\n"
    "with open(sys.argv[2], 'wb') as fh:\n"
    "    pickle.dump(out, fh)\n"
)


def run_single_threaded(fn, *args):
    """``fn(*args)`` in a fresh Python process whose BLAS and OpenMP run one
    thread each, set before NumPy loads (for the float64 oracle). The
    suite's workers each hold a BLAS thread pool; with two such pools busy
    at once, an oracle run measured 50x its time alone, and capping the
    pool at run time (threadpoolctl) did not help, while a process started
    with one BLAS thread ran at its solo time. ``fn`` and the arguments
    must pickle; the result comes back through a file."""
    env = dict(os.environ, OPENBLAS_NUM_THREADS="1", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [_REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as fh:
            pickle.dump((fn, args), fh)
        proc = subprocess.run([sys.executable, "-c", _CHILD, src, dst], env=env,
                              cwd=_REPO, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"child process failed:\n{proc.stderr[-4000:]}")
        with open(dst, "rb") as fh:
            return pickle.load(fh)


_RANK_CHILD = (
    "import datetime, pickle, sys\n"
    "import torch\n"
    "import torch.distributed as dist\n"
    "torch.set_num_threads(1)\n"
    "rank, world = int(sys.argv[1]), int(sys.argv[2])\n"
    "with open(sys.argv[4], 'rb') as fh:\n"
    "    fn, args = pickle.load(fh)\n"
    "dist.init_process_group('gloo', init_method='file://' + sys.argv[3], rank=rank,\n"
    "                        world_size=world,\n"
    "                        timeout=datetime.timedelta(seconds=float(sys.argv[6])))\n"
    "try:\n"
    "    out = fn(*args)\n"
    "finally:\n"
    "    dist.destroy_process_group()\n"
    "with open(sys.argv[5], 'wb') as fh:\n"
    "    pickle.dump(out, fh)\n"
)


def run_gloo_ranks(world: int, fn, *args, timeout: float = 240.0):
    """``fn(*args)`` on each of ``world`` CPU ranks, one child process a rank
    with one torch thread, joined in a gloo default process group through a
    file store; returns the ranks' results in rank order. ``fn`` must be a
    module-level function of a module the children import without JAX (this
    one). A rendezvous or collective that hangs fails after ``timeout``
    seconds (the group's timeout and the children's), and a failed child's
    stderr goes into the error."""
    env = dict(os.environ, OPENBLAS_NUM_THREADS="1", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [_REPO, os.path.join(_REPO, "tests")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.pkl")
        with open(src, "wb") as fh:
            pickle.dump((fn, args), fh)
        procs = []
        for r in range(world):
            cmd = [sys.executable, "-c", _RANK_CHILD, str(r), str(world),
                   os.path.join(tmp, "store"), src, os.path.join(tmp, f"out{r}.pkl"),
                   str(timeout)]
            procs.append(subprocess.Popen(cmd, env=env, cwd=_REPO, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        errs = []
        try:
            for r, p in enumerate(procs):
                _, err = p.communicate(timeout=timeout)
                if p.returncode != 0:
                    errs.append(f"rank {r} (rc {p.returncode}):\n{err[-4000:]}")
        except subprocess.TimeoutExpired:
            errs.append(f"ranks still running after {timeout} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if errs:
            raise RuntimeError("gloo ranks failed:\n" + "\n".join(errs))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out


def numpy_tree(x):
    """Every tensor of a nested NamedTuple/tuple/dict as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return np_of(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[numpy_tree(v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(numpy_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    return x


def fleet_rank(scenarios, cfg, modes: dict, ckpt_dir: str):
    """One rank of a CPU fleet: this rank's shard of ``scenarios`` (a port
    Scenario of the whole batch) through ``fleet_simulate`` in each of
    ``modes`` ({name: keyword arguments}), then the "full" mode's carry
    saved into checkpoint directory ``ckpt_dir`` and restored. Returns
    {name: (metrics, aggregates)} as NumPy, and under "checkpoint" the
    directory's files once every rank saved and whether the restored carry
    equals the saved one."""
    import torch.distributed as dist

    from emplanner_carla_tpu_torch.parallel import fleet
    from emplanner_carla_tpu_torch.utils import checkpoint

    mesh = fleet.make_mesh()
    assert mesh.backend == "gloo" and mesh.device.type == "cpu"
    local = fleet.shard_scenarios(scenarios, mesh)
    out, carries = {}, {}
    for name, kw in modes.items():
        metrics, agg, carries[name] = fleet.fleet_simulate(local, cfg, mesh,
                                                           return_carry=True, **kw)
        out[name] = (numpy_tree(metrics), {k: float(v) for k, v in agg.items()})
    checkpoint.save(ckpt_dir, carries["full"])
    dist.barrier()
    restored = checkpoint.restore(ckpt_dir, carries["full"])
    same = all(torch.equal(a, b) for a, b in zip(tensors_of(restored),
                                                  tensors_of(carries["full"])))
    out["checkpoint"] = (sorted(os.listdir(ckpt_dir)), same)
    return out


def column_depth_bar(ego, obs, walk, ref, cls_is_walker, cam):
    """Allowed |port - ref| of ``camera.render_columns``' depth ``ref`` (B, W)
    of one class on a layout (ego, obstacles, walker mask as NumPy arrays)
    seen by camera ``cam``, from the conditioning of its root:
    d_h = (-Bq - sqrt(disc)) / L, whose
    relative sensitivity to float32 rounding of the inputs grows as
    kappa = 1 / (2 sqrt(disc / Bq^2)) at grazing rays. Bar: rtol 1e-5 plus
    eight unit roundoffs times kappa of the hit slot nearest ``ref``,
    evaluated in float64 from the same float32 inputs. kappa is about the
    range over twice the radius on a cylinder's axis (10 at 20 m) and grows
    without bound at its silhouette edges."""
    f, cx = (cam.width / 2.0) / math.tan(cam.fov / 2.0), (cam.width - 1) / 2.0
    a = (cx - np.arange(cam.width)) / f
    L2 = 1.0 + a * a
    e = [np.asarray(v, np.float64) for v in ego]
    cph, sph = np.cos(e[2]), np.sin(e[2])
    cam_x, cam_y = e[0] + cam.mount_forward * cph, e[1] + cam.mount_forward * sph
    ux, uy = cph[:, None] - a * sph[:, None], sph[:, None] + a * cph[:, None]
    rad = np.where(walk, t_cam.WALKER_RADIUS, t_cam.VEHICLE_RADIUS)
    ox, oy = cam_x[:, None] - obs[0], cam_y[:, None] - obs[1]
    bq = ux[:, None, :] * ox[:, :, None] + uy[:, None, :] * oy[:, :, None]
    disc = bq * bq - L2 * (ox * ox + oy * oy - rad * rad)[:, :, None]
    dh = (-bq - np.sqrt(np.maximum(disc, 0.0))) / L2 * np.sqrt(L2)
    hit = (disc > 0) & (dh > 0) & obs[4][:, :, None] & (walk == cls_is_walker)[:, :, None]
    k = np.where(hit, np.abs(dh - ref[:, None, :]), np.inf).argmin(1)[:, None, :]
    r = np.take_along_axis(np.where(hit, disc / (bq * bq), np.inf), k, 1)[:, 0]
    kappa = 0.5 / np.sqrt(r)
    return np.abs(ref) * (1e-5 + 8.0 * 2.0 ** -24 * kappa)
