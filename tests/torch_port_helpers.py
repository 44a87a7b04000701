"""Shared pieces of the PyTorch-port tests (tests/test_torch_*.py): the
card fixture, NumPy round trips and the metric comparison bar."""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

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
