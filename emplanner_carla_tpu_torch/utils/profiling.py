"""Tracing / profiling helpers (counterpart of
``emplanner_carla_tpu/utils/profiling.py``).

* :func:`trace` — a context manager around ``torch.profiler`` (with the
  card's activity when CUDA is available) that exports a Chrome trace of
  the region, TensorBoard-compatible, into a directory;
* :func:`sync` — materialise a tree of tensors by fetching one checksum
  scalar to the host, which waits for every kernel queued before it on the
  stream;
* :func:`stage_timer` — wall-clock timing of a stage whose outputs the
  caller synchronises inside it;
* :func:`annotate` — a named region in profiler traces
  (``torch.profiler.record_function``, and an NVTX range on the card).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

from emplanner_carla_tpu_torch.types import tree_leaves


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture a host and device trace of the region; on exit it is
    written into ``logdir`` (default: ``emplanner_trace`` in the temporary
    directory) as ``<worker>.<time>.pt.trace.json``, which TensorBoard's
    profile plugin and ``chrome://tracing`` open. Yields ``logdir``."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "emplanner_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)
    ):
        yield logdir


def sync(tree) -> float:
    """Force full materialisation of a tree of tensors (nested tuples,
    NamedTuples, lists, dicts); returns a checksum, the float32 sum of |x|
    over every tensor. Fetching it is the synchronisation. The checksum's
    own work is the region ``sync`` in a trace."""
    with annotate("sync"):
        acc = None
        for leaf in tree_leaves(tree):
            part = leaf.to(torch.float32).abs().sum()
            acc = part if acc is None else acc + part.to(acc.device)
        return 0.0 if acc is None else float(acc)


@contextlib.contextmanager
def stage_timer(name: str, results: dict | None = None):
    """Wall-clock a stage into ``results[name]`` (seconds); the caller must
    ``sync()`` its outputs inside."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = dt


@contextlib.contextmanager
def annotate(name: str):
    """Name a region for profiler traces: ``torch.profiler.record_function``
    and, when CUDA is available, an NVTX range of the same name."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield
