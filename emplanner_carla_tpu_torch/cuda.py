"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. Nothing is
compiled when the package is imported: the first launch of a kernel calls
:func:`library`, which builds every missing library in parallel (one
``nvcc`` per source, all started together) into ``build/`` at the root of
the checkout. A library's file name carries a hash of its source and flags,
so an edited source is never served from a stale build.

Build flags: ``-O3``, no ``--use_fast_math`` (IEEE division and full-range
``sinf``/``cosf`` everywhere). The path-DP obstacle-cost kernel, the tick
kernel and the speed-DP kernel build with ``-fmad=false`` so that every
multiply and add rounds on its own, as the eager PyTorch version does; the
QP kernel keeps fused multiply-adds for its dots.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path as _FsPath

_PKG = _FsPath(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"

# name -> (source file, extra nvcc flags)
SOURCES = {
    "qp_admm": ("qp_admm.cu", ()),
    "path_obs": ("path_obs.cu", ("-fmad=false",)),
    "tick_lqr": ("tick_lqr.cu", ("-fmad=false",)),
    "speed_dp": ("speed_dp.cu", ("-fmad=false",)),
}
_BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> _FsPath:
    src, flags = SOURCES[name]
    h = hashlib.sha256((CSRC / src).read_bytes())
    h.update(" ".join(_BASE_FLAGS + flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every library that is not built yet, all sources at once.
    Returns the wall seconds spent; raises with nvcc's output on failure."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        src, flags = SOURCES[name]
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_BASE_FLAGS, *flags, "-o", str(tmp), str(CSRC / src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        build_log[name] = log
        if p.returncode != 0:
            failed.append(f"--- {name} (rc {p.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def function(name: str, symbol: str, argtypes: tuple):
    """The C launcher ``symbol`` of library ``name``, typed: it returns a
    cudaError_t as int. Every pointer (and the stream) must be declared
    ``c_void_p``, or ctypes passes it as a 32-bit int."""
    fn = getattr(library(name), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
