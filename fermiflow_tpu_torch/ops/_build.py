"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` process into a plain-C shared
library (all started together), loaded with ``ctypes``; pointers come from
``Tensor.data_ptr()`` and the stream from ``torch.cuda.current_stream()``.
Libraries are cached under ``fermiflow_tpu_torch/build/`` by a hash of the
sources and flags, so a rebuild happens only when a source changes.

``LAUNCHES`` counts kernel launches per wrapper; each wrapper adds one where
it launches its kernel and nowhere else.  Under a CUDA-graph capture a
wrapper's call records its launch without running it: a captured chunk
(``train.py``) takes back the counts its capture added and adds them again
at each replay, so that the counts say what ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "reset_launch_counts", "build_all", "library",
           "BUILD_DIR", "SOURCES", "ptr", "stream_ptr", "check_rc",
           "check_cuda_f32", "check_cuda_i32", "occupancy"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("metropolis", "metropolis_ms", "slater_vgh", "slater_vgh_ms",
           "hessian_flow", "reinforce")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {
    "metropolis_chains": 0,
    "metropolis_single": 0,
    "metropolis_multistate": 0,
    "slater_vgh": 0,
    "slater_vgh_ms": 0,
    "hessian_flow": 0,
    "reinforce_adjoint": 0,
    "reinforce_reduce": 0,
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every missing library, one nvcc per source, in parallel.

    Returns the wall seconds per source built (empty when all were cached).
    The ptxas report (registers, shared memory, spills) of each build is
    kept beside its library as ``<name>.ptxas.txt``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode}) ---\n{log}")
            continue
        tmp.replace(out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {n: BUILD_SECONDS[n] for n in todo}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _check_cuda(dtype: torch.dtype, tensors: dict) -> None:
    dev = None
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, expected {dev}")
        dev = t.device
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} for the CUDA kernel, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_cuda_f32(**tensors) -> None:
    """Every tensor lies on one CUDA device, is float32 and contiguous."""
    _check_cuda(torch.float32, tensors)


def check_cuda_i32(**tensors) -> None:
    """Every tensor lies on one CUDA device, is int32 and contiguous."""
    _check_cuda(torch.int32, tensors)


def occupancy(entry: str, *args) -> dict:
    """A lane-group kernel's launch as its library reports it
    (``ff_<entry>_occupancy(*args, ...)`` of ``csrc/<entry>.cu``): resident
    warps per SM, the warps of the grid its launcher makes, and the lanes
    that share one walker (needs the card)."""
    out = [ctypes.c_int(0) for _ in range(3)]
    rc = getattr(library(entry), f"ff_{entry}_occupancy")(
        *[ctypes.c_int(a) for a in args], *[ctypes.byref(o) for o in out])
    check_rc(rc, f"{entry} occupancy")
    return dict(zip(("warps_per_sm", "grid_warps", "lanes"),
                    (o.value for o in out)))
