"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``; the compilers
all start together.  The build runs at first use — never at import —
into ``build/nbody_tpu_torch/`` beside the package (listed in
``.gitignore``); each library's file name carries a hash of its source
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("allpairs.cu", "runs_eval.cu", "list_eval.cu", "graph_if.cu",
           "tree_sums.cu", "collect_dense3.cu", "collect_gather3.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
# what the last build in this process printed (ptxas register / shared
# memory report) and how long it took; "" / 0.0 when the library was
# already built
build_log = ""
build_seconds = 0.0


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "nbody_tpu_torch"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from nbody_tpu_torch/csrc at first use"
    )


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # included by the sources
        h.update(header.read_bytes())
    return build_dir() / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def _build() -> list:
    """Build the missing libraries, one ``nvcc`` per source, all at once;
    returns the library paths in ``SOURCES`` order."""
    global build_log, build_seconds
    srcs = [CSRC / s for s in SOURCES]
    outs = [_target(p) for p in srcs]
    todo = [(p, o) for p, o in zip(srcs, outs) if not o.exists()]
    if not todo:
        return outs
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, tmp, out, proc in jobs:
        text, _ = proc.communicate()
        logs.append(text)
        if proc.returncode != 0:
            failed.append(f"nvcc failed with code {proc.returncode}:\n"
                          f"{' '.join(cmd)}\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    return outs


class _Library:
    """The kernels' C entry points, gathered from the per-source
    libraries (each a ``ctypes`` function with its argument types set)."""

    def __init__(self, paths):
        self._dlls = [ctypes.CDLL(str(p)) for p in paths]
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for name, argtypes, restype in (
            ("nbody_allpairs_accel", [p, i, p, i, p, f, i, i, i, i, i, p],
             i),
            ("nbody_allpairs_occupancy",
             [i, i, i, i, ctypes.POINTER(ctypes.c_int)], i),
            ("nbody_allpairs_potential", [p, i, p, i, p, i, i, i, p], i),
            ("nbody_potential_occupancy",
             [i, i, ctypes.POINTER(ctypes.c_int)], i),
            ("nbody_list_eval",
             [p, p, p, p, i, i, ctypes.c_longlong, i, i, i, f, i, i, i, i,
              p], i),
            ("nbody_list_eval_occupancy",
             [i, i, i, ctypes.POINTER(ctypes.c_int)], i),
            ("nbody_runs_eval",
             [p, p, p, p, p, p, i, i, i, ctypes.c_longlong, i, i, f, i, i,
              i, i, p, p, p], i),
            ("nbody_runs_occupancy",
             [i, i, i, ctypes.POINTER(ctypes.c_int)], i),
            ("nbody_runs_eval_split",
             [p, p, p, p, p, p, p, i, i, i, i, ctypes.c_longlong, i, i, i,
              f, i, i, p, p, p], i),
            ("nbody_runs_split_occupancy",
             [i, i, ctypes.POINTER(ctypes.c_int)], i),
            ("nbody_graph_if_begin", [p, p, p, i], i),
            ("nbody_graph_if_end", [p], i),
            ("nbody_graph_stream_create", [ctypes.POINTER(p)], i),
            ("nbody_leaf_sums",
             [p, p, p, p, ctypes.c_longlong, ctypes.c_longlong, i, i, p], i),
            ("nbody_dense_collect3",
             [p, p, i, p, p, p, i, i, f, f, f, f, i, i, i, i, p, i, p], i),
            ("nbody_gather_collect3",
             [p, p, p, i, i, i, p, p, p, p, i, i, f, f, f, f, i, i, i, i, p,
              i, i, p], i),
            ("nbody_cuda_error_string", [i], ctypes.c_char_p),
        ):
            fn = next(getattr(d, name) for d in self._dlls
                      if hasattr(d, name))
            fn.argtypes, fn.restype = argtypes, restype
            setattr(self, name, fn)


def library() -> _Library:
    """The loaded kernel libraries, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _Library(_build())
        return _lib


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if code != 0:
        msg = library().nbody_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as an address."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what a kernel takes; ``None`` in ``shape`` is any)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if t.ndim != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
