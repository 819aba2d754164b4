"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use — never at import — into ``build/nbody_tpu_torch/`` beside
the package (listed in ``.gitignore``); the library's file name carries a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.
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
SOURCES = ("allpairs.cu", "runs_eval.cu")
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


def _build() -> Path:
    global build_log, build_seconds
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.read_bytes())
    out = build_dir() / f"libnbody_tpu_torch_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.nbody_allpairs_accel.argtypes = [
                p, i, p, i, p, f, i, i, i, p]
            lib.nbody_allpairs_accel.restype = i
            lib.nbody_runs_eval.argtypes = [
                p, p, p, p, p, p, i, i, i, ctypes.c_longlong, i, i, f, i, p]
            lib.nbody_runs_eval.restype = i
            lib.nbody_cuda_error_string.argtypes = [i]
            lib.nbody_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
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
