"""ctypes bindings of the native C++ reference engine
(``native/nbody_ref.cpp``; counterpart of ``nbody_tpu.utils.native``).

The library plays the role the reference's host-side C++ plays (tree
build project.cu:575-591, CPU traversal 593-675, dump writer 504-534): a
fast f64 golden engine for parity runs and quadtree dumps.  It is built
at first use, never at import, with ``g++`` and ``native/Makefile``'s
flags into ``build/nbody_tpu_torch/`` beside the package (listed in
``.gitignore``), under a name that carries a hash of the source and the
flags; the build writes a temporary file and renames it, so processes
that build at once each see a whole library.  Nothing is written under
``native/``.  Every entry point raises ``NativeUnavailable`` where no
compiler or source is present.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "nbody_ref.cpp"
# native/Makefile's CXXFLAGS, and -shared
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    build = Path(__file__).resolve().parents[2] / "build" / "nbody_tpu_torch"
    return build / f"libnbodyref_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeUnavailable("could not build the native library: no g++")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, OSError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise NativeUnavailable(
            f"could not build the native library: {detail}") from e
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not SOURCE.exists():
            raise NativeUnavailable(f"no native source at {SOURCE}")
        path = _target()
        if not path.exists():
            _build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeUnavailable(f"could not load {path}: {e}") from e
        dp = ctypes.POINTER(ctypes.c_double)
        lib.nbody_bh_accelerations.restype = ctypes.c_int
        lib.nbody_bh_accelerations.argtypes = [
            dp, dp, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, dp,
        ]
        lib.nbody_naive_accelerations.restype = ctypes.c_int
        lib.nbody_naive_accelerations.argtypes = [
            dp, dp, ctypes.c_int, ctypes.c_double, dp,
        ]
        lib.nbody_tree_dump.restype = ctypes.c_long
        lib.nbody_tree_dump.argtypes = [
            dp, dp, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_long,
        ]
        lib.nbody_simulate.restype = ctypes.c_int
        lib.nbody_simulate.argtypes = [
            dp, dp, dp, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return lib


def _as_c(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _bodies(positions, masses):
    """f64 contiguous copies, checked: [N, 2] positions and [N] masses."""
    p = np.ascontiguousarray(positions, dtype=np.float64)
    m = np.ascontiguousarray(masses, dtype=np.float64)
    if p.ndim != 2 or p.shape[1] != 2 or m.shape != (p.shape[0],):
        raise ValueError(
            f"the native engine is 2D: positions {p.shape}, masses "
            f"{m.shape} (expected [N, 2] and [N])")
    return p, m


def bh_accelerations(
    positions, masses, g: float, theta: float = 0.5, max_depth: int = 9
) -> np.ndarray:
    lib = load()
    p, m = _bodies(positions, masses)
    n = m.shape[0]
    acc = np.empty((n, 2), dtype=np.float64)
    rc = lib.nbody_bh_accelerations(
        _as_c(m), _as_c(p), n, g, theta, max_depth, _as_c(acc))
    if rc < 0:
        raise RuntimeError(f"nbody_bh_accelerations failed: {rc}")
    return acc


def naive_accelerations(positions, masses, g: float) -> np.ndarray:
    lib = load()
    p, m = _bodies(positions, masses)
    n = m.shape[0]
    acc = np.empty((n, 2), dtype=np.float64)
    rc = lib.nbody_naive_accelerations(_as_c(m), _as_c(p), n, g, _as_c(acc))
    if rc != 0:
        raise RuntimeError(f"nbody_naive_accelerations failed: {rc}")
    return acc


def tree_dump(positions, masses, max_depth: int = 9) -> str:
    """The quadtree dump text (TraverseTreeToFile, project.cu:504-534)."""
    lib = load()
    p, m = _bodies(positions, masses)
    n = m.shape[0]
    needed = lib.nbody_tree_dump(_as_c(m), _as_c(p), n, max_depth, None, 0)
    if needed < 0:
        raise RuntimeError(f"nbody_tree_dump failed: {needed}")
    buf = ctypes.create_string_buffer(needed)
    lib.nbody_tree_dump(_as_c(m), _as_c(p), n, max_depth, buf, needed)
    return buf.raw.decode()


def simulate(
    positions,
    velocities,
    masses,
    n_steps: int,
    dt: float,
    g: float,
    engine: str = "barnes_hut",
    theta: float = 0.5,
    max_depth: int = 9,
):
    """The full native step loop; returns (positions, velocities) after
    ``n_steps`` (copies: the inputs are not mutated)."""
    lib = load()
    p, m = _bodies(positions, masses)
    p = p.copy()
    v = np.array(velocities, dtype=np.float64)
    if v.shape != p.shape:
        raise ValueError(f"velocities {v.shape} != positions {p.shape}")
    n = m.shape[0]
    eng = 0 if engine == "naive" else 1
    rc = lib.nbody_simulate(
        _as_c(m), _as_c(p), _as_c(v), n, n_steps, dt, g, theta, max_depth,
        eng)
    if rc != 0:
        raise RuntimeError(f"nbody_simulate failed: {rc}")
    return p, v
