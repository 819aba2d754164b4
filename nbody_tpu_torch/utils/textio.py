"""Text-file data contracts (the reference's de-facto API, SURVEY.md 2.11).

A numpy-only copy of ``nbody_tpu.utils.textio``: importing the JAX
package would import jax, and the port must not.  The bytes written are
the same for the same numpy input (tests/test_torch_core.py).

Formats replicated byte-for-byte:

* ``*_init.txt`` triplet — one mass per line / ``x y`` per line, written with
  C++ ``operator<<`` default formatting (6 significant digits, ``%g``-style;
  writers project.cu:236-246 and 269-281, reader 103-161).
* ``positions.txt`` — ``time body_idx x y `` per body per step (including
  step 0), written with ``std::to_string`` (fixed 6 decimals; savePositions
  project.cu:855-863, consumed by plot_2d.py:3-14).

The quadtree dump lines come from the oracle
(``models.oracle.AdaptiveQuadtree.dump_lines``) or the native engine
(``utils.native.tree_dump``).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# C++-compatible number formatting
# ---------------------------------------------------------------------------

def cxx_ostream(v: float) -> str:
    """Format like C++ ``std::ostream << double`` (6 significant digits).

    Python's ``%.6g`` matches C++ default formatting including two-digit
    exponents (``1e-05``) and trailing-zero stripping (``0.1``).
    """
    return f"{float(v):.6g}"


def cxx_to_string(v: float) -> str:
    """Format like C++ ``std::to_string(double)`` (fixed, 6 decimals)."""
    return f"{float(v):.6f}"


# ---------------------------------------------------------------------------
# Init triplet (masses_init.txt / positions_init.txt / velocities_init.txt)
# ---------------------------------------------------------------------------

def save_masses(path: str, masses) -> None:
    """One mass per line (initializeMasses save path, project.cu:236-246)."""
    masses = np.asarray(masses)
    with open(path, "w") as f:
        for m in masses:
            f.write(cxx_ostream(m) + "\n")


def save_vectors(path: str, vectors) -> None:
    """``x y`` per line (initializeVectors save path, project.cu:269-281)."""
    vectors = np.asarray(vectors)
    with open(path, "w") as f:
        for row in vectors:
            f.write(" ".join(cxx_ostream(c) for c in row) + "\n")


def load_masses(path: str, n_bodies: int) -> np.ndarray:
    """Line-per-body masses with the reference's error behavior
    (loadSimulationDataFromText lambda, project.cu:115-128)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Failed to open file: {path}")
    out = np.empty(n_bodies, dtype=np.float64)
    with open(path) as f:
        for i in range(n_bodies):
            line = f.readline()
            if not line:
                raise ValueError(f"Not enough mass entries in file: {path}")
            out[i] = float(line)
    return out


def load_vectors(path: str, n_bodies: int, n_dim: int = 2) -> np.ndarray:
    """Space-separated per-body vectors (project.cu:131-149)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Failed to open file: {path}")
    out = np.empty((n_bodies, n_dim), dtype=np.float64)
    with open(path) as f:
        for i in range(n_bodies):
            line = f.readline()
            if not line:
                raise ValueError(f"Not enough vector entries in file: {path}")
            parts = line.split()
            if len(parts) < n_dim:
                raise ValueError(
                    f"Failed to parse vector component in file: {path}"
                )
            for d in range(n_dim):
                out[i, d] = float(parts[d])
    return out


def load_init_triplet(
    masses_file: str,
    positions_file: str,
    velocities_file: str,
    n_bodies: int,
    n_dim: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """loadSimulationDataFromText (project.cu:103-161), incl. the loaded-
    bodies confirmation on stdout (project.cu:160)."""
    masses = load_masses(masses_file, n_bodies)
    positions = load_vectors(positions_file, n_bodies, n_dim=n_dim)
    velocities = load_vectors(velocities_file, n_bodies, n_dim=n_dim)
    print(f"Loaded {n_bodies} bodies from text files.")
    return masses, positions, velocities


def save_init_triplet(out_dir: str, masses, positions, velocities) -> None:
    """initializeCpu's save side-effect (project.cu:298-302)."""
    save_masses(os.path.join(out_dir, "masses_init.txt"), masses)
    save_vectors(os.path.join(out_dir, "positions_init.txt"), positions)
    save_vectors(os.path.join(out_dir, "velocities_init.txt"), velocities)


# ---------------------------------------------------------------------------
# Trajectory file (positions.txt)
# ---------------------------------------------------------------------------

class PositionsWriter:
    """Accumulates ``time body x y `` lines and writes once at the end,
    mirroring the reference's string-buffer-then-flush pattern
    (runSimulation* builds ``output_str`` then writes it, project.cu:872/912).
    """

    def __init__(self, path: str):
        self.path = path
        self._chunks: List[str] = []

    def append(self, time: float, positions) -> None:
        import io as _io

        positions = np.asarray(positions, dtype=np.float64)
        n, dims = positions.shape
        rows = np.column_stack(
            [
                np.full(n, float(time)),
                np.arange(n, dtype=np.float64),
                positions,
            ]
        )
        buf = _io.StringIO()
        # trailing space before the newline matches savePositions
        # (project.cu:855-863: every field is followed by one space).
        # 3D runs emit ``time body x y z `` — the five-column schema the
        # reference's plot_3d.py:11-15 parses.
        np.savetxt(
            buf,
            rows,
            fmt=["%.6f", "%d"] + ["%.6f"] * dims,
            delimiter=" ",
            newline=" \n",
        )
        self._chunks.append(buf.getvalue())

    def flush(self) -> None:
        with open(self.path, "w") as f:
            f.write("".join(self._chunks))


def read_positions_file(path: str) -> np.ndarray:
    """Parse a positions.txt into an array of rows [time, body, x, y]
    (the plot_2d.py:6-14 consumption logic)."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = line.split()
            if not vals:
                continue
            rows.append([float(v) for v in vals])
    return np.asarray(rows)


def format_bodies(masses, positions, velocities) -> str:
    """printBodies pretty-printer (project.cu:838-853)."""
    masses = np.asarray(masses)
    positions = np.asarray(positions)
    velocities = np.asarray(velocities)
    out = []
    for i in range(masses.shape[0]):
        out.append(f"Body {i}:")
        out.append(f"  Mass: {cxx_ostream(masses[i])}")
        out.append(
            "  Position: [ "
            + " ".join(cxx_ostream(c) for c in positions[i])
            + " ]"
        )
        out.append(
            "  Velocity: [ "
            + " ".join(cxx_ostream(c) for c in velocities[i])
            + " ]"
        )
    return "\n".join(out)


def check_equal(first, second, name: str, tol: float = 1e-10) -> bool:
    """Element-wise comparison with the reference's verdict contract
    (checkEqual, project.cu:1027-1047): prints each first difference per
    row beyond ``tol`` and a final verdict line."""
    first = np.asarray(first)
    second = np.asarray(second)
    all_equal = True
    for i in range(first.shape[0]):
        row_a = np.atleast_1d(first[i])
        row_b = np.atleast_1d(second[i])
        for j in range(row_a.shape[0]):
            diff = abs(float(row_a[j]) - float(row_b[j]))
            if diff > tol:
                all_equal = False
                print(
                    f"Difference at index [{i}][{j}]: "
                    f"first = {row_a[j]}, second = {row_b[j]} , "
                    f"and the diff is: {diff}"
                )
                break
    if all_equal:
        print(f"\nThe {name} are the same.", end="")
    else:
        print(f"\n\n!!!!! The {name} are NOT the same !!!!!\n")
    return all_equal
