"""Opt-in per-step metrics CSV (counterpart of ``nbody_tpu.utils.metrics``).

One row per recorded step: conserved quantities (energy, momentum) and
tree statistics (adaptive node count, deepest materialised level) — the
quantities the reference's report reasons about (tree size ~3N,
observations.txt:59-65).  The same columns and header bytes as the JAX
package; 3D rows keep only ``momentum_x`` / ``momentum_y``, as there.
"""

from __future__ import annotations

import csv
import os
from typing import Optional

from ..physics import kinetic_energy, potential_energy_scalable, total_momentum
from ..state import SimState


class MetricsWriter:
    """Accumulates one row per step; writes the CSV on flush."""

    FIELDS = [
        "step",
        "time",
        "kinetic_energy",
        "potential_energy",
        "total_energy",
        "momentum_x",
        "momentum_y",
        "tree_nodes",
        "tree_max_depth",
    ]

    def __init__(self, path: str, g: float, with_potential: bool = True):
        self.path = path
        self.g = g
        # the potential is O(N^2) work at bounded memory at any N (kernel
        # K5 on a CUDA f32 state); opt out to skip it
        self.with_potential = with_potential
        self.rows = []

    def record(self, state: SimState, tree_stats: Optional[dict] = None):
        ke = float(kinetic_energy(state))
        if self.with_potential:
            pe = float(potential_energy_scalable(state, self.g))
        else:
            pe = float("nan")
        mom = total_momentum(state).tolist()
        self.rows.append({
            "step": int(state.step),
            "time": float(state.time),
            "kinetic_energy": ke,
            "potential_energy": pe,
            "total_energy": ke + pe,
            "momentum_x": float(mom[0]),
            "momentum_y": float(mom[1]),
            "tree_nodes": (tree_stats or {}).get("nodes", ""),
            "tree_max_depth": (tree_stats or {}).get("max_depth", ""),
        })

    def flush(self):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.FIELDS)
            w.writeheader()
            w.writerows(self.rows)


def _stats(counts, max_depth: int, children: int) -> dict:
    """Occupied cells per level, the deepest level an adaptive tree would
    materialise (some parent holds >= 2 bodies) and its node count (the
    root plus ``children`` per >= 2-body cell above the leaves).  One
    host read per level, as in the JAX package."""
    occupied = [int((c > 0).sum()) for c in counts]
    split = [int((c >= 2).sum()) for c in counts[:max_depth]]
    deepest = max((lv + 1 for lv, s in enumerate(split) if s > 0), default=0)
    return {
        "nodes": 1 + children * sum(split),
        "max_depth": deepest,
        "occupied_per_level": occupied,
    }


def tree_stats(positions, masses, max_depth: int = 9) -> dict:
    """Occupied-node statistics of the current quadtree — the reference's
    'practical tree size' observable (observations.txt:59-65)."""
    from ..ops.tree import RAW_CNT, build_quadtree

    tree = build_quadtree(positions, masses, max_depth=max_depth)
    return _stats([lv[:, RAW_CNT] for lv in tree.raw], max_depth, 4)


def tree_stats_3d(positions, masses, max_depth: int | None = None) -> dict:
    """Octree analogue of :func:`tree_stats` for 3D runs."""
    from ..ops.tree3d import R3_CNT, build_octree, default_max_depth3

    if max_depth is None:
        max_depth = default_max_depth3(positions.shape[0])
    tree = build_octree(positions, masses, max_depth=max_depth)
    return _stats([lv[:, R3_CNT] for lv in tree.raw], max_depth, 8)
