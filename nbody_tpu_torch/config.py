"""Runtime configuration for the PyTorch / CUDA port.

Field for field the same dataclasses as :mod:`nbody_tpu.config` (the JAX
reference package), so a reference config carries across with
``SimConfig.from_dict(dataclasses.asdict(cfg))``.  Knobs that only the
TPU package acts on are kept as fields so configs round-trip.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Physics constants (reference project.cu:27-35, main_approach_1.cpp:11-21)
G_DEFAULT = 6.67e-11
N_DIM = 2
DT_DEFAULT = 1.0

# Init ranges of the main artifact (project.cu:30-35).
LOWER_M = 1e-1
HIGHER_M = 5e-1
LOWER_P = -1e-1
HIGHER_P = 1e-1
LOWER_V = -1e-4
HIGHER_V = 1e-4

# Barnes-Hut constants (reference project.cu:60-62); see nbody_tpu.config
# for the depth-counting convention (0-based: 9 == QUADTREE_MAX_DEPTH 10).
THETA_DEFAULT = 0.5
MAX_DEPTH_DEFAULT = 9
# Softening added to the distance (project.cu:634/748).
BH_SOFTENING = 1e-15
# Nodes with total mass at or below this are skipped (project.cu:617/731).
MASS_SKIP_THRESHOLD = 1e-15
# Bounding-box pad fraction (project.cu:558).
ROOT_PAD_FRACTION = 0.1


@dataclasses.dataclass(frozen=True)
class InitRanges:
    """Random-initialisation ranges (reference project.cu:30-35)."""

    lower_m: float = LOWER_M
    higher_m: float = HIGHER_M
    lower_p: float = LOWER_P
    higher_p: float = HIGHER_P
    lower_v: float = LOWER_V
    higher_v: float = HIGHER_V


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for multi-device runs: ``dp`` devices on the
    body axis ``axis_name`` (``run --devices``; ``parallel/``)."""

    dp: int = 1
    axis_name: str = "dp"


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Every knob of the reference, runtime-switchable (same fields and
    defaults as ``nbody_tpu.config.SimConfig``)."""

    n_bodies: int = 1024
    n_steps: int = 10
    dt: float = DT_DEFAULT
    g: float = G_DEFAULT
    n_dim: int = 2
    # "naive" | "allpairs" | "barnes_hut" | "barnes_hut_adaptive" (3D,
    # the port's alone: models/engines.py)
    engine: str = "allpairs"
    theta: float = THETA_DEFAULT
    max_depth: Optional[int] = None
    softening: float = BH_SOFTENING
    dtype: str = "float32"  # "float32" | "float64" | "bfloat16"
    compensated: bool = False
    seed: int = 0
    init: InitRanges = dataclasses.field(default_factory=InitRanges)
    init_mode: str = "uniform"
    # all-pairs kernel launch shape (utils.occupancy.resolve_tiles):
    # target_block = targets a block holds (picks the thread slices per
    # target), source_block = sources of one tile partial (fixes the
    # bits).  None = auto.
    target_block: Optional[int] = None
    source_block: Optional[int] = None
    verbose_occupancy: bool = False
    frontier_cap: Optional[int] = None
    bh_mode: str = "grouped"
    group_size: Optional[int] = None
    list_cap: Optional[int] = None
    direct_cap: Optional[int] = None
    direct_cell_max: Optional[int] = None
    direct_body_cap: Optional[int] = None
    group_chunk: int = 32
    eval_mode: Optional[str] = None
    eval_k_tile: Optional[int] = None
    run_cap: Optional[int] = None
    split_eval: Optional[bool] = None
    collect3: Optional[str] = None
    adaptive_caps: bool = True
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    hbm_bytes: Optional[int] = None
    save_positions: bool = False
    save_tree_dumps: bool = False
    output_dir: str = "."
    checkpoint_every: int = 0
    checkpoint_path: Optional[str] = None
    metrics_csv: Optional[str] = None
    metrics_tree: bool = True

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "SimConfig":
        """Rebuild from ``dataclasses.asdict`` of this class or of
        ``nbody_tpu.config.SimConfig`` (the nested ranges and mesh come
        back as dicts)."""
        d = dict(d)
        if isinstance(d.get("init"), dict):
            d["init"] = InitRanges(**d["init"])
        if isinstance(d.get("mesh"), dict):
            d["mesh"] = MeshConfig(**d["mesh"])
        return cls(**d)

    @property
    def resolved_max_depth(self) -> int:
        """``max_depth`` with the None-auto resolved (2D: the reference
        default 9; 3D: density-derived via tree3d.default_max_depth3)."""
        if self.max_depth is not None:
            return self.max_depth
        if self.n_dim == 3:
            from .ops.tree3d import default_max_depth3

            return default_max_depth3(self.n_bodies)
        return MAX_DEPTH_DEFAULT

    @property
    def resolved_direct_cell_max(self) -> Optional[int]:
        """``direct_cell_max`` with the 2D None-auto resolved to 32; in 3D
        None passes through (ops.bh3d.direct_cell_max_default resolves
        it from N)."""
        if self.direct_cell_max is not None or self.n_dim == 3:
            return self.direct_cell_max
        return 32

    @property
    def n_cells_finest(self) -> int:
        return 1 << self.resolved_max_depth

    @property
    def n_tree_nodes(self) -> int:
        return (4 ** (self.resolved_max_depth + 1) - 1) // 3

    def torch_dtype(self) -> torch.dtype:
        return {
            "float32": torch.float32,
            "float64": torch.float64,
            "bfloat16": torch.bfloat16,
        }[self.dtype]
