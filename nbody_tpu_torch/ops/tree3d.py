"""Implicit dense octree pyramid (counterpart of ``nbody_tpu.ops.tree3d``).

Level L = max_depth is a 2^L x 2^L x 2^L grid of cells; each body maps to
a leaf cell by its 3-bit-per-level Morton code; coarser levels are 8->1
reductions of the packed 16-wide per-cell rows (Morton order makes the
eight children of cell c the rows 8c..8c+7).  Row layout:

    [m, m*x, m*y, m*z, sum x, sum y, sum z, count, occ, 0*7]

Where the port must not drift from the reference's bits (the same rules
as the quadtree, ``ops/tree.py``):

* Morton codes come from repeated f32 midpoint halving with ``>=`` to the
  high side, the x bit lowest of each 3-bit group;
* leaf rows are sums over contiguous segments of the stably Morton-sorted
  bodies in ``tree.leaf_sums``' fixed order (body order within chunks of
  ``tree.LEAF_CHUNK`` rows, then the chunks in order), not atomics, so a
  singleton cell's position sums are the body's own bits;
* the pyramid sums the eight children with plain adds, never a matmul
  (the JAX package's HIGHEST-precision reduction matmul would be a TF32
  product on the GPU unless pinned, and would then let a body pull on
  itself); OCC packs sum_j (cnt_j > 0) * 2^j, exact in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..config import ROOT_PAD_FRACTION
from .tree import leaf_counts, leaf_sums

# Column layout of the packed per-level rows [8^level, 16].
R3_M, R3_MX, R3_MY, R3_MZ, R3_SX, R3_SY, R3_SZ, R3_CNT, R3_OCC = range(9)
_W = 16  # row width

# Default depth cap: 8^7 = 2,097,152 leaf rows (the JAX package's choice).
MAX_DEPTH3_DEFAULT = 7


def default_max_depth3(n_bodies: int) -> int:
    """~0.25 bodies per leaf (8^ceil(log8(4N)) cells), in [4, 7]."""
    return min(
        MAX_DEPTH3_DEFAULT,
        max(4, math.ceil(math.log(max(4 * n_bodies, 8), 8))),
    )


@dataclasses.dataclass
class Octree:
    raw: Tuple[torch.Tensor, ...]  # packed [8^level, 16] rows, root first
    bounds: torch.Tensor  # [6] x_min, x_max, y_min, y_max, z_min, z_max
    codes: torch.Tensor  # [N] int32 leaf-cell Morton code per body

    @property
    def max_depth(self) -> int:
        return len(self.raw) - 1

    def leaf_counts(self) -> torch.Tensor:
        return self.raw[self.max_depth][:, R3_CNT].to(torch.int32)


def root_bounds_3d(positions: torch.Tensor) -> torch.Tensor:
    """3D ComputeRootBounds (project.cu:536-573 semantics): min/max padded
    by 10% of the largest extent; 1e-6 for a single-point cloud."""
    lo = positions.amin(0)
    hi = positions.amax(0)
    max_dim = (hi - lo).max()
    pad = torch.where(max_dim == 0.0, torch.full_like(max_dim, 1e-6),
                      ROOT_PAD_FRACTION * max_dim)
    return torch.stack([lo[0] - pad, hi[0] + pad, lo[1] - pad, hi[1] + pad,
                        lo[2] - pad, hi[2] + pad])


def morton_codes_3d(positions: torch.Tensor, bounds: torch.Tensor,
                    max_depth: int) -> torch.Tensor:
    """Per-body leaf-cell Morton code by recursive midpoint subdivision:
    three bits per level, root first, per level x lowest, then y, then z.
    The cell of a body at level l is ``code >> 3*(max_depth - l)``."""
    code = torch.zeros(positions.shape[0], dtype=torch.int32,
                       device=positions.device)
    axes = []
    for a in range(3):
        c = positions[:, a]
        axes.append([c, bounds[2 * a].expand_as(c),
                     bounds[2 * a + 1].expand_as(c)])
    for _ in range(max_depth):
        bits = []
        for entry in axes:
            c, lo, hi = entry
            mid = (lo + hi) * 0.5
            b = c >= mid
            entry[1] = torch.where(b, mid, lo)
            entry[2] = torch.where(b, hi, mid)
            bits.append(b.to(torch.int32))
        code = (code << 3) | (bits[2] << 2) | (bits[1] << 1) | bits[0]
    return code


def leaf_raw_3d(positions: torch.Tensor, masses: torch.Tensor,
                codes: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Packed per-leaf rows [8^max_depth, 16]: sums over each leaf's
    contiguous segment of the stably Morton-sorted bodies, in
    ``leaf_sums``' order."""
    n_leaf = 8 ** max_depth
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    packed = torch.zeros((masses.shape[0], _W), dtype=masses.dtype,
                         device=masses.device)
    for col, v in ((R3_M, masses), (R3_MX, masses * x), (R3_MY, masses * y),
                   (R3_MZ, masses * z), (R3_SX, x), (R3_SY, y), (R3_SZ, z),
                   (R3_CNT, 1.0)):
        packed[:, col] = v
    order = torch.argsort(codes, stable=True)
    return leaf_sums(packed[order], leaf_counts(codes, n_leaf))


def pyramid_from_raw_3d(raw: torch.Tensor, bounds: torch.Tensor,
                        codes: torch.Tensor, max_depth: int) -> Octree:
    """8->1 reductions up the pyramid: fields M..CNT are the children's
    sums in child order, R3_OCC packs the eight child-occupancy bits."""
    bits = 2.0 ** torch.arange(8, dtype=raw.dtype, device=raw.device)
    raws = [raw]
    for _ in range(max_depth):
        v = raw.reshape(-1, 8, _W)
        s = v[:, 0, :R3_OCC]
        for j in range(1, 8):
            s = s + v[:, j, :R3_OCC]
        occ = ((v[:, :, R3_CNT] > 0).to(raw.dtype) * bits).sum(1)
        raw = torch.cat(
            [s, occ[:, None],
             torch.zeros((s.shape[0], _W - R3_OCC - 1), dtype=raw.dtype,
                         device=raw.device)], dim=1)
        raws.append(raw)
    raws.reverse()  # root first
    return Octree(raw=tuple(raws), bounds=bounds, codes=codes)


def build_octree(positions: torch.Tensor, masses: torch.Tensor,
                 max_depth: int = MAX_DEPTH3_DEFAULT,
                 bounds: torch.Tensor | None = None) -> Octree:
    """Whole-octree build: Morton codes, leaf segment sums, 8->1
    reductions."""
    if bounds is None:
        bounds = root_bounds_3d(positions)
    codes = morton_codes_3d(positions, bounds, max_depth)
    raw = leaf_raw_3d(positions, masses, codes, max_depth)
    return pyramid_from_raw_3d(raw, bounds, codes, max_depth)


def level_cell_size_3d(bounds: torch.Tensor, level: int) -> torch.Tensor:
    """Max cell extent at a level (the 3D analogue of project.cu:637-639)."""
    sx = (bounds[1] - bounds[0]) / (1 << level)
    sy = (bounds[3] - bounds[2]) / (1 << level)
    sz = (bounds[5] - bounds[4]) / (1 << level)
    return torch.maximum(torch.maximum(sx, sy), sz)
