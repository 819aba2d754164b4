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
from ..utils.profiling import span
from . import _cuda, _graph
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
                    max_depth: int, dtype=torch.int32) -> torch.Tensor:
    """Per-body leaf-cell Morton code by recursive midpoint subdivision:
    three bits per level, root first, per level x lowest, then y, then z.
    The cell of a body at level l is ``code >> 3*(max_depth - l)``.
    ``int32`` holds 10 levels; ``dtype=torch.int64`` holds
    ``MAX_DEPTH3_WIDE`` (the adaptive engine's codes), whose first
    levels are the same bits, as the halvings are the same."""
    code = torch.zeros(positions.shape[0], dtype=dtype,
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
            bits.append(b.to(dtype))
        code = (code << 3) | (bits[2] << 2) | (bits[1] << 1) | bits[0]
    return code


def leaf_raw_3d(positions: torch.Tensor, masses: torch.Tensor,
                codes: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Packed per-leaf rows [8^max_depth, 16]: sums over each leaf's
    contiguous segment of the stably Morton-sorted bodies, in
    ``leaf_sums``' order."""
    order = torch.argsort(codes, stable=True)
    return leaf_sums(packed_rows_3d(positions, masses)[order],
                     leaf_counts(codes, 8 ** max_depth))


def packed_rows_3d(positions: torch.Tensor,
                   masses: torch.Tensor) -> torch.Tensor:
    """Each body's packed row [N, 16]: its mass, mass-weighted and plain
    position, and a count of 1."""
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    packed = torch.zeros((masses.shape[0], _W), dtype=masses.dtype,
                         device=masses.device)
    for col, v in ((R3_M, masses), (R3_MX, masses * x), (R3_MY, masses * y),
                   (R3_MZ, masses * z), (R3_SX, x), (R3_SY, y), (R3_SZ, z),
                   (R3_CNT, 1.0)):
        packed[:, col] = v
    return packed


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


# The adaptive engine's tree (``engine="barnes_hut_adaptive"``): 21
# levels, the most that a 63-bit Morton code holds.
MAX_DEPTH3_WIDE = 21

# cells built below the pyramid by :func:`refine_octree`, over all calls
# (read on the host where the build sizes its levels)
REFINED_CELLS = 0


@dataclasses.dataclass
class Refinement:
    """The sparse levels that hang below a pyramid's crowded leaves.

    Level ``base + 1 + i`` holds, in body order, every non-empty cell
    whose parent has more than ``direct_cell_max`` bodies (at ``base``,
    the pyramid's leaves; deeper, refined cells): ``raw[i]`` [K_i, 16]
    packed rows as the pyramid's (``R3_OCC`` 0), ``start[i]`` [K_i]
    int32 the index of its first body among the bodies sorted by their
    63-bit code (each cell is one contiguous range of them).
    ``child[i]`` [C_i, 2] int32 gives each cell of level ``base + i``
    (i = 0: the 8^base pyramid leaves) its children's (first index in
    level ``base + i + 1``, count): 0 children for a cell of at most
    ``direct_cell_max`` bodies."""

    base: int
    raw: Tuple[torch.Tensor, ...]
    start: Tuple[torch.Tensor, ...]
    child: Tuple[torch.Tensor, ...]

    @property
    def depth(self) -> int:
        """The deepest level that holds cells (``base`` when none)."""
        return self.base + len(self.raw)

    @property
    def n_cells(self) -> int:
        return sum(r.shape[0] for r in self.raw)


def _shared_level(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The deepest level whose cell holds both of the 63-bit codes a and
    b, elementwise (``MAX_DEPTH3_WIDE`` where they are equal): the
    levels below the highest 3-bit group in which they differ."""
    bounds = 8 ** torch.arange(MAX_DEPTH3_WIDE, device=a.device)
    return MAX_DEPTH3_WIDE - torch.searchsorted(bounds, a ^ b, right=True)


def refine_octree(sorted_codes: torch.Tensor, sorted_rows: torch.Tensor,
                  leaf_cum: torch.Tensor, base: int,
                  direct_cell_max: int) -> Refinement:
    """The levels below a depth-``base`` pyramid, to depth
    ``MAX_DEPTH3_WIDE``, that the walk can open: the children of every
    cell of more than ``direct_cell_max`` bodies.

    ``sorted_codes`` [N] int64: the bodies' 63-bit codes, sorted;
    ``sorted_rows`` [N, 16]: their packed rows in that order;
    ``leaf_cum`` [8^base + 1]: the pyramid leaves' body prefix.  A
    cell's row is :func:`tree.leaf_sums` over its bodies (gaps between
    one level's cells are segments of their own, dropped).  One host
    read sizes every level (``_graph.HOST_READS``); the cells counted
    go to ``REFINED_CELLS``."""
    global REFINED_CELLS
    n = sorted_codes.shape[0]
    dev = sorted_codes.device
    top = MAX_DEPTH3_WIDE
    w = direct_cell_max
    # prev[i]: the deepest level whose cell body i shares with body i - 1
    prev = torch.full((n,), -1, dtype=torch.int64, device=dev)
    prev[1:] = _shared_level(sorted_codes[:-1], sorted_codes[1:])
    # deepest[i]: the deepest level whose cell of body i holds more than
    # w bodies, i.e. the most that any w + 1 consecutive bodies holding i
    # share (a sliding max over the windows' shared levels)
    window = torch.full((n + w,), -1.0, device=dev)
    if n > w:
        window[w:n] = _shared_level(sorted_codes[:n - w],
                                    sorted_codes[w:]).float()
    deepest = torch.nn.functional.max_pool1d(
        window[None, None], w + 1, stride=1)[0, 0].long()

    def starts(level):
        """Whether body i opens a cell of ``level`` whose parent holds
        more than w bodies."""
        return (prev < level) & (deepest >= level - 1)

    # body i opens one such cell at every level in [lo, hi]
    lo = (prev + 1).clamp(min=base + 1, max=top + 1)
    hi = (deepest + 1).clamp(max=top)
    live = (lo <= hi).long()
    edges = torch.zeros(top + 2, dtype=torch.int64, device=dev)
    edges.scatter_add_(0, lo, live)
    edges.scatter_add_(0, hi + 1, -live)
    counts = _graph.host_values(torch.cumsum(edges, 0)[base + 1:top + 1])
    while counts and counts[-1] == 0:
        counts.pop()
    with _cuda.counter_lock:
        REFINED_CELLS += sum(counts)

    raws, firsts, ends = [], [], []
    for i, k in enumerate(counts):
        s = 3 * (top - base - 1 - i)
        flat = torch.cumsum(starts(base + 1 + i), 0)
        first = torch.searchsorted(
            flat, torch.arange(1, k + 1, device=dev, dtype=flat.dtype))
        end = torch.searchsorted(sorted_codes,
                                 ((sorted_codes[first] >> s) + 1) << s)
        # segments: the gap before each cell, the cell; then the tail gap
        prev_end = torch.cat([first.new_zeros(1), end[:-1]])
        lengths = torch.stack([first - prev_end, end - first], 1).reshape(-1)
        lengths = torch.cat([lengths, (n - end[-1:])])
        raws.append(leaf_sums(sorted_rows, lengths)[1::2])
        firsts.append(first)
        ends.append(end)

    children = []
    lo, hi = leaf_cum[:-1].long(), leaf_cum[1:].long()
    for i in range(len(counts)):
        c0 = torch.searchsorted(firsts[i], lo)
        c1 = torch.searchsorted(firsts[i], hi)
        children.append(torch.stack([c0, c1 - c0], 1).to(torch.int32))
        lo, hi = firsts[i], ends[i]
    return Refinement(base=base, raw=tuple(raws),
                      start=tuple(f.to(torch.int32) for f in firsts),
                      child=tuple(children))


def build_octree_adaptive(positions: torch.Tensor, masses: torch.Tensor,
                          max_depth: int, direct_cell_max: int):
    """The adaptive engine's tree: the depth-``max_depth`` pyramid of
    :func:`build_octree`, with the bodies sorted stably by their 63-bit
    codes (so every cell at every depth is one contiguous run of them,
    and the leaves sum in that order), and its :func:`refine_octree`
    below (span ``nbody.refine``).  Returns (octree, refinement, order
    [N]: the sort)."""
    bounds = root_bounds_3d(positions)
    wide = morton_codes_3d(positions, bounds, MAX_DEPTH3_WIDE, torch.int64)
    order = torch.argsort(wide, stable=True)
    codes = (wide >> 3 * (MAX_DEPTH3_WIDE - max_depth)).to(torch.int32)
    rows = packed_rows_3d(positions, masses)[order]
    counts = leaf_counts(codes, 8 ** max_depth)
    tree = pyramid_from_raw_3d(leaf_sums(rows, counts), bounds, codes,
                               max_depth)
    with span("nbody.refine"):
        leaf_cum = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        refine = refine_octree(wide[order], rows, leaf_cum, max_depth,
                               direct_cell_max)
    return tree, refine, order
