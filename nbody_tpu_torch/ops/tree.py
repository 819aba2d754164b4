"""Implicit dense quadtree pyramid (counterpart of ``nbody_tpu.ops.tree``).

Level L = max_depth is a 2^L x 2^L grid of cells; each body maps to a
leaf cell by its Morton code (recursive midpoint rule, DetermineChild
project.cu:348-356); coarser levels are 4->1 reductions of the packed
per-cell rows (Morton order makes the four children of cell c the rows
4c..4c+3).  See the JAX module for the equivalence to the reference's
adaptive tree.

Where the port must not drift from the reference's bits:

* Morton codes come from repeated f32 midpoint halving with ``>=`` to the
  high side — no other formula;
* leaf rows are sums over contiguous segments of the Morton-sorted
  bodies in a fixed order (:func:`leaf_sums`: body order within chunks of
  ``LEAF_CHUNK`` rows, then the chunks in order; the hand kernels
  ``csrc/tree_sums.cu`` on the card, two ``torch.segment_reduce`` calls
  on the CPU), not atomics, so they are deterministic and a singleton
  cell's position sums are the body's own bits;
* the pyramid sums the four children with plain adds, never a matmul
  (a TF32 matmul would truncate the singleton sums and let a body pull
  on itself).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..config import MAX_DEPTH_DEFAULT, ROOT_PAD_FRACTION
from ..utils.profiling import count

# Rows of a chunk in the leaf sums' order (csrc/tree_sums.cu's kChunk): a
# leaf of at most this many rows is one serial sum in row order (as
# torch.segment_reduce adds); a longer one sums its chunks' serial sums in
# chunk order.  A port-only order: the JAX package's segment_sum fixes none.
LEAF_CHUNK = 16384


class TreeLevel(NamedTuple):
    mass: torch.Tensor  # [4^level] total mass per cell
    comx: torch.Tensor  # [4^level] centre of mass x (0 where empty)
    comy: torch.Tensor  # [4^level]
    count: torch.Tensor  # [4^level] int32 bodies per cell


# Column layout of the packed per-level rows [4^level, 8].
RAW_M, RAW_MX, RAW_MY, RAW_SX, RAW_SY, RAW_CNT, RAW_OCC, RAW_PAD = range(8)


@dataclasses.dataclass
class Quadtree:
    raw: Tuple[torch.Tensor, ...]  # packed [4^level, 8] rows, root first
    bounds: torch.Tensor  # [4] x_min, x_max, y_min, y_max
    codes: torch.Tensor  # [N] int32 leaf-cell Morton code per body

    @property
    def max_depth(self) -> int:
        return len(self.raw) - 1

    @property
    def levels(self) -> Tuple[TreeLevel, ...]:
        """Unpacked per-level views (derived on demand: the grouped
        engine reads ``raw`` only)."""
        return tuple(_finish_level(r, r.dtype) for r in self.raw)


def root_bounds(positions: torch.Tensor) -> torch.Tensor:
    """ComputeRootBounds (project.cu:536-573): min/max padded by 10% of
    the larger extent; 1e-6 for a single-point cloud."""
    x, y = positions[:, 0], positions[:, 1]
    x_min, x_max = x.min(), x.max()
    y_min, y_max = y.min(), y.max()
    max_dim = torch.maximum(x_max - x_min, y_max - y_min)
    pad = torch.where(max_dim == 0.0, torch.full_like(max_dim, 1e-6),
                      ROOT_PAD_FRACTION * max_dim)
    return torch.stack([x_min - pad, x_max + pad, y_min - pad, y_max + pad])


def morton_codes(positions: torch.Tensor, bounds: torch.Tensor,
                 max_depth: int) -> torch.Tensor:
    """Per-body leaf-cell Morton code by recursive midpoint subdivision:
    two bits per level, root first, low bit = x decision (child numbering
    0=BL, 1=BR, 2=TL, 3=TR)."""
    x, y = positions[:, 0], positions[:, 1]
    x_lo, x_hi = bounds[0].expand_as(x), bounds[1].expand_as(x)
    y_lo, y_hi = bounds[2].expand_as(y), bounds[3].expand_as(y)
    code = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for _ in range(max_depth):
        mid_x = (x_lo + x_hi) * 0.5
        mid_y = (y_lo + y_hi) * 0.5
        bx = x >= mid_x
        by = y >= mid_y
        x_lo = torch.where(bx, mid_x, x_lo)
        x_hi = torch.where(bx, x_hi, mid_x)
        y_lo = torch.where(by, mid_y, y_lo)
        y_hi = torch.where(by, y_hi, mid_y)
        code = (code << 2) | (by.to(torch.int32) << 1) | bx.to(torch.int32)
    return code


def leaf_counts(codes: torch.Tensor, n_leaf: int) -> torch.Tensor:
    """Bodies per leaf cell [n_leaf] int64: a scatter-add of ones, which
    gives ``torch.bincount``'s integer counts without its host read of
    the codes' maximum (so a CUDA graph can hold the tree build)."""
    counts = torch.zeros(n_leaf, dtype=torch.int64, device=codes.device)
    return counts.scatter_add_(0, codes.long(),
                               torch.ones_like(codes, dtype=torch.int64))


def leaf_sums_plain(rows: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """The leaf sums' plain twin, in their two-level order: a leaf of at
    most ``LEAF_CHUNK`` rows is one serial sum from 0 in row order; a
    longer one is cut into chunks of ``LEAF_CHUNK`` rows from its first
    row, each a serial sum from 0 in row order, and the leaf is their
    partials summed serially from 0 in chunk order.  Two
    ``torch.segment_reduce`` calls over fixed shapes: at most
    ``n_leaf + N // LEAF_CHUNK`` chunks, the unused ones of length 0, so
    nothing is read on the host."""
    c = LEAF_CHUNK
    n, n_leaf = rows.shape[0], lengths.shape[0]
    if n_leaf == 0:
        return rows.new_zeros((0,) + tuple(rows.shape[1:]))
    k_max = n_leaf + n // c
    per_leaf = (lengths + (c - 1)) // c  # chunks a leaf
    last = torch.cumsum(per_leaf, 0)  # one past each leaf's last chunk
    j = torch.arange(k_max, device=rows.device)
    leaf = torch.searchsorted(last, j, right=True)  # n_leaf: unused chunk
    own = leaf.clamp(max=n_leaf - 1)
    local = j - (last - per_leaf)[own]  # the chunk's index in its leaf
    chunk_rows = torch.where(leaf < n_leaf,
                             (lengths[own] - local * c).clamp(0, c), 0)
    # the lengths sum to N and the chunks' rows to the lengths by
    # construction: unsafe=True skips the checks that read them on the host
    partials = torch.segment_reduce(rows, "sum", lengths=chunk_rows, axis=0,
                                    unsafe=True)
    chunks = torch.cat([per_leaf, k_max - last[-1:]])  # + the unused ones
    return torch.segment_reduce(partials, "sum", lengths=chunks, axis=0,
                                unsafe=True)[:n_leaf]


def leaf_sums(rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-leaf column sums [n_leaf, W] of the Morton-sorted rows [N, W]
    (W = 8 in 2D, 16 in 3D), leaf i summing the next ``lengths[i]``
    rows (int64 [n_leaf], summing to N) in :func:`leaf_sums_plain`'s
    order: an empty leaf is 0, a singleton leaf keeps its row's bits.

    On CUDA: the kernels of ``csrc/tree_sums.cu`` (f32 or f64, W dividing
    256 and at most 32; rows narrower than 16 bytes are padded with zero
    columns; the offsets are a device prefix sum and every grid follows
    from the shapes, so nothing is read on the host and a CUDA graph can
    hold it), bit-equal to the twin.  On the CPU: the plain twin."""
    if not rows.is_cuda:
        return leaf_sums_plain(rows, lengths)
    from . import _cuda

    dev = rows.device
    n, w = rows.shape
    n_leaf = lengths.shape[0]
    if rows.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"rows are {rows.dtype}; the kernel takes f32/f64")
    if not 1 <= w <= 32 or 256 % w:
        raise ValueError(f"rows have {w} columns; the kernel takes a "
                         "divisor of 256 up to 32")
    _cuda.require(rows, "rows", rows.dtype, (n, w), dev)
    _cuda.require(lengths, "lengths", torch.int64, (n_leaf,), dev)
    width = max(w, 16 // rows.element_size())
    if width != w:
        rows = torch.nn.functional.pad(rows, (0, width - w))
    elif rows.data_ptr() % 16:  # the kernels load 16-byte vectors
        rows = rows.clone()
    ends = torch.cumsum(lengths, 0)
    # the sums, then the chunk partials of the leaves longer than
    # LEAF_CHUNK (slots below 2 * (N // LEAF_CHUNK)): one allocation
    both = torch.empty((n_leaf + max(1, 2 * (n // LEAF_CHUNK)), width),
                       dtype=rows.dtype, device=dev)
    base = both.data_ptr()
    with torch.cuda.device(dev):
        code = _cuda.library().nbody_leaf_sums(
            rows.data_ptr(), ends.data_ptr(), base,
            base + n_leaf * width * rows.element_size(), n, n_leaf, width,
            int(rows.dtype == torch.float64), _cuda.stream_of(both))
    _cuda.check(code, "leaf_sums")
    count("ops.tree.LEAF_SUM_LAUNCHES")
    return both[:n_leaf] if width == w else both[:n_leaf, :w].contiguous()


def leaf_raw(positions: torch.Tensor, masses: torch.Tensor,
             codes: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Packed per-leaf rows [4^max_depth, 8] (cols per RAW_*): sums over
    each leaf's contiguous segment of the stably Morton-sorted bodies,
    in :func:`leaf_sums`' order."""
    n_leaf = 4 ** max_depth
    x, y = positions[:, 0], positions[:, 1]
    zero = torch.zeros_like(masses)
    packed = torch.stack(
        [masses, masses * x, masses * y, x, y, torch.ones_like(masses),
         zero, zero], dim=1)  # [N, 8]
    order = torch.argsort(codes, stable=True)
    return leaf_sums(packed[order], leaf_counts(codes, n_leaf))


def _finish_level(raw: torch.Tensor, dtype) -> TreeLevel:
    """Unpacked TreeLevel view of packed rows; singleton cells take the
    exact position sums."""
    m = raw[:, RAW_M]
    cnt = raw[:, RAW_CNT].to(torch.int32)
    safe = torch.where(m > 0, m, torch.ones_like(m))
    comx = torch.where(cnt == 1, raw[:, RAW_SX], raw[:, RAW_MX] / safe)
    comy = torch.where(cnt == 1, raw[:, RAW_SY], raw[:, RAW_MY] / safe)
    return TreeLevel(mass=m.to(dtype), comx=comx.to(dtype),
                     comy=comy.to(dtype), count=cnt)


def pyramid_from_raw(raw: torch.Tensor, bounds: torch.Tensor,
                     codes: torch.Tensor, max_depth: int) -> Quadtree:
    """4->1 reductions up the pyramid (replaces recursive ComputeMass).
    Fields 0..5 are the children's sums in child order; RAW_OCC packs the
    four child-occupancy bits (count > 0) so the traversal can prune empty
    children from the parent's own row."""
    # 1, 2, 4, 8 made on the device (a host tensor's copy would stop a
    # CUDA graph capture)
    bits = (1 << torch.arange(4, device=raw.device)).to(raw.dtype)
    raws = [raw]
    for _ in range(max_depth):
        v = raw.reshape(-1, 4, 8)
        s = v[:, 0, :RAW_OCC] + v[:, 1, :RAW_OCC]
        s = s + v[:, 2, :RAW_OCC]
        s = s + v[:, 3, :RAW_OCC]
        occ = ((v[:, :, RAW_CNT] > 0).to(raw.dtype) * bits).sum(1)
        raw = torch.cat(
            [s, occ[:, None], torch.zeros_like(occ)[:, None]], dim=1)
        raws.append(raw)
    raws.reverse()  # root first
    return Quadtree(raw=tuple(raws), bounds=bounds, codes=codes)


def build_quadtree(positions: torch.Tensor, masses: torch.Tensor,
                   max_depth: int = MAX_DEPTH_DEFAULT,
                   bounds: torch.Tensor | None = None) -> Quadtree:
    """Whole-tree build: Morton codes, leaf segment sums, 4->1
    reductions."""
    if bounds is None:
        bounds = root_bounds(positions)
    codes = morton_codes(positions, bounds, max_depth)
    raw = leaf_raw(positions, masses, codes, max_depth)
    return pyramid_from_raw(raw, bounds, codes, max_depth)


def level_cell_size(bounds: torch.Tensor, level: int) -> torch.Tensor:
    """Max cell extent at a level (project.cu:637-639)."""
    sx = (bounds[1] - bounds[0]) / (1 << level)
    sy = (bounds[3] - bounds[2]) / (1 << level)
    return torch.maximum(sx, sy)
