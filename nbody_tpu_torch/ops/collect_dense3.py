"""Dense (window-stencil) 3D interaction-list collection (counterpart of
``nbody_tpu.ops.collect_dense3``).

The gather walk (``bh3d._collect_lists_3d``) gathers one pyramid row per
frontier lane per level and compacts each level's children with a sort.
This collector replaces both with dense spatial windows: the cells a
group's dual walk can reach at level l lie in a box of at most ~32 cells
per axis around the group's bbox (theta = 0.5: a reached cell's parent
failed theta, so it lies within two parent sizes of the bbox), so each
group reads one [W, W, W] window per level from a row-major spatial grid
and classifies every cell in it.  Reachability moves down the pyramid by
upsampling the parent window's open flags 2x per axis; there is no
frontier.  On the card the walk and its compaction into the lists are
one kernel (``csrc/collect_dense3.cu``, a block a group); on the CPU
its torch twin, ``_dense_lists``, gives the same bits.

Correctness is never windowed away: an opened cell whose children fall
outside the next level's window marks its group *escaped*, and escaped
groups are collected again, exactly, by the gather walk (the spill pass);
escapes beyond ``spill_cap`` raise the ordinary overflow flag, which the
contract loop answers with its 4x-caps retry.  Whether a pass spills is
a device conditional (``ops/_graph.device_if``, the JAX package's
``lax.cond``): one host read outside capture, a conditional node in a
CUDA graph.  The spill pass walks a fixed ``spill_cap`` rows, the
escaped groups first, as the JAX package does.

The spatial pyramid is the octree itself, permuted: each level of
``Octree.raw`` (summed from contiguous Morton segments, no atomics) is
reordered from Morton to row-major [D, D, D], so the dense walk sees the
same cell masses and COMs, bit for bit, as the gather walk; the JAX
package scatters the bodies into a second grid instead, whose sums can
differ from the octree's in the last bit.  Each cell's Morton body
prefix ``start`` (the index of its first body in the Morton-sorted
sources) is the exclusive prefix sum of the level's counts in Morton
order.  The JAX package's dead-level skip is not carried over (same
result; here it would cost a host sync per level).

``DENSE_PASSES``, ``ESCAPED_GROUPS`` and ``SPILL_PASSES`` count the
collector's calls, the groups that escaped their windows, and the calls
that ran the spill pass, as the kernels' wrappers count launches
(``DENSE_KERNEL_LAUNCHES``, the walk's kernel: one a pass on the card); under
a CUDA graph's capture the replays count them on the device
(``_graph.tally``), read once after the run.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Tuple

import torch

from ..config import MASS_SKIP_THRESHOLD
from . import _graph
from .bh_grouped import (
    _INT_MAX,
    _quarter_fail_bits,
    _sort_compact,
    _theta_distances,
)
from .tree3d import (
    R3_CNT,
    R3_M,
    R3_MX,
    R3_MY,
    R3_MZ,
    R3_SX,
    R3_SY,
    R3_SZ,
    Octree,
    level_cell_size_3d,
)

DENSE_PASSES = 0
ESCAPED_GROUPS = 0
SPILL_PASSES = 0
# launches of csrc/collect_dense3.cu's kernel (one a pass on the card)
DENSE_KERNEL_LAUNCHES = 0

# what the window kernel takes (csrc/collect_dense3.cu): levels, cells
# across a window, and sub-boxes a group
KERNEL_MAX_LEVELS = 16
KERNEL_MAX_WIDTH = 32
KERNEL_MAX_SUB_BOXES = 256

# Per-level window widths (cells per axis), the JAX package's calibration
# (scripts/windows.py, uniform and two-blob states at 256K-1M, max depth
# 7, theta 0.5); levels past the table repeat its last entry.
WINDOW_SCHEDULE_3D = (1, 2, 4, 8, 16, 28, 24, 32)


def window_schedule_3d(max_depth: int) -> Tuple[int, ...]:
    """The default window widths of levels 0..max_depth."""
    t = WINDOW_SCHEDULE_3D
    return tuple(min(1 << lv, t[min(lv, len(t) - 1)])
                 for lv in range(max_depth + 1))


def check_window_schedule(schedule, max_depth: int) -> Tuple[int, ...]:
    """Validate a window schedule: one width per level, W[0] = 1, and for
    l >= 1 an even W[l] <= min(2^l, 2 W[l-1]).  Evenness lets each window
    start on an even cell, so its parent span is exactly W[l]/2 cells;
    W[l] <= 2 W[l-1] lets that span nest inside the parent window."""
    sched = tuple(int(w) for w in schedule)
    if len(sched) != max_depth + 1:
        raise ValueError(f"window_schedule needs {max_depth + 1} levels, "
                         f"got {len(sched)}")
    if sched[0] != 1:
        raise ValueError(f"window_schedule[0] must be 1, got {sched[0]}")
    for lv in range(1, len(sched)):
        w = sched[lv]
        if w < 2 or w % 2 or w > (1 << lv) or w > 2 * sched[lv - 1]:
            raise ValueError(
                f"window_schedule[{lv}] = {w}: widths past level 0 must be "
                f"even, at most 2^{lv} = {1 << lv} and at most twice the "
                f"previous level's ({sched[lv - 1]})")
    return sched


@dataclasses.dataclass
class SpatialPyramid:
    """Row-major spatial octree levels, root first.

    ``grid[l]``: [D, D, D, 5] (mass, com x, com y, com z, count), D = 2^l,
    indexed [cx, cy, cz]; singleton cells carry the body's exact position.
    ``start[l]``: [D, D, D] int32 Morton body prefix of each cell."""

    grid: Tuple[torch.Tensor, ...]
    start: Tuple[torch.Tensor, ...]
    bounds: torch.Tensor  # [6]

    @property
    def max_depth(self) -> int:
        return len(self.grid) - 1


def spatial_cell_coords_3d(positions: torch.Tensor, bounds: torch.Tensor,
                           max_depth: int) -> torch.Tensor:
    """Per-body leaf-cell (cx, cy, cz) [N, 3] int32 by the same recursive
    f32 midpoint subdivision as ``tree3d.morton_codes_3d``: the Morton
    code's bits, de-interleaved."""
    out = []
    for a in range(3):
        c = positions[:, a]
        lo, hi = bounds[2 * a].expand_as(c), bounds[2 * a + 1].expand_as(c)
        k = torch.zeros(c.shape, dtype=torch.int32, device=c.device)
        for _ in range(max_depth):
            mid = (lo + hi) * 0.5
            b = c >= mid
            lo, hi = torch.where(b, mid, lo), torch.where(b, hi, mid)
            k = (k << 1) | b.to(torch.int32)
        out.append(k)
    return torch.stack(out, dim=1)


def _morton_of_row_major(level: int, device) -> torch.Tensor:
    """[8^level] int64: the Morton index of the cell at each row-major
    position (cx * D + cy) * D + cz of a level (x bit lowest of each
    3-bit group, as ``tree3d.morton_codes_3d`` packs them)."""
    d = 1 << level
    r = torch.arange(d ** 3, dtype=torch.int64, device=device)
    coords = (r // (d * d), (r // d) % d, r % d)
    code = torch.zeros_like(r)
    for k in range(level):
        for axis, c in enumerate(coords):
            code |= ((c >> k) & 1) << (3 * k + axis)
    return code


def build_spatial_pyramid(tree: Octree) -> SpatialPyramid:
    """The octree's levels permuted to row-major grids, COM divided once,
    plus each cell's Morton body prefix."""
    grid, starts = [], []
    for level, raw in enumerate(tree.raw):
        d = 1 << level
        m, cnt = raw[:, R3_M], raw[:, R3_CNT]
        safe = torch.where(m > 0, m, torch.ones_like(m))
        com = [torch.where(cnt == 1.0, raw[:, s], raw[:, w] / safe)
               for s, w in ((R3_SX, R3_MX), (R3_SY, R3_MY), (R3_SZ, R3_MZ))]
        c32 = cnt.to(torch.int32)
        start = torch.cumsum(c32, 0, dtype=torch.int32) - c32
        perm = _morton_of_row_major(level, raw.device)
        grid.append(torch.stack([m, *com, cnt], dim=1)[perm]
                    .reshape(d, d, d, 5))
        starts.append(start[perm].reshape(d, d, d))
    return SpatialPyramid(grid=tuple(grid), start=tuple(starts),
                          bounds=tree.bounds)


def _window_origins(bbox, bounds: torch.Tensor,
                    schedule) -> List[torch.Tensor]:
    """Per level, the windows' origins [G, 3] int32: even, centred on the
    group's bbox, clipped to the domain [0, D - W] and to the parent
    window (the child window's parent span [o/2, o/2 + W/2) lies inside
    the parent's [o', o' + W'))."""
    x0, x1, y0, y1, z0, z1 = bbox
    glo = torch.stack([x0.amin(1), y0.amin(1), z0.amin(1)], dim=1)  # [G, 3]
    ghi = torch.stack([x1.amax(1), y1.amax(1), z1.amax(1)], dim=1)
    lo, hi = bounds[0::2], bounds[1::2]
    ext = hi - lo
    origins, prev = [], None
    for lv, w in enumerate(schedule):
        dl = 1 << lv
        cell = ext / dl
        c_lo = torch.floor((glo - lo) / cell).to(torch.int32).clamp(0, dl - 1)
        c_hi = torch.floor((ghi - lo) / cell).to(torch.int32).clamp(0, dl - 1)
        o = torch.div(c_lo + c_hi + 1 - w, 2, rounding_mode="floor")
        o = torch.div(o.clamp(0, dl - w), 2, rounding_mode="floor") * 2
        if prev is not None:
            o = torch.clamp(o, min=2 * prev,
                            max=2 * (prev + schedule[lv - 1]) - w)
        origins.append(o)
        prev = o
    return origins


def _window_index(o: torch.Tensor, w: int, d: int) -> torch.Tensor:
    """Row-major flat indices [G, W^3] of each group's [W, W, W] window at
    origins o [G, 3] in a [D, D, D] grid (x slowest, z fastest)."""
    ar = torch.arange(w, dtype=torch.int64, device=o.device)
    ix, iy, iz = (o[:, a:a + 1].long() + ar for a in range(3))  # [G, W]
    return ((ix[:, :, None, None] * d + iy[:, None, :, None]) * d
            + iz[:, None, None, :]).reshape(o.shape[0], -1)


def check_kernel_schedule(schedule) -> None:
    """Raise unless the window kernel takes ``schedule``: at most
    ``KERNEL_MAX_LEVELS`` levels, each window at most
    ``KERNEL_MAX_WIDTH`` cells wide (its open flags, W^3 bits, live in
    shared memory).  Every default schedule and the tests' tiny ones
    pass; the torch twin keeps the same limits, so no schedule runs on
    the CPU that the card would refuse."""
    if len(schedule) > KERNEL_MAX_LEVELS:
        raise ValueError(
            f"window_schedule has {len(schedule)} levels; the dense "
            f"collector takes at most {KERNEL_MAX_LEVELS}")
    wide = [w for w in schedule if w > KERNEL_MAX_WIDTH]
    if wide:
        raise ValueError(
            f"window_schedule {tuple(schedule)}: widths {wide} exceed the "
            f"dense collector's {KERNEL_MAX_WIDTH} cells a window")


def _dense_lists(bbox, spyr: SpatialPyramid, origins, sched, *, theta,
                 softening, list_cap, direct_cap, direct_cell_max,
                 quarter_bits):
    """The window walk and its two stable compactions in PyTorch: the
    plain twin of ``csrc/collect_dense3.cu`` (CPU tensors).  Returns
    (outs, overflow [G], escape [G]): outs are the approx list (x, y, z,
    m) [G, min(F, list_cap)], the direct starts and counts [G, min(F,
    direct_cap)] and, with ``quarter_bits``, the direct cells' fail bits,
    com x, y, z and mass; F is the windows' cells over all levels."""
    x0, x1, y0, y1, z0, z1 = bbox
    g = x0.shape[0]
    dev = x0.device
    md = spyr.max_depth
    lows, highs = (x0, y0, z0), (x1, y1, z1)

    app = ([], [], [], [], [])  # x, y, z, m, mask
    dir_s, dir_c, dir_mask = [], [], []
    dir_q = ([], [], [], [], [])  # quarter_bits payload: bits, x, y, z, m
    escape = torch.zeros((g,), dtype=torch.bool, device=dev)
    prev_open = torch.ones((g, 1, 1, 1), dtype=torch.bool, device=dev)
    gidx = torch.arange(g, device=dev)[:, None, None, None]

    for lv, w in enumerate(sched):
        d = 1 << lv
        p = w ** 3
        o = origins[lv]
        is_last = lv == md
        grid = spyr.grid[lv].reshape(-1, 5)
        start = spyr.start[lv].reshape(-1)
        if w == d:  # the window is the whole level: no per-group copy
            cells = grid[None].expand(g, p, 5)
            start = start[None].expand(g, p)
        else:
            flat = _window_index(o, w, d)
            cells, start = grid[flat], start[flat]
        m, cx, cy, cz, cnt = cells.unbind(-1)  # each [G, P]

        # reached: the parent window's open flags, upsampled 2x per axis;
        # even origins put the child window's parent span at
        # r_off = o // 2 - o_parent, inside the parent window
        if lv == 0:
            reached = torch.ones((g, 1), dtype=torch.bool, device=dev)
        else:
            r_off = torch.div(o, 2, rounding_mode="floor") - origins[lv - 1]
            half = torch.arange(w, device=dev) // 2
            px, py, pz = (r_off[:, a:a + 1].long() + half for a in range(3))
            reached = prev_open[gidx, px[:, :, None, None],
                                py[:, None, :, None],
                                pz[:, None, None, :]].reshape(g, p)

        d_min, d_q = _theta_distances((cx, cy, cz), lows, highs, softening,
                                      quarter_bits)
        size = level_cell_size_3d(spyr.bounds, lv)
        theta_ok = size < theta * d_min

        nonempty = reached & (cnt > 0) & (m > MASS_SKIP_THRESHOLD)
        single = nonempty & (cnt == 1.0)
        multi = nonempty & (cnt > 1.0)
        approx = single | (multi & (theta_ok | is_last))
        direct = multi & ~theta_ok & (cnt <= direct_cell_max)
        if is_last:
            direct = torch.zeros_like(direct)

        for lst, v in zip(app, [cx, cy, cz, torch.where(approx, m, 0.0),
                                approx]):
            lst.append(v)
        dir_s.append(torch.where(direct, start, 0))
        dir_c.append(torch.where(direct, cnt.to(torch.int32), 0))
        dir_mask.append(direct)
        if quarter_bits:
            bits = _quarter_fail_bits(size, theta, d_q)
            for lst, v in zip(dir_q, [torch.where(direct, bits, 0), cx, cy,
                                      cz, torch.where(direct, m, 0.0)]):
                lst.append(v)
        if is_last:
            break

        # escape check: every child of an opened cell must land inside
        # the next level's window, else the group's dense lists are
        # incomplete and it spills (its open flag is dropped so the
        # dense outputs stay self-consistent)
        open_ = multi & ~theta_ok & ~direct
        wn, on = sched[lv + 1], origins[lv + 1]
        ar = torch.arange(w, dtype=torch.int32, device=dev)
        inside = []
        for a in range(3):
            c2 = 2 * (o[:, a:a + 1] + ar)  # [G, W]: first child cell
            oa = on[:, a:a + 1]
            inside.append((c2 >= oa) & (c2 + 1 <= oa + wn - 1))
        within = (inside[0][:, :, None, None] & inside[1][:, None, :, None]
                  & inside[2][:, None, None, :]).reshape(g, p)
        escape = escape | (open_ & ~within).any(1)
        prev_open = (open_ & within).reshape(g, w, w, w)

    (lx, ly, lz, lm), ovf_a = _sort_compact(
        torch.cat(app[4], 1), [torch.cat(a, 1) for a in app[:4]], list_cap)
    payload = [torch.cat(dir_s, 1), torch.cat(dir_c, 1)]
    if quarter_bits:
        payload += [torch.cat(a, 1) for a in dir_q]
    outs, ovf_d = _sort_compact(torch.cat(dir_mask, 1), payload, direct_cap)
    return [lx, ly, lz, lm] + outs, ovf_a | ovf_d, escape


def _dense_lists_kernel(bbox, spyr: SpatialPyramid, origins, sched, *,
                        theta, softening, list_cap, direct_cap,
                        direct_cell_max, quarter_bits):
    """:func:`_dense_lists` on the card: one launch of
    ``dense_collect3_kernel`` (``csrc/collect_dense3.cu``), bit-equal to
    the twin.  Outputs and scratch come from ``torch.empty`` on the
    current stream and nothing is read on the host, so a CUDA graph can
    hold it."""
    global DENSE_KERNEL_LAUNCHES
    from . import _cuda

    dev = bbox[0].device
    g, q = bbox[0].shape
    if q > KERNEL_MAX_SUB_BOXES:
        raise ValueError(f"{q} sub-boxes a group; the dense collector's "
                         f"kernel takes at most {KERNEL_MAX_SUB_BOXES}")
    if quarter_bits and q % 4:
        raise ValueError(f"quarter bits need Q % 4 == 0 sub-bboxes, got {q}")
    n_lv = len(sched)
    for lv in range(n_lv):
        d = 1 << lv
        _cuda.require(spyr.grid[lv], f"grid[{lv}]", torch.float32,
                      (d, d, d, 5), dev)
        _cuda.require(spyr.start[lv], f"start[{lv}]", torch.int32,
                      (d, d, d), dev)
    _cuda.require(spyr.bounds, "bounds", torch.float32, (6,), dev)
    boxes = torch.stack(bbox)  # [6, G, Q]
    orig = torch.stack(origins)  # [levels, G, 3]
    _cuda.require(boxes, "bbox", torch.float32, (6, g, q), dev)
    _cuda.require(orig, "origins", torch.int32, (n_lv, g, 3), dev)
    f = sum(w ** 3 for w in sched)
    wa, wd = min(f, list_cap), min(f, direct_cap)

    def empty(w, dtype=torch.float32):
        return torch.empty((g, w), dtype=dtype, device=dev)

    lists = [empty(wa) for _ in range(4)]
    direct = [empty(wd, torch.int32) for _ in range(2)]
    quarters = ([empty(wd, torch.int32)] + [empty(wd) for _ in range(4)]
                if quarter_bits else [])
    overflow = torch.empty((g,), dtype=torch.bool, device=dev)
    escape = torch.empty((g,), dtype=torch.bool, device=dev)
    tails = (empty(wa, torch.int32), empty(wd, torch.int32))
    ptrs = [t.data_ptr() for t in lists + direct]
    ptrs += [t.data_ptr() for t in quarters] or [None] * 5
    ptrs += [t.data_ptr() for t in (overflow, escape, *tails)]
    levels = [t.data_ptr() for t in spyr.grid[:n_lv]] + [
        t.data_ptr() for t in spyr.start[:n_lv]]
    with torch.cuda.device(dev):
        code = _cuda.library().nbody_dense_collect3(
            (ctypes.c_void_p * len(levels))(*levels),
            (ctypes.c_int * n_lv)(*sched), n_lv, boxes.data_ptr(),
            orig.data_ptr(), spyr.bounds.data_ptr(), g, q, theta, softening,
            MASS_SKIP_THRESHOLD, float(direct_cell_max), wa, wd, list_cap,
            direct_cap, (ctypes.c_void_p * len(ptrs))(*ptrs),
            int(quarter_bits), _cuda.stream_of(boxes))
    _cuda.check(code, "dense_collect3")
    with _cuda.counter_lock:
        DENSE_KERNEL_LAUNCHES += 1
    return lists + direct + quarters, overflow, escape


def collect_lists_3d_dense(
    bbox,  # 6 x [G, Q]: x0, x1, y0, y1, z0, z1
    tree: Octree,  # the Morton octree: the spill pass walks it
    spyr: SpatialPyramid,
    *,
    theta: float,
    softening: float,
    frontier_caps: Tuple[int, ...],  # the spill pass's walk caps
    list_cap: int,
    direct_cap: int,
    direct_cell_max: int,
    window_schedule: Tuple[int, ...] | None = None,
    spill_cap: int | None = None,
    quarter_bits: bool = False,
):
    """Drop-in dense replacement for ``bh3d._collect_lists_3d``, with the
    same return contract: ((lx, ly, lz, lm) [G, L], ranges [G, D, 2],
    overflow [G]), plus the quarters dict with ``quarter_bits``.

    Every cell is classified as the gather walk classifies it; only the
    traversal differs (windows and upsampled reached flags instead of
    gathered frontiers), and with it the order of each group's list
    entries.  The walk is one kernel for CUDA tensors and its torch twin
    for CPU tensors, bit for bit the same lists.  ``spill_cap`` escaped
    groups at most (default max(48, G // 4), the JAX package's budget)
    are collected again by the gather walk; further escapes set their
    overflow flag."""
    from .bh3d import _collect_lists_3d  # imports this module

    g = bbox[0].shape[0]
    dev = bbox[0].device
    md = spyr.max_depth
    sched = check_window_schedule(
        window_schedule or window_schedule_3d(md), md)
    check_kernel_schedule(sched)
    origins = _window_origins(bbox, spyr.bounds, sched)
    walk = _dense_lists_kernel if bbox[0].is_cuda else _dense_lists
    outs, overflow, escape = walk(
        bbox, spyr, origins, sched, theta=theta, softening=softening,
        list_cap=list_cap, direct_cap=direct_cap,
        direct_cell_max=direct_cell_max, quarter_bits=quarter_bits)
    lx = outs[0]

    # spill: the gather walk collects the first spill_cap escaped groups
    # again, exactly; the rest overflow
    if spill_cap is None:
        spill_cap = max(48, g // 4)
    spill_cap = min(spill_cap, g)
    esc_rank = torch.cumsum(escape.to(torch.int32), 0) - 1
    overflow = overflow | (escape & (esc_rank >= spill_cap))
    n_esc = escape.sum()

    def spill():
        # the escaped rows, a fixed spill_cap of them as in the JAX
        # package (no nonzero): sorted row ids, not escaped = INT_MAX
        key = torch.where(escape, torch.arange(g, device=dev), _INT_MAX)
        ids = torch.sort(key).values[:spill_cap]
        valid = ids != _INT_MAX
        safe = torch.where(valid, ids, 0)
        # compacted to the dense outputs' widths; the gather walk's own
        # overflow flag covers any truncation
        col = _collect_lists_3d(
            tuple(b[safe] for b in bbox), tree, theta=theta,
            softening=softening, frontier_caps=frontier_caps,
            list_cap=lx.shape[1], direct_cap=outs[4].shape[1],
            direct_cell_max=direct_cell_max, quarter_bits=quarter_bits)
        srcs = [*col[0], col[1][:, :, 0], col[1][:, :, 1]]
        if quarter_bits:
            q = col[3]
            srcs += [q["bits"], *q["com"], q["mass"]]
        # the JAX package scatters the rows that are not valid to a
        # dropped row; here they write the first valid row's results
        # again into its own row (the same bits, so no race), in place
        src_row = torch.where(valid, torch.arange(spill_cap, device=dev), 0)
        tgt = ids[src_row]
        for a, s_ in zip(outs, srcs):
            a.index_copy_(0, tgt, torch.nn.functional.pad(
                s_, (0, a.shape[1] - s_.shape[1]))[src_row])
        overflow.index_copy_(0, tgt, col[2][src_row])
        _graph.tally(("collect_dense3", "SPILL_PASSES"), 1)

    if spill_cap > 0:
        seen = _graph.device_if(n_esc, spill, "spill")
    else:
        seen = (None if _graph.capturing(n_esc)
                else _graph._host_value(n_esc))
    _graph.tally(("collect_dense3", "DENSE_PASSES"), 1)
    # outside capture the host count read by the gate; under capture
    # counted on the device
    _graph.tally(("collect_dense3", "ESCAPED_GROUPS"),
                 n_esc if seen is None else seen)

    lx, ly, lz, lm, ds, dc = outs[:6]
    res = ((lx, ly, lz, lm), torch.stack([ds, dc], dim=-1), overflow)
    if quarter_bits:
        res += (dict(bits=outs[6], com=tuple(outs[7:10]), mass=outs[10]),)
    return res
