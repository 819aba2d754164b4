"""Grouped Barnes-Hut in 3D over the octree (counterpart of
``nbody_tpu.ops.bh3d``: the gather walk, the dense window collector's
routing, and the runs evaluators).

The same method as the 2D grouped engine (``ops/bh_grouped.py``) with
eight children and 3-bit Morton shifts: bodies sorted by Morton code,
fixed-size groups with Q sub-bboxes, one conservative dual walk per group
over the dense pyramid (accept a cell iff size < theta * d_min, d_min the
group-bbox to cell-COM distance), close small cells emitted as Morton
body ranges, and the lists evaluated by the runs kernels: K3 (segment-
packed) where the run-length gate picks it, K2 otherwise, or K4 per
Morton quarter where quarter-split evaluation is on
(``ops/list_eval.py``).  The lists come from the gather walk
(:func:`_collect_lists_3d`) below N = 262,144 and from the dense window
collector (``ops/collect_dense3.py``) from there, as the JAX package's
gates decide.  Self-exclusion is index-free: singleton cells and
direct-range bodies carry bit-exact positions, so a body meeting itself
has d2 == 0 and the d2 > 0 guard drops it.

With ``eval_mode="grid"`` / ``"dynamic"`` (or ``compensated``) the
direct ranges expand to 8-body superblocks and each group's padded
two-section list goes to kernel K6 / K7, as in 2D, 64 groups at a time.
Every default resolves from N exactly as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from ..config import BH_SOFTENING, MASS_SKIP_THRESHOLD, THETA_DEFAULT
from ..utils.profiling import span
from . import _cuda, _graph, bh_grouped
from .bh_grouped import (
    _pow2_ceil,
    _quarter_fail_bits,
    _sort_compact,
    _theta_distances,
)
from .tree3d import (
    MAX_DEPTH3_WIDE,
    R3_CNT,
    R3_M,
    R3_MX,
    R3_MY,
    R3_MZ,
    R3_OCC,
    R3_SX,
    R3_SY,
    R3_SZ,
    Octree,
    build_octree,
    build_octree_adaptive,
    default_max_depth3,
    level_cell_size_3d,
    morton_codes_3d,
)


# groups whose walk entered the refinement below the pyramid (the
# adaptive engine), over all passes
REFINE_GROUPS = 0
# launches of csrc/collect_gather3.cu's kernel (one a gather walk on the
# card; counted under capture too: ``_graph.tally``)
GATHER_KERNEL_LAUNCHES = 0

# what the gather walk's kernel takes: levels (the adaptive tree's 22),
# sub-boxes a group, and rows a level (a tail code keeps 5 bits for the
# level and 26 for the cell)
GATHER_MAX_LEVELS = MAX_DEPTH3_WIDE + 1
GATHER_MAX_SUB_BOXES = 256
GATHER_MAX_ROWS = 1 << 26


def frontier_peak_3d(n_bodies: int) -> int:
    """3D cap scale ~4*N^(2/3), next power of two, in [2048, 32768] (the
    JAX package's measured-demand calibration)."""
    return min(32768, max(2048, _pow2_ceil(int(4 * n_bodies ** (2 / 3)))))


def direct_cell_max_default(n_bodies: int) -> int:
    """Largest cell emitted as a direct body range: 32 below 512K bodies,
    128 from there (the JAX package's N gate)."""
    return 32 if n_bodies < 524288 else 128


def default_group_size3(n_sources: int) -> int:
    """Morton group size: 4096 in the [256K, 768K) band, 2048 elsewhere."""
    return 4096 if 262144 <= n_sources < 786432 else 2048


def cap_defaults_3d(n_bodies: int) -> dict:
    """Interaction-list cap defaults (see nbody_tpu.ops.bh3d for the
    measured demand behind each)."""
    peak = frontier_peak_3d(n_bodies)
    dcm = direct_cell_max_default(n_bodies)
    if dcm >= 128:
        list_cap = max(4096, -(-(7 * peak // 16) // 2048) * 2048)
        direct_cap = max(2048, peak // 4)
    else:
        list_cap = max(4096, -(-(5 * peak // 4) // 2048) * 2048)
        direct_cap = max(2048, 3 * peak // 4)
    return dict(
        list_cap=list_cap,
        direct_cap=direct_cap,
        direct_body_cap=max(32768, (12 if dcm <= 32 else 20) * peak),
        frontier_cap=peak,
        run_cap=run_cap_default_3d(n_bodies),
    )


def run_cap_default_3d(n_bodies: int) -> int:
    """Merged-run cap: linear in N with headroom at dcm=32 (a multiple of
    128, floor 256), flat 640 at dcm=128."""
    if direct_cell_max_default(n_bodies) >= 128:
        return 640
    return max(256, -(-(768 * n_bodies // 262144) // 128) * 128)


def frontier_schedule_3d(peak: int, max_depth: int,
                         n_bodies: int) -> Tuple[int, ...]:
    """Per-level frontier capacities of the octree walk: the hump model
    below 512K bodies (dcm=32), the terminal-level model from there
    (dcm=128); see the JAX module for the measured demand."""
    hump = direct_cell_max_default(n_bodies) < 128
    lf = math.log(max(n_bodies, 128) / 16, 8)
    lo_star = min(max_depth, max(3, math.floor(lf)))
    dcm = direct_cell_max_default(n_bodies)
    l_t = min(
        max_depth, max(3, math.ceil(math.log(max(n_bodies // dcm, 8), 8)))
    )
    shape = []
    for level in range(max_depth + 1):
        if level <= 2:
            c = 8**level
        elif level == max_depth:
            c = peak if hump else peak // 2
        elif not hump:
            if level in (l_t, l_t + 1):
                c = 3 * peak // 8
            elif level > l_t + 1:
                c = peak // 4
            else:
                c = peak // 8
        elif level >= lo_star:
            c = peak
        else:
            c = peak >> min(lo_star - level, 3)
        shape.append(int(min(c, peak, 8**level)))
    return tuple(shape)


# a sparse level's frontier cap, a share of the peak: on evolved 1M
# Plummer spheres (peak 32,768) the most opened children entering a
# sparse level was 12,360 (PERF.md)
REFINE_FRONTIER_SHARE = 0.5


def frontier_schedule_adaptive(peak: int, max_depth: int,
                               n_bodies: int) -> Tuple[int, ...]:
    """The adaptive engine's per-level frontier capacities, levels 0 to
    ``tree3d.MAX_DEPTH3_WIDE``: the pyramid's levels as
    :func:`frontier_schedule_3d` (the walk there is the same), then
    ``REFINE_FRONTIER_SHARE`` of ``peak`` a sparse level."""
    shape = frontier_schedule_3d(peak, max_depth, n_bodies)
    sparse = max(1, int(peak * REFINE_FRONTIER_SHARE))
    return shape + (sparse,) * (MAX_DEPTH3_WIDE - max_depth)


def sub_boxes_3d(groups: torch.Tensor,
                 n_sub: int) -> Tuple[torch.Tensor, ...]:
    """The walk's sub-boxes: each group of ``groups`` [G, S, 3] (its
    targets in Morton order) split into ``n_sub`` runs of consecutive
    targets, and each run's bounds, as 6 x [G, n_sub]: x0, x1, y0, y1,
    z0, z1."""
    sub = groups.reshape(groups.shape[0], n_sub, -1, 3)
    return tuple(f(sub[..., a], 2) for a in range(3)
                 for f in (torch.amin, torch.amax))


def _collect_lists_3d(
    bbox: Tuple[torch.Tensor, ...],  # 6 x [G, Q]: x0, x1, y0, y1, z0, z1
    tree: Octree,
    *,
    theta: float,
    softening: float,
    frontier_caps: Tuple[int, ...],
    list_cap: int,
    direct_cap: int,
    direct_cell_max: int,
    quarter_bits: bool = False,
    window_cells=None,
    return_demand: bool = False,
    refine=None,
):
    """Per-group interaction lists via the dual cell-vs-bbox octree walk.

    Per frontier cell: singletons, theta-accepted cells and max-depth
    aggregates go to the approx list; close cells with
    2 <= count <= direct_cell_max go to the direct list as a Morton body
    range; other close cells open.  Every level runs (the JAX package's
    dead-level skip is a TPU-time saving with the same result; here it
    would cost a host sync per level).  Returns ((lx, ly, lz, lm) [G, L]
    approx list, zero-mass padded; ranges [G, D, 2] (start, count),
    zero-count padded; overflow [G] bool), and with ``quarter_bits`` a
    further item, the quarter-split payload of each direct entry:
    ``dict(bits=[G, D] int32 per-quarter theta-fail masks,
    com=(x, y, z) [G, D], mass=[G, D])``.  ``window_cells=(c_lo, c_hi)``
    gates direct emission to the sharded window's leaf cells, and
    ``return_demand=True`` appends the calibration dict (frontier demand
    per level, approx and direct maxima; :func:`frontier_schedule_3d`,
    :func:`cap_defaults_3d`), as in 2D (``bh_grouped._collect_lists``).

    ``refine`` (a ``tree3d.Refinement`` of ``tree``; the adaptive
    engine) carries the walk below the pyramid: a crowded cell opens to
    its children's range in the next sparse level, a close cell of at
    most ``direct_cell_max`` bodies is direct at every depth, the pyramid
    leaves included, and only a cell at ``tree3d.MAX_DEPTH3_WIDE`` is
    taken as one point whatever its count.  ``frontier_caps`` then has
    one cap a level to the refinement's depth.  Direct entries carry
    their first body directly.  Whether any group opens a crowded leaf is
    read on the host once (the sparse levels are skipped when none does);
    that many groups go to ``REFINE_GROUPS``.

    On the card the walk is one kernel (:func:`_gather_lists_kernel`,
    ``csrc/collect_gather3.cu``); CPU tensors take its plain twin,
    :func:`_gather_lists`, which gives the same bits."""
    walk = _gather_lists_kernel if bbox[0].is_cuda else _gather_lists
    return walk(bbox, tree, theta=theta, softening=softening,
                frontier_caps=frontier_caps, list_cap=list_cap,
                direct_cap=direct_cap, direct_cell_max=direct_cell_max,
                quarter_bits=quarter_bits, window_cells=window_cells,
                return_demand=return_demand, refine=refine)


def _gather_lists(
    bbox: Tuple[torch.Tensor, ...],  # 6 x [G, Q]: x0, x1, y0, y1, z0, z1
    tree: Octree,
    *,
    theta: float,
    softening: float,
    frontier_caps: Tuple[int, ...],
    list_cap: int,
    direct_cap: int,
    direct_cell_max: int,
    quarter_bits: bool = False,
    window_cells=None,
    return_demand: bool = False,
    refine=None,
):
    """:func:`_collect_lists_3d`'s walk in PyTorch: the plain twin of
    ``csrc/collect_gather3.cu`` (CPU tensors), with the same arguments
    and returns."""
    global REFINE_GROUPS
    x0, x1, y0, y1, z0, z1 = bbox
    g = x0.shape[0]
    dev = x0.device
    max_depth = tree.max_depth
    last = max_depth if refine is None else refine.depth
    overflow = torch.zeros((g,), dtype=torch.bool, device=dev)

    leaf_cum = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.cumsum(tree.leaf_counts(), 0, dtype=torch.int32),
    ])

    frontier = torch.zeros((g, 1), dtype=torch.int32, device=dev)  # root
    fcap = 1
    octant = torch.arange(8, dtype=torch.int32, device=dev)
    app = ([], [], [], [], [])  # x, y, z, m, mask
    dir_s, dir_c, dir_mask = [], [], []
    dir_q = ([], [], [], [], [])  # quarter_bits payload: bits, x, y, z, m
    demand = []  # return_demand: opened children entering each level

    for level in range(last + 1):
        valid = frontier >= 0
        idx = torch.where(valid, frontier, 0)
        sparse = level > max_depth
        rows = (refine.raw[level - max_depth - 1] if sparse
                else tree.raw[level])[idx.long()]  # [G, F, 16]
        m = rows[..., R3_M]
        cnt = rows[..., R3_CNT]
        safe = torch.where(m > 0, m, torch.ones_like(m))
        com = [torch.where(cnt == 1.0, rows[..., s], rows[..., w] / safe)
               for s, w in ((R3_SX, R3_MX), (R3_SY, R3_MY), (R3_SZ, R3_MZ))]

        d_min, d_q = _theta_distances(com, (x0, y0, z0), (x1, y1, z1),
                                      softening, quarter_bits)
        size = level_cell_size_3d(tree.bounds, level)
        theta_ok = size < theta * d_min

        nonempty = valid & (cnt > 0) & (m > MASS_SKIP_THRESHOLD)
        single = nonempty & (cnt == 1.0)
        multi = nonempty & (cnt > 1.0)
        at_leaf = level == (max_depth if refine is None
                            else MAX_DEPTH3_WIDE)
        approx = single | (multi & (theta_ok | at_leaf))
        direct = multi & ~theta_ok & (cnt <= direct_cell_max)
        if at_leaf:
            direct = torch.zeros_like(direct)
        if window_cells is not None:
            c_lo, c_hi = window_cells
            shift_w = 3 * (max_depth - level)
            direct = direct & ((idx << shift_w) >= c_lo) & (
                ((idx + 1) << shift_w) <= c_hi + 1)

        for lst, v in zip(app, com + [torch.where(approx, m, 0.0), approx]):
            lst.append(v)
        if refine is None:
            # direct cells ride as their first leaf cell; leaf_cum
            # resolves them to body ranges once, on the compacted list
            dir_s.append(idx << (3 * (max_depth - level)))
        elif sparse:
            dir_s.append(refine.start[level - max_depth - 1][idx.long()])
        else:
            dir_s.append(leaf_cum[(idx << (3 * (max_depth - level))).long()])
        dir_c.append(torch.where(direct, cnt.to(torch.int32), 0))
        dir_mask.append(direct)
        if quarter_bits:
            bits = _quarter_fail_bits(size, theta, d_q)
            for lst, v in zip(dir_q, [torch.where(direct, bits, 0), *com,
                                      torch.where(direct, m, 0.0)]):
                lst.append(v)

        if level == last:
            break

        open_ = multi & ~theta_ok & ~direct
        if level < max_depth:
            children = (idx[:, :, None] * 8 + octant).reshape(g, -1)
            occ = rows[..., R3_OCC].to(torch.int32)
            child_bits = ((occ[:, :, None] >> octant) & 1).reshape(g, -1)
        else:  # the refinement's child ranges
            kids = refine.child[level - max_depth][idx.long()]  # [G, F, 2]
            children = (kids[..., :1] + octant).reshape(g, -1)
            child_bits = (octant < kids[..., 1:]).reshape(g, -1).to(
                torch.int32)
        cmask = open_.repeat_interleave(8, dim=1) & (child_bits > 0)
        if return_demand:
            demand.append(cmask.sum(1).max())
        if refine is not None and level == max_depth:
            entering = _graph.host_read(cmask.any(1).sum())
            with _cuda.counter_lock:
                REFINE_GROUPS += entering
            if not entering:
                break

        next_cap = min(8 * fcap, frontier_caps[level + 1])
        if next_cap == 8 * fcap:
            # the cap cannot bind: carry the children with -1 holes, so
            # frontier widths and order stay the JAX package's
            frontier = torch.where(cmask, children, -1)
        else:
            (frontier,), ovf = _sort_compact(
                cmask, [torch.where(cmask, children, -1)], next_cap)
            overflow = overflow | ovf
        fcap = next_cap

    (lx, ly, lz, lm), ovf_a = _sort_compact(
        torch.cat(app[4], 1), [torch.cat(a, 1) for a in app[:4]], list_cap)
    payload = [torch.cat(dir_s, 1), torch.cat(dir_c, 1)]
    if quarter_bits:
        payload += [torch.cat(a, 1) for a in dir_q]
    compacted, ovf_d = _sort_compact(torch.cat(dir_mask, 1), payload,
                                     direct_cap)
    dleaf, dc = compacted[:2]
    has = dc > 0
    ds = (torch.where(has, dleaf, 0) if refine is not None else
          torch.where(has, leaf_cum[torch.where(has, dleaf, 0).long()], 0))
    overflow = overflow | ovf_a | ovf_d
    out = ((lx, ly, lz, lm), torch.stack([ds, dc], dim=-1), overflow)
    if quarter_bits:
        out += (dict(bits=compacted[2], com=tuple(compacted[3:6]),
                     mass=compacted[6]),)
    if return_demand:
        out += (bh_grouped.demand_stats(demand, app[4], dir_mask),)
    return out


def gather_widths(frontier_caps: Tuple[int, ...],
                  levels: int) -> Tuple[int, ...]:
    """The gather walk's frontier width at each of its first ``levels``
    levels: 1 at the root, then the least of 8x the level above and the
    level's cap (the twin's ``next_cap``)."""
    widths = [1]
    for level in range(1, levels):
        widths.append(min(8 * widths[-1], int(frontier_caps[level])))
    return tuple(widths)


def check_gather_kernel(n_sub: int, levels: int, *, quarter_bits: bool,
                        windowed: bool, refined: bool,
                        level_rows=()) -> None:
    """Raise unless the gather walk's kernel takes the walk: at most
    ``GATHER_MAX_LEVELS`` levels and ``GATHER_MAX_SUB_BOXES`` sub-boxes a
    group (a multiple of 4 with ``quarter_bits``), fewer than
    ``GATHER_MAX_ROWS`` rows a level, and no window on a refined walk
    (the sharded modes' window is the pyramid's leaf cells)."""
    if levels > GATHER_MAX_LEVELS:
        raise ValueError(f"a gather walk of {levels} levels; the kernel "
                         f"takes at most {GATHER_MAX_LEVELS}")
    if n_sub > GATHER_MAX_SUB_BOXES:
        raise ValueError(f"{n_sub} sub-boxes a group; the gather walk's "
                         f"kernel takes at most {GATHER_MAX_SUB_BOXES}")
    if quarter_bits and n_sub % 4:
        raise ValueError(
            f"quarter bits need Q % 4 == 0 sub-bboxes, got {n_sub}")
    if windowed and refined:
        raise ValueError("window_cells gate the pyramid's leaf cells; a "
                         "walk with a refinement takes no window")
    big = [k for k in level_rows if k >= GATHER_MAX_ROWS]
    if big:
        raise ValueError(f"levels of {big} rows; the gather walk's kernel "
                         f"takes fewer than {GATHER_MAX_ROWS} a level")


def check_gather_rows(rows: torch.Tensor, name: str,
                      device: torch.device) -> None:
    """Raise unless a level's packed rows are what the gather walk's
    kernel reads: float32 [K, 16] on ``device``, each row's 16 floats
    contiguous, rows a multiple of 4 floats apart (at least 16) from a
    16-byte start: the kernel reads a row's head 16 bytes at a time.  A
    refined level's rows may sit in a wider buffer (a stride of 32)."""
    if rows.device != device:
        raise ValueError(f"{name} is on {rows.device}, expected {device}")
    if rows.dtype != torch.float32:
        raise ValueError(f"{name} is {rows.dtype}, the kernel takes "
                         "torch.float32")
    if rows.ndim != 2 or rows.shape[1] != 16:
        raise ValueError(f"{name} has shape {tuple(rows.shape)}, expected "
                         "(K, 16)")
    step = rows.stride(0)
    if (rows.shape[0] > 1 and (step < 16 or step % 4)) or (
            rows.stride(1) != 1 or rows.data_ptr() % 16):
        raise ValueError(f"{name} has strides {rows.stride()} from offset "
                         f"{rows.data_ptr() % 16}: the kernel reads rows of "
                         "16 contiguous floats, a multiple of 4 floats "
                         "apart, from 16 bytes")


def _gather_lists_kernel(bbox, tree: Octree, *, theta: float,
                         softening: float, frontier_caps: Tuple[int, ...],
                         list_cap: int, direct_cap: int,
                         direct_cell_max: int, quarter_bits: bool = False,
                         window_cells=None, return_demand: bool = False,
                         refine=None):
    """:func:`_gather_lists` on the card: one launch of
    ``gather_collect3_kernel`` (``csrc/collect_gather3.cu``), bit-equal
    to the twin, every level in the launch.  Outputs and scratch come
    from ``torch.empty`` on the current stream.  With ``refine`` the
    groups that entered it are read on the host once, as the twin reads
    them (where none did, the outputs are cut to the twin's widths, which
    stop at the pyramid); nothing else is read, so a CUDA graph can hold
    the launch."""
    global REFINE_GROUPS
    x0 = bbox[0]
    dev = x0.device
    if not x0.is_cuda:
        raise ValueError("the gather walk's kernel takes CUDA tensors; "
                         "CPU tensors take bh3d._gather_lists")
    g, q = x0.shape
    md = tree.max_depth
    last = md if refine is None else refine.depth
    rows = list(tree.raw) + (list(refine.raw) if refine is not None else [])
    check_gather_kernel(q, last + 1, quarter_bits=quarter_bits,
                        windowed=window_cells is not None,
                        refined=refine is not None,
                        level_rows=[r.shape[0] for r in rows])
    widths = gather_widths(frontier_caps, last + 1)
    f = sum(widths)
    wa, wd = min(f, list_cap), min(f, direct_cap)
    starts = [None] * (md + 1)
    kids = [None] * (last + 1)
    if refine is not None:
        starts += list(refine.start)
        kids[md:md + len(refine.child)] = refine.child
    for lv, r in enumerate(rows):
        check_gather_rows(r, f"rows[{lv}]", dev)
        if starts[lv] is not None:
            _cuda.require(starts[lv], f"start[{lv}]", torch.int32,
                          (r.shape[0],), dev)
        if kids[lv] is not None:
            _cuda.require(kids[lv], f"child[{lv}]", torch.int32,
                          (r.shape[0], 2), dev)
    _cuda.require(tree.bounds, "bounds", torch.float32, (6,), dev)
    leaf_cum = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.cumsum(tree.leaf_counts(), 0, dtype=torch.int32),
    ])
    boxes = torch.stack(bbox)  # [6, G, Q]
    _cuda.require(boxes, "bbox", torch.float32, (6, g, q), dev)
    window = None
    if window_cells is not None:
        window = torch.stack([torch.as_tensor(c, device=dev).reshape(())
                              for c in window_cells]).to(torch.int32)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    lists = [empty(g, wa) for _ in range(4)]
    ranges = empty(g, wd, 2, dtype=torch.int32)
    quarters = ([empty(g, wd, dtype=torch.int32)] +
                [empty(g, wd) for _ in range(4)] if quarter_bits else [])
    overflow = empty(g, dtype=torch.bool)
    entered = empty(g, dtype=torch.bool)
    demand = empty(g, last, dtype=torch.int32) if return_demand else None
    totals = empty(g, 2, dtype=torch.int32)
    scratch = [empty(g, 2, max(widths), dtype=torch.int32),
               empty(g, wa, dtype=torch.int32),
               empty(g, wd, dtype=torch.int32) if quarter_bits else None]
    ptrs = [t.data_ptr() for t in lists + [ranges]]
    ptrs += [t.data_ptr() for t in quarters] or [None] * 5
    ptrs += [overflow.data_ptr(), entered.data_ptr(),
             None if demand is None else demand.data_ptr(),
             totals.data_ptr()]
    ptrs += [None if t is None else t.data_ptr() for t in scratch]
    levels = [r.data_ptr() for r in rows] + [
        None if t is None else t.data_ptr() for t in starts + kids]
    strides = [r.stride(0) if r.shape[0] > 1 else 16 for r in rows]
    with torch.cuda.device(dev):
        code = _cuda.library().nbody_gather_collect3(
            (ctypes.c_void_p * len(levels))(*levels),
            (ctypes.c_int * len(strides))(*strides),
            (ctypes.c_int * len(widths))(*widths), last + 1, md,
            md if refine is None else MAX_DEPTH3_WIDE, leaf_cum.data_ptr(),
            boxes.data_ptr(), tree.bounds.data_ptr(),
            None if window is None else window.data_ptr(), g, q, theta,
            softening, MASS_SKIP_THRESHOLD, float(direct_cell_max), wa, wd,
            list_cap, direct_cap, (ctypes.c_void_p * len(ptrs))(*ptrs),
            int(quarter_bits), int(refine is not None),
            _cuda.stream_of(boxes))
    _cuda.check(code, "gather_collect3")
    _graph.tally(("bh3d", "GATHER_KERNEL_LAUNCHES"), 1)

    n_dem = last
    if refine is not None and last > md:
        entering = _graph.host_read(entered.sum())
        with _cuda.counter_lock:
            REFINE_GROUPS += entering
        if not entering:
            # the twin stops at the pyramid: its widths, and the kernel's
            # first slots (the refinement's levels held only holes)
            f = sum(widths[:md + 1])
            cut_a, cut_d = min(f, list_cap), min(f, direct_cap)
            lists = [t[:, :cut_a].contiguous() for t in lists]
            ranges = ranges[:, :cut_d].contiguous()
            quarters = [t[:, :cut_d].contiguous() for t in quarters]
            n_dem = md + 1
    out = (tuple(lists), ranges, overflow)
    if quarter_bits:
        out += (dict(bits=quarters[0], com=tuple(quarters[1:4]),
                     mass=quarters[4]),)
    if return_demand:
        out += (dict(frontier=demand[:, :n_dem].amax(0).long(),
                     approx=totals[:, 0].amax().long(),
                     direct=totals[:, 1].amax().long()),)
    return out


# Groups per packed-list chunk on the grid / dynamic route: 3D direct
# sections are wide (one [64, 8, K] chunk is ~1.5 GB at N=1M), so the
# lists are built and evaluated this many groups at a time, as in the JAX
# package's _evaluate_pallas_3d.
EVAL_CHUNK_3D = 64

# The JAX package's auto gate for the dense window collector.
DENSE_COLLECT_MIN_N = 262144


def _resolve_collect(collect: str | None, n_sources: int) -> str:
    """``None``/``"auto"`` -> the N gate (dense at N >= 262,144, gather
    below); ``"gather"``/``"dense"`` force."""
    mode = collect or "auto"
    if mode == "auto":
        return "dense" if n_sources >= DENSE_COLLECT_MIN_N else "gather"
    if mode not in ("gather", "dense"):
        raise ValueError(f"collect must be gather|dense|auto, got {mode!r}")
    return mode


class Route3D(NamedTuple):
    """How a 3D grouped pass runs, resolved from its options and N."""

    eval_mode: str  # "runs" | "grid" | "dynamic"
    k_tile: int
    dense: bool  # the dense window collector (else the gather walk)
    group_size: int  # targets a group (at most N)
    n_sub: int  # sub-bboxes a group
    direct_cell_max: int
    split_eval: bool  # quarter-split evaluation (K4)
    seg_pack: int  # runs segments a kernel step may pack (K3 when > 1)


def resolve_route_3d(n: int, ns: int, *, eval_mode=None, compensated=False,
                     eval_k_tile=None, group_size=None, direct_cell_max=None,
                     split_eval=None, seg_pack=None,
                     collect=None) -> Route3D:
    """The route of a pass of ``n`` targets against ``ns`` sources: the
    evaluator, the collector, the group shape and the JAX package's auto
    gates for quarter-split evaluation (on only for the runs evaluator at
    dcm >= 128 and >= 768K bodies) and segment packing (requested at
    dcm <= 64 from 131,072 sources; whether a pass then packs is the
    run-length gate's decision, made per pass)."""
    eval_mode, k_tile = bh_grouped.resolve_eval(eval_mode, compensated,
                                                eval_k_tile, 512)
    if group_size is None:
        group_size = default_group_size3(ns)
    if direct_cell_max is None:
        direct_cell_max = direct_cell_max_default(ns)
    gs = min(group_size, max(n, 1))
    n_sub = max(4, gs // 128)
    if gs % n_sub:
        n_sub = 1
    if split_eval is None:
        split_eval = (eval_mode == "runs" and gs % 4 == 0 and gs >= 512
                      and n_sub % 4 == 0 and direct_cell_max >= 128
                      and ns >= 768 * 1024)
    elif split_eval and (gs % 4 or n_sub % 4):
        raise ValueError(
            "split_eval=True requires group_size and n_sub divisible by 4 "
            f"(got {gs}, {n_sub})")
    split_eval = bool(split_eval) and eval_mode == "runs"
    if seg_pack is None:
        seg_pack = 4 if direct_cell_max <= 64 and ns >= 131072 else 1
    if seg_pack > 1 and k_tile % (128 * seg_pack):
        seg_pack = 1
    return Route3D(eval_mode, k_tile, _resolve_collect(collect, ns) == "dense",
                   gs, n_sub, direct_cell_max, split_eval, seg_pack)


def bh3_accelerations_grouped(
    positions: torch.Tensor,  # [N, 3]
    masses: torch.Tensor,  # [N]
    *,
    g: float,
    theta: float = THETA_DEFAULT,
    max_depth: int | None = None,
    softening: float = BH_SOFTENING,
    group_size: int | None = None,
    frontier_cap: int | None = None,
    list_cap: int | None = None,
    direct_cap: int | None = None,
    direct_cell_max: int | None = None,
    direct_body_cap: int | None = None,
    return_diagnostics: bool = False,
    compensated: bool = False,
    eval_k_tile: int | None = None,
    eval_mode: str | None = None,
    run_cap: int | None = None,
    split_eval: bool | None = None,
    seg_pack: int | None = None,
    collect: str | None = None,
):
    """Grouped 3D Barnes-Hut accelerations [N, 3] (+ per-body overflow
    [N] with ``return_diagnostics``).  ``None`` caps resolve from
    :func:`cap_defaults_3d`, ``max_depth`` from
    :func:`tree3d.default_max_depth3`, ``group_size`` from
    :func:`default_group_size3`.  Spans: ``nbody.tree`` (the octree, the
    spatial pyramid, the source sort), then :func:`grouped_eval_3d`'s
    ``nbody.collect`` (the groups and the collector) and ``nbody.eval``
    (the tables, the evaluator, the un-sort)."""
    if positions.shape[1] != 3:
        raise ValueError("bh3_accelerations_grouped takes [N, 3] positions")
    n = positions.shape[0]
    if max_depth is None:
        max_depth = default_max_depth3(n)
    with span("nbody.tree"):
        tree = build_octree(positions, masses, max_depth=max_depth)
        spyr = None
        if _resolve_collect(collect, n) == "dense":
            from .collect_dense3 import build_spatial_pyramid

            spyr = build_spatial_pyramid(tree)
        src_order = torch.argsort(tree.codes, stable=True)
        psort = positions[src_order]
        sorted_srcs = (psort[:, 0].contiguous(), psort[:, 1].contiguous(),
                       psort[:, 2].contiguous(), g * masses[src_order])
    return grouped_eval_3d(
        positions, tree, sorted_srcs=sorted_srcs, g=g, theta=theta,
        softening=softening, group_size=group_size,
        frontier_cap=frontier_cap, list_cap=list_cap, direct_cap=direct_cap,
        direct_cell_max=direct_cell_max, direct_body_cap=direct_body_cap,
        return_diagnostics=return_diagnostics, target_sorted=psort,
        target_order=src_order, compensated=compensated,
        eval_k_tile=eval_k_tile, eval_mode=eval_mode, run_cap=run_cap,
        split_eval=split_eval, seg_pack=seg_pack, collect=collect,
        spyr=spyr,
    )


def cap_defaults_adaptive(n_bodies: int) -> dict:
    """The adaptive engine's cap defaults: :func:`cap_defaults_3d`'s,
    with 4x the direct cells and 2x the merged runs a group, and room
    for every body in one group's direct ranges (a group's direct cells
    are disjoint, so N always suffices).  On evolved 1M Plummer spheres
    the most a group took was 27,142 direct cells, 744 merged runs in a
    quarter and 1,048,573 direct bodies (a group whose sub-boxes span
    the core), against 8,192, 640 and 655,360 (PERF.md)."""
    caps = cap_defaults_3d(n_bodies)
    caps["direct_cap"] *= 4
    caps["run_cap"] *= 2
    caps["direct_body_cap"] = max(caps["direct_body_cap"], n_bodies)
    return caps


def bh3_accelerations_adaptive(
    positions: torch.Tensor,  # [N, 3]
    masses: torch.Tensor,  # [N]
    *,
    g: float,
    theta: float = THETA_DEFAULT,
    max_depth: int | None = None,
    softening: float = BH_SOFTENING,
    direct_cell_max: int | None = None,
    **kw,
):
    """Grouped 3D Barnes-Hut as deep as the state needs (the
    ``barnes_hut_adaptive`` engine): exactly the grouped method at depth
    ``tree3d.MAX_DEPTH3_WIDE`` with the bodies sorted stably by their
    63-bit codes.  The pyramid keeps ``max_depth`` (default
    :func:`tree3d.default_max_depth3`) and the sparse refinement hangs
    below its crowded leaves (``tree3d.build_octree_adaptive``, span
    ``nbody.refine`` inside ``nbody.tree``); the gather walk crosses into
    it.  Groups, sub-boxes, theta test, quarter split and evaluators are
    :func:`bh3_accelerations_grouped`'s, whose keyword options ``kw``
    takes (``collect`` excepted: the gather walk collects)."""
    if positions.shape[1] != 3:
        raise ValueError("bh3_accelerations_adaptive takes [N, 3] positions")
    n = positions.shape[0]
    if max_depth is None:
        max_depth = default_max_depth3(n)
    if direct_cell_max is None:
        direct_cell_max = direct_cell_max_default(n)
    with span("nbody.tree"):
        tree, refine, order = build_octree_adaptive(
            positions, masses, max_depth, direct_cell_max)
        psort = positions[order]
        sorted_srcs = (psort[:, 0].contiguous(), psort[:, 1].contiguous(),
                       psort[:, 2].contiguous(), g * masses[order])
    return grouped_eval_3d(
        positions, tree, sorted_srcs=sorted_srcs, g=g, theta=theta,
        softening=softening, direct_cell_max=direct_cell_max,
        target_sorted=psort, target_order=order, refine=refine, **kw)


def grouped_eval_3d(
    target_positions: torch.Tensor,  # [Nt, 3] bodies to accelerate
    tree: Octree,
    *,
    target_order: torch.Tensor | None = None,  # [Nt] stable Morton order
    target_sorted: torch.Tensor | None = None,  # [Nt, 3] in that order
    target_codes: torch.Tensor | None = None,  # [Nt] leaf codes in tree
    sorted_srcs,  # (x, y, z, g*m) [Ns] each, all sources in Morton order
    g: float,
    theta: float = THETA_DEFAULT,
    softening: float = BH_SOFTENING,
    group_size: int | None = None,
    frontier_cap: int | None = None,
    list_cap: int | None = None,
    direct_cap: int | None = None,
    direct_cell_max: int | None = None,
    direct_body_cap: int | None = None,
    return_diagnostics: bool = False,
    compensated: bool = False,
    eval_k_tile: int | None = None,
    eval_mode: str | None = None,
    run_cap: int | None = None,
    split_eval: bool | None = None,
    seg_pack: int | None = None,
    collect: str | None = None,
    spyr=None,
    window_cells=None,
    range_offset=None,
    n_sources_hint: int | None = None,
    refine=None,
):
    """Grouped 3D evaluation of targets against a prebuilt octree.

    The lists come from the dense window collector where ``collect``
    resolves to ``"dense"`` (it needs ``spyr``, the spatial pyramid of
    ``tree``: ``collect_dense3.build_spatial_pyramid``), else from the
    gather walk; they are evaluated per quarter (K4) where ``split_eval``
    resolves on, else by the runs evaluator (K3 or K2); on the CPU the
    kernels' twins.  With ``eval_mode="grid"`` or ``"dynamic"`` (and
    ``compensated``, which forces grid) the lists are packed per group
    with their gathered superblocks, 64 groups at a time, and evaluated
    by K6 or K7, behind either collector.

    Without ``target_order`` the targets are stably Morton-sorted here
    (by ``target_codes`` when given).  The sharded-source trio
    ``window_cells``, ``range_offset`` and ``n_sources_hint`` is the 2D
    one (``bh_grouped.grouped_eval``): every N-keyed default, cap and gate
    takes n_eff = ``n_sources_hint`` or Ns, and a windowed pass collects
    through the gather walk.  With ``refine`` (the adaptive engine's
    sparse levels below ``tree``) the gather walk collects, to the
    refinement's depth, on :func:`frontier_schedule_adaptive` and
    :func:`cap_defaults_adaptive`."""
    n = target_positions.shape[0]
    ns = n_sources_hint or sorted_srcs[0].shape[0]  # n_eff
    max_depth = tree.max_depth
    if target_order is None:
        if target_codes is None:
            target_codes = morton_codes_3d(target_positions, tree.bounds,
                                           max_depth)
        target_order = torch.argsort(target_codes, stable=True)
        target_sorted = target_positions[target_order]
    route = resolve_route_3d(
        n, ns, eval_mode=eval_mode, compensated=compensated,
        eval_k_tile=eval_k_tile, group_size=group_size,
        direct_cell_max=direct_cell_max, split_eval=split_eval,
        seg_pack=seg_pack,
        collect=("gather" if window_cells is not None or refine is not None
                 else collect))
    eval_mode, k_tile = route.eval_mode, route.k_tile
    gs, n_sub = route.group_size, route.n_sub
    direct_cell_max, split_eval = route.direct_cell_max, route.split_eval
    if route.dense and spyr is None:
        raise ValueError(
            "the dense collector (collect='dense', or 'auto' at N >= "
            "262,144) needs spyr=collect_dense3.build_spatial_pyramid(tree)")

    defaults = (cap_defaults_3d if refine is None
                else cap_defaults_adaptive)(ns)
    frontier_cap = frontier_cap or defaults["frontier_cap"]
    list_cap = list_cap or defaults["list_cap"]
    direct_cap = direct_cap or defaults["direct_cap"]
    direct_body_cap = direct_body_cap or defaults["direct_body_cap"]

    with span("nbody.collect"):
        # groups of gs Morton-consecutive targets, the last padded with
        # copies of the last body (a tight bbox; results sliced off)
        n_pad = ((n + gs - 1) // gs) * gs
        tsort = torch.cat(
            [target_sorted, target_sorted[-1:].expand(n_pad - n, 3)], dim=0)
        pg = tsort.reshape(-1, gs, 3)  # [G, S, 3]

        bbox = sub_boxes_3d(pg, n_sub)

        walk = dict(
            theta=theta, softening=softening,
            frontier_caps=(frontier_schedule_3d if refine is None
                           else frontier_schedule_adaptive)(
                               frontier_cap, max_depth, ns),
            list_cap=list_cap, direct_cap=direct_cap,
            direct_cell_max=direct_cell_max, quarter_bits=split_eval)
        if refine is not None:
            collected = _collect_lists_3d(bbox, tree, refine=refine, **walk)
        elif route.dense:
            from .collect_dense3 import collect_lists_3d_dense

            collected = collect_lists_3d_dense(bbox, tree, spyr, **walk)
        else:
            collected = _collect_lists_3d(
                bbox, tree, window_cells=window_cells, **walk)
        (lx, ly, lz, lm), ranges, overflow_g = collected[:3]
        if range_offset is not None:
            ranges = bh_grouped.window_local(ranges, range_offset)

    with span("nbody.eval"):
        rc = run_cap or defaults["run_cap"]
        kw = dict(g_const=g, softening=softening, k_tile=k_tile, run_cap=rc,
                  t_cap=direct_body_cap // k_tile + 2 * rc)
        if eval_mode != "runs":
            sb_idx, sb_lo, sb_hi, ovf_e = (
                bh_grouped._expand_ranges_superblocks(
                    ranges, direct_cell_max,
                    direct_body_cap // bh_grouped._SB + direct_cap))
            acc = bh_grouped._evaluate_pallas(
                pg, (lx, ly, lz), lm, (sb_idx, sb_lo, sb_hi),
                bh_grouped._superblock_pack(sorted_srcs), g_const=g,
                softening=softening, compensated=compensated,
                dynamic=eval_mode == "dynamic", k_tile=k_tile,
                eval_chunk=EVAL_CHUNK_3D)
        elif split_eval:
            acc, ovf_e = bh_grouped._evaluate_runs_split(
                pg, (lx, ly, lz), lm, ranges, collected[3],
                sorted_srcs[0:3], sorted_srcs[3], **kw)
        else:
            acc, ovf_e = bh_grouped._evaluate_runs(
                pg, (lx, ly, lz), lm, ranges, sorted_srcs[0:3],
                sorted_srcs[3], seg_pack=route.seg_pack, **kw)
        overflow_g = overflow_g | ovf_e

        # un-sort: ``target_order`` is a permutation, so one scatter
        # restores body order (unique indices: deterministic)
        out = torch.empty((n, 3), dtype=acc.dtype, device=acc.device)
        out[target_order] = acc.reshape(-1, 3)[:n]
        if return_diagnostics:
            ovf = torch.empty((n,), dtype=torch.bool, device=acc.device)
            ovf[target_order] = overflow_g.repeat_interleave(gs)[:n]
            return out, ovf
        return out
