"""Grouped Barnes-Hut: Morton-sorted body groups share one traversal
(counterpart of ``nbody_tpu.ops.bh_grouped``, its kernel routes).

Bodies are sorted by Morton code and cut into groups; each group walks
the pyramid once with a conservative acceptance test (cell size over the
distance from the group's sub-bboxes to the cell COM), emitting an
approx list of accepted cells and the body ranges of close cells; the
ranges are merged into Morton runs and the list is evaluated by kernel
K2 (``ops/list_eval.list_eval_runs``), or, with quarter-split evaluation,
per Morton quarter of each group by kernel K4
(``ops/list_eval.list_eval_runs_split``).  See the JAX module's docstring
for the method and the self-exclusion argument (bit-exact singleton
COMs, d2 > 0).

With ``eval_mode="grid"`` or ``"dynamic"`` (and with ``compensated``,
which forces grid) the direct ranges expand instead to 8-body
superblocks and each group's approx cells and gathered direct bodies are
packed into one padded two-section list, evaluated by kernel K6 (grid,
Kahan-compensated on request) or K7 (dynamic) (``ops/list_eval``).

Shapes are static, as in the JAX package: every cap is fixed before the
step and overflowing groups raise a flag.  The segment-packing gate of
:func:`_evaluate_runs` when ``seg_pack > 1`` (kernel K3 or K2) is a
device conditional (``ops/_graph.py``), so a CUDA graph holds the pass.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import (
    BH_SOFTENING,
    MASS_SKIP_THRESHOLD,
    MAX_DEPTH_DEFAULT,
    THETA_DEFAULT,
)
from ..utils.profiling import span
from . import list_eval
from .tree import (
    RAW_CNT,
    RAW_M,
    RAW_MX,
    RAW_MY,
    RAW_OCC,
    RAW_SX,
    RAW_SY,
    Quadtree,
    build_quadtree,
    level_cell_size,
    morton_codes,
)

_INT_MAX = 2**31 - 1

# 2D default Morton group size (see nbody_tpu.ops.bh_grouped).
DEFAULT_GROUP_SIZE = 2048

# Segment-packing gate of the runs evaluator: the mean merged-run length
# (lanes) at or above which ``seg_pack > 1`` takes the packed tables
# (kernel K3); below it, the plain ones (K2).  The JAX package's value,
# calibrated on the TPU (nbody_tpu.ops.bh_grouped); a module constant so
# a test can force either branch.
SEG_PACK_MIN_RUN_LANES = 112.0


def _pow2_ceil(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length()


def frontier_peak(n_bodies: int) -> int:
    """Peak frontier demand ~4*sqrt(N), next power of two, in
    [1024, 8192] (the JAX package's calibration)."""
    return min(8192, max(1024, _pow2_ceil(int(4 * n_bodies**0.5))))


def cap_defaults(group_size: int, n_bodies: int) -> dict:
    """Interaction-list cap defaults, the JAX package's measured-demand
    calibration (see nbody_tpu.ops.bh_grouped.cap_defaults)."""
    peak = frontier_peak(n_bodies)
    return dict(
        list_cap=max(2048, -(-(7 * peak // 4) // 2048) * 2048),
        direct_cap=min(max(2560, 3 * peak // 4), max(256, n_bodies // 2)),
        direct_body_cap=max(24576, 16 * peak),
        frontier_cap=peak,
        run_cap=256,
    )


def frontier_schedule(peak: int, max_depth: int,
                      n_bodies: int) -> Tuple[int, ...]:
    """Per-level frontier capacities: the full peak from the uniform-state
    hump level log4(N/16) down to max_depth, 2*peak on the deepest two
    levels, a pruned ramp above (see the JAX module for the measured
    failure modes behind each rule)."""
    lf = math.log(max(n_bodies, 256) / 16, 4)
    lo_star = min(max_depth, max(4, math.floor(lf)))
    shape = []
    for level in range(max_depth + 1):
        if level <= 3:
            c = 4**level
        elif level >= max_depth - 1:
            c = 2 * peak
        elif level >= lo_star:
            c = peak
        else:
            c = peak >> min(lo_star - level, 3)
        shape.append(int(min(c, 2 * peak, 4**level)))
    return tuple(shape)


def _sort_compact(mask: torch.Tensor, arrays, cap: int):
    """Compact masked row entries to the left (keeping their order) and
    truncate to ``cap``: a stable sort on ``~mask``.  Returns (compacted
    arrays [G, min(F, cap)], overflow [G] bool)."""
    order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)
    order = order[:, :cap]
    out = [torch.gather(a, 1, order) for a in arrays]
    return out, mask.sum(1) > cap


def _theta_distances(coms, lows, highs, softening: float, quarters: bool):
    """Distance from each cell COM to its group's nearest sub-bbox, plus
    the softening: ``d_min`` [G, F], and with ``quarters`` the same per
    Morton quarter of the Q sub-bboxes (quarter q = sub-bboxes
    [qQ/4, (q+1)Q/4)), [G, 4, F].

    coms: D arrays [G, F]; lows, highs: D arrays [G, Q].  The squared
    distances are taken a quarter of the sub-bboxes at a time, so
    [G, Q/4, F] is the largest live tensor, and ``sqrt`` comes after the
    min, as the JAX package takes it: min is exact and sqrt monotone and
    correctly rounded, so every verdict is bit-equal to its one-shot
    [G, Q, F] form."""
    q = lows[0].shape[1]
    parts = 4 if q % 4 == 0 else 1
    if quarters and parts != 4:
        raise ValueError(f"quarter bits need Q % 4 == 0 sub-bboxes, got {q}")
    mins = []
    for k in range(parts):
        sl = slice(k * q // parts, (k + 1) * q // parts)
        d2 = None
        for c, lo, hi in zip(coms, lows, highs):
            ce = c[:, None, :]  # [G, 1, F]
            da = torch.clamp(torch.maximum(lo[:, sl, None] - ce,
                                           ce - hi[:, sl, None]), min=0.0)
            d2 = da * da if d2 is None else d2 + da * da
        mins.append(d2.min(dim=1).values)
    dq = torch.stack(mins, dim=1)  # [G, parts, F]
    d_min = torch.sqrt(dq.min(dim=1).values) + softening
    return d_min, (torch.sqrt(dq) + softening if quarters else None)


def _quarter_fail_bits(size: torch.Tensor, theta: float,
                       d_q: torch.Tensor) -> torch.Tensor:
    """Per-quarter theta verdicts [G, 4, F] -> int32 masks [G, F]: bit q
    set where the cell is too close for quarter q's own bodies
    (``size >= theta * d_q``)."""
    bit = 1 << torch.arange(4, dtype=torch.int32, device=d_q.device)
    fail = size >= theta * d_q
    return torch.where(fail, bit[None, :, None], 0).sum(1, dtype=torch.int32)


def _collect_lists(
    bbox: Tuple[torch.Tensor, ...],  # 4 x [G, Q]: x0, x1, y0, y1
    tree: Quadtree,
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
):
    """Per-group interaction lists via a dual (cell-vs-group-bbox) walk.

    Per frontier cell: singletons, theta-accepted cells and max-depth
    aggregates go to the approx list; close cells with
    2 <= count <= direct_cell_max go to the direct list as a Morton body
    range; other close cells open.  Returns ((lx, ly, lm) [G, L] approx
    list, zero-mass padded; ranges [G, D, 2] (start, count), zero-count
    padded; overflow [G] bool), and with ``quarter_bits`` a further item,
    the quarter-split payload of each direct entry: ``dict(bits=[G, D]
    int32 per-quarter theta-fail masks, com=(x, y) [G, D], mass=[G, D])``
    (a direct cell fails theta for at least one quarter).

    ``window_cells=(c_lo, c_hi)`` (int32 device scalars: no host read)
    restricts direct emission to cells whose leaf span lies inside
    [c_lo, c_hi], the sources a sharded rank holds
    (``parallel/steps.py``); out-of-window close cells open on to
    singletons and max-depth aggregates, which need only the replicated
    pyramid.

    ``return_demand=True`` appends the calibration dict of the JAX
    package's walk (the measurements behind :func:`frontier_schedule` and
    :func:`cap_defaults`; ``scripts/demand.py``), device tensors read by
    no host: ``frontier`` [max_depth], the max over groups of the opened
    children entering each level, and ``approx`` / ``direct``, the max
    over groups of the list masks' totals, all counted before truncation
    but only as deep as the given caps let the walk reach."""
    x0, x1, y0, y1 = bbox
    g = x0.shape[0]
    dev = x0.device
    max_depth = tree.max_depth
    overflow = torch.zeros((g,), dtype=torch.bool, device=dev)

    leaf_cnt = tree.raw[max_depth][:, RAW_CNT].to(torch.int32)
    leaf_cum = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.cumsum(leaf_cnt, 0, dtype=torch.int32),
    ])

    frontier = torch.zeros((g, 1), dtype=torch.int32, device=dev)  # root
    fcap = 1
    quad = torch.arange(4, dtype=torch.int32, device=dev)
    app_x, app_y, app_m, app_mask = [], [], [], []
    dir_s, dir_c, dir_mask = [], [], []
    dir_q = ([], [], [], [])  # quarter_bits payload: bits, x, y, m
    demand = []  # return_demand: opened children entering each level

    for level in range(max_depth + 1):
        valid = frontier >= 0
        idx = torch.where(valid, frontier, 0)
        rows = tree.raw[level][idx.long()]  # [G, F, 8]
        m = rows[..., RAW_M]
        cnt = rows[..., RAW_CNT]
        safe = torch.where(m > 0, m, torch.ones_like(m))
        cx = torch.where(cnt == 1.0, rows[..., RAW_SX], rows[..., RAW_MX] / safe)
        cy = torch.where(cnt == 1.0, rows[..., RAW_SY], rows[..., RAW_MY] / safe)

        d_min, d_q = _theta_distances((cx, cy), (x0, y0), (x1, y1),
                                      softening, quarter_bits)
        size = level_cell_size(tree.bounds, level)
        theta_ok = size < theta * d_min

        nonempty = valid & (cnt > 0) & (m > MASS_SKIP_THRESHOLD)
        single = nonempty & (cnt == 1.0)
        multi = nonempty & (cnt > 1.0)
        at_leaf = level == max_depth
        approx = single | (multi & (theta_ok | at_leaf))
        direct = multi & ~theta_ok & (cnt <= direct_cell_max)
        if at_leaf:
            direct = torch.zeros_like(direct)
        if window_cells is not None:
            # a cell at this level spans leaf cells [idx << s, (idx+1) << s)
            c_lo, c_hi = window_cells
            shift_w = 2 * (max_depth - level)
            direct = direct & ((idx << shift_w) >= c_lo) & (
                ((idx + 1) << shift_w) <= c_hi + 1)

        app_x.append(cx)
        app_y.append(cy)
        app_m.append(torch.where(approx, m, torch.zeros_like(m)))
        app_mask.append(approx)
        # direct cells ride as their first leaf cell; leaf_cum resolves
        # them to body ranges once, on the compacted list
        dir_s.append(idx << (2 * (max_depth - level)))
        dir_c.append(torch.where(direct, cnt.to(torch.int32), 0))
        dir_mask.append(direct)
        if quarter_bits:
            bits = _quarter_fail_bits(size, theta, d_q)
            for lst, v in zip(dir_q, (torch.where(direct, bits, 0), cx, cy,
                                      torch.where(direct, m, 0.0))):
                lst.append(v)

        if at_leaf:
            break

        open_ = multi & ~theta_ok & ~direct
        children = (idx[:, :, None] * 4 + quad).reshape(g, -1)
        occ = rows[..., RAW_OCC].to(torch.int32)
        child_bits = ((occ[:, :, None] >> quad) & 1).reshape(g, -1)
        cmask = open_.repeat_interleave(4, dim=1) & (child_bits > 0)
        if return_demand:
            demand.append(cmask.sum(1).max())

        next_cap = min(4 * fcap, frontier_caps[level + 1])
        if next_cap == 4 * fcap:
            # the cap cannot bind: carry the children with -1 holes
            frontier = torch.where(cmask, children, -1)
        else:
            (frontier,), ovf = _sort_compact(
                cmask, [torch.where(cmask, children, -1)], next_cap)
            overflow = overflow | ovf
        fcap = next_cap

    (lx, ly, lm), ovf_a = _sort_compact(
        torch.cat(app_mask, 1),
        [torch.cat(app_x, 1), torch.cat(app_y, 1), torch.cat(app_m, 1)],
        list_cap,
    )
    payload = [torch.cat(dir_s, 1), torch.cat(dir_c, 1)]
    if quarter_bits:
        payload += [torch.cat(a, 1) for a in dir_q]
    compacted, ovf_d = _sort_compact(torch.cat(dir_mask, 1), payload,
                                     direct_cap)
    dleaf, dc = compacted[:2]
    has = dc > 0
    ds = torch.where(has, leaf_cum[torch.where(has, dleaf, 0).long()], 0)
    overflow = overflow | ovf_a | ovf_d
    out = ((lx, ly, lm), torch.stack([ds, dc], dim=-1), overflow)
    if quarter_bits:
        out += (dict(bits=compacted[2], com=tuple(compacted[3:5]),
                     mass=compacted[5]),)
    if return_demand:
        out += (demand_stats(demand, app_mask, dir_mask),)
    return out


def demand_stats(demand, app_mask, dir_mask) -> dict:
    """The walks' ``return_demand`` dict from the per-level opened-children
    maxima and the per-level list masks."""
    return dict(frontier=torch.stack(demand),
                approx=torch.cat(app_mask, 1).sum(1).max(),
                direct=torch.cat(dir_mask, 1).sum(1).max())


def _expand_runs_tiles(runs: torch.Tensor, k_tile: int, t_cap: int):
    """Merged body runs -> per-group direct k-tile table for the runs
    evaluator.

    Each run [start, start+count) is rounded down to a 128-aligned base
    and becomes ceil((start%128 + count)/k_tile) tiles of (aligned tile
    start, first valid lane, one-past-last valid lane).  A scatter-max of
    each run's index at its first slot plus a running max gives every
    slot its run; offsets past ``t_cap`` are dropped, so an overflowing
    group never spills into its neighbour.

    runs: [G, R, 2].  Returns (tiles [G, 3, T] int32, n_tiles [G] int32
    clamped to T, overflow [G] bool)."""
    g, r, _ = runs.shape
    dev = runs.device
    starts, counts = runs[:, :, 0].long(), runs[:, :, 1].long()
    base = starts - starts % 128
    n_t = (starts - base + counts + k_tile - 1) // k_tile
    total = n_t.sum(1)
    offsets = torch.cumsum(n_t, 1) - n_t
    kidx = torch.arange(r, device=dev).expand(g, r)
    row0 = torch.arange(g, device=dev)[:, None] * t_cap
    flat_pos = torch.where((n_t > 0) & (offsets < t_cap), row0 + offsets,
                           g * t_cap)
    marks = torch.zeros(g * t_cap + 1, dtype=torch.long, device=dev)
    marks.scatter_reduce_(0, flat_pos.reshape(-1), kidx.reshape(-1), "amax")
    k = torch.cummax(marks[:-1].reshape(g, t_cap), dim=1).values
    j = torch.arange(t_cap, device=dev)
    packed = torch.stack([base, starts, starts + counts, offsets],
                         dim=-1).reshape(g * r, 4)
    rows = packed[torch.arange(g, device=dev)[:, None] * r + k]  # [G, T, 4]
    ts = rows[:, :, 0] + (j[None, :] - rows[:, :, 3]) * k_tile
    lo = (rows[:, :, 1] - ts).clamp(0, k_tile)
    hi = (rows[:, :, 2] - ts).clamp(0, k_tile)
    mask = j[None, :] < total[:, None]
    tiles = torch.stack([torch.where(mask, ts, 0), torch.where(mask, lo, 0),
                         torch.where(mask, hi, 0)], dim=1)
    return (tiles.to(torch.int32), total.clamp(max=t_cap).to(torch.int32),
            total > t_cap)


def _approx_table(coord_lists, lm: torch.Tensor, g_const: float,
                  k_tile: int):
    """Approx lists -> the evaluators' table [G, 8, A] (rows: coordinates,
    g*m, zero rows; A padded to a multiple of k_tile) and the occupied
    lanes per group [G] int32."""
    dims = len(coord_lists)
    apad = (-coord_lists[0].shape[1]) % k_tile
    cl = [torch.nn.functional.pad(a, (0, apad)) for a in coord_lists]
    lmp = torch.nn.functional.pad(lm, (0, apad))
    gg, a_width = cl[0].shape
    approx = torch.cat(
        [torch.stack(cl + [g_const * lmp], dim=1),
         torch.zeros((gg, 8 - dims - 1, a_width), dtype=lm.dtype,
                     device=lm.device)],
        dim=1,
    )
    return approx, (lmp > 0).sum(1).to(torch.int32)


def _source_table(sorted_coords, sorted_gm: torch.Tensor, k_tile: int):
    """All sorted sources transposed, [8, Ns + k_tile]: coordinates, g*m,
    zero rows; the tail pad keeps every tile start < Ns in bounds."""
    ns = sorted_coords[0].shape[0]
    srct = torch.zeros((8, ns + k_tile), dtype=sorted_gm.dtype,
                       device=sorted_gm.device)
    for d_, c in enumerate(sorted_coords):
        srct[d_, :ns] = c
    srct[len(sorted_coords), :ns] = sorted_gm
    return srct


def _evaluate_runs(
    positions_grouped: torch.Tensor,  # [G, S, D]
    coord_lists,  # D approx coordinate arrays [G, L]
    lm: torch.Tensor,  # [G, L] approx masses (zero-padded)
    ranges: torch.Tensor,  # [G, D_cells, 2] direct body ranges
    sorted_coords,  # D arrays [Ns]: all sources, Morton order
    sorted_gm: torch.Tensor,  # [Ns]
    *,
    g_const: float,
    softening: float,
    k_tile: int,
    run_cap: int,
    t_cap: int,
    seg_pack: int = 1,
):
    """Gather-free evaluation (``_evaluate_pallas_runs`` in the JAX
    package): builds the approx table [G, 8, A], merges the direct ranges
    into runs, expands them to the k-tile table and runs
    ``list_eval_runs``.

    With ``seg_pack = P > 1`` the mean merged-run length decides, as the
    JAX package's ``lax.cond`` does: at or above
    ``SEG_PACK_MIN_RUN_LANES`` the runs expand at k_tile/P lanes and P
    segments pack into each kernel step (K3); below, the plain tables
    (K2).  The decision stays on the device (``_graph.device_cond``): one
    host read outside capture, two conditional nodes in a CUDA graph.
    Returns (acc [G, S, D], overflow [G])."""
    from . import _graph
    from .experiments import merge_ranges  # imports this module

    approx, a_lanes = _approx_table(coord_lists, lm, g_const, k_tile)
    merged, ovf_m = merge_ranges(ranges, cap=run_cap)
    srct = _source_table(sorted_coords, sorted_gm, k_tile)

    def evaluate(pack: int, tiles, n_tiles):
        lens = torch.stack([a_lanes, n_tiles])
        return list_eval.list_eval_runs(
            positions_grouped, approx, srct, tiles, lens,
            softening=float(softening), k_tile=k_tile, seg_pack=pack)

    if seg_pack == 1:
        tiles, n_tiles, ovf_t = _expand_runs_tiles(merged, k_tile, t_cap)
        return evaluate(1, tiles, n_tiles), ovf_m | ovf_t

    # both branches write here (a graph after the gate reads fixed
    # addresses); each keeps the bits it has alone
    acc = torch.empty_like(positions_grouped)
    ovf_t = torch.empty_like(ovf_m)

    def packed():
        # segment-granular table; the body-volume part of the capacity
        # scales by P, the per-run slack does not
        seg_cap = max(t_cap, (t_cap - 2 * run_cap) * seg_pack + 2 * run_cap)
        tiles, n_segs, ovf = _expand_runs_tiles(
            merged, k_tile // seg_pack, seg_cap)
        acc.copy_(evaluate(seg_pack, tiles,
                           (n_segs + seg_pack - 1) // seg_pack))
        ovf_t.copy_(ovf)

    def plain():
        tiles, n_tiles, ovf = _expand_runs_tiles(merged, k_tile, t_cap)
        acc.copy_(evaluate(1, tiles, n_tiles))
        ovf_t.copy_(ovf)

    counts = merged[:, :, 1]
    n_runs = (counts > 0).sum().clamp(min=1)
    mean_len = counts.sum().to(torch.float32) / n_runs.to(torch.float32)
    _graph.device_cond(mean_len >= SEG_PACK_MIN_RUN_LANES, packed, plain,
                       names=("packed (K3)", "plain (K2)"))
    return acc, ovf_m | ovf_t


def _evaluate_runs_split(
    positions_grouped: torch.Tensor,  # [G, S, D]
    coord_lists,  # D approx coordinate arrays [G, L]
    lm: torch.Tensor,  # [G, L] approx masses (zero-padded)
    ranges: torch.Tensor,  # [G, D_cells, 2] direct body ranges
    quarters: dict,  # the collectors' quarter_bits payload
    sorted_coords,  # D arrays [Ns]: all sources, Morton order
    sorted_gm: torch.Tensor,  # [Ns]
    *,
    g_const: float,
    softening: float,
    k_tile: int,
    run_cap: int,
    t_cap: int,
):
    """Quarter-split gather-free evaluation
    (``_evaluate_pallas_runs_split`` in the JAX package), on kernel K4.

    Per quarter q of each group (i = 4g + q): the group's direct cells
    whose theta bit q is set stay direct (the other cells' counts are
    zeroed before the runs merge), and the rest of the group's direct
    cells serve the quarter as plain COMs from its extension table,
    compacted to a prefix by a stable sort on ``~use`` (gm = 0 pads).
    Builds approx [G, 8, A], ext [4G, 8, E], tiles [4G, 3, T] and
    lens [3, 4G] = (approx lanes repeated 4x, ext lanes, direct tiles).
    Returns (acc [G, S, D], overflow [G])."""
    from .experiments import merge_ranges  # imports this module

    dims = positions_grouped.shape[-1]
    approx, a_lanes = _approx_table(coord_lists, lm, g_const, k_tile)
    gg = approx.shape[0]
    bits = quarters["bits"]  # [G, E]
    dc = ranges[:, :, 1]
    e_raw = bits.shape[1]
    gm_all = g_const * quarters["mass"]
    ext_q, elen_q = [], []
    for q in range(4):
        use = (dc > 0) & (((bits >> q) & 1) == 0)
        cols, _ = _sort_compact(
            use, list(quarters["com"]) + [torch.where(use, gm_all, 0.0)],
            e_raw)
        ext_q.append(torch.cat(
            [torch.stack(cols, dim=1),
             torch.zeros((gg, 8 - dims - 1, e_raw), dtype=gm_all.dtype,
                         device=gm_all.device)], dim=1))  # [G, 8, E]
        elen_q.append(use.sum(1).to(torch.int32))
    ext = torch.stack(ext_q, dim=1).reshape(4 * gg, 8, e_raw)
    ext = torch.nn.functional.pad(ext, (0, (-e_raw) % k_tile))

    # per-quarter direct ranges: counts zeroed where the quarter's theta
    # passes (the cell serves it from the extension table instead)
    qsel = ((bits[:, None, :] >> torch.arange(
        4, dtype=torch.int32, device=bits.device)[None, :, None]) & 1) > 0
    rq = torch.stack(
        [ranges[:, None, :, 0].expand(gg, 4, -1),
         torch.where(qsel, dc[:, None, :], 0)], dim=-1,
    ).reshape(4 * gg, ranges.shape[1], 2)
    merged, ovf_m = merge_ranges(rq, cap=run_cap)
    tiles, n_tiles, ovf_t = _expand_runs_tiles(merged, k_tile, t_cap)

    srct = _source_table(sorted_coords, sorted_gm, k_tile)
    lens = torch.stack([a_lanes.repeat_interleave(4),
                        torch.stack(elen_q, dim=1).reshape(-1), n_tiles])
    acc = list_eval.list_eval_runs_split(
        positions_grouped, approx, ext, srct, tiles, lens,
        softening=float(softening), k_tile=k_tile,
    )
    return acc, (ovf_m | ovf_t).reshape(gg, 4).any(1)


_SB = 8  # bodies per superblock (one packed gather row)


def _expand_ranges_superblocks(ranges: torch.Tensor, direct_cell_max: int,
                               sb_cap: int):
    """Direct cell ranges -> a compact per-group list of 8-body
    *superblocks* (the grid and dynamic evaluators' direct sources; see
    ``nbody_tpu.ops.bh_grouped._expand_ranges_superblocks``).  A range
    [start, start + count) covers at most
    (direct_cell_max + 2 * (SB - 1)) // SB + 1 superblocks; each keeps the
    range's [lo, hi) body bounds for the lane mask.

    ranges: [G, D, 2] (start, count).  Returns (sb_idx [G, C], lo [G, C],
    hi [G, C], overflow [G]); empty entries have sb_idx == -1, hi == 0."""
    g, d, _ = ranges.shape
    t_sb = (direct_cell_max + 2 * (_SB - 1)) // _SB + 1
    starts, counts = ranges[:, :, 0], ranges[:, :, 1]
    ends = starts + counts
    first = starts >> 3
    last = (ends - 1) >> 3  # arithmetic shift: count == 0 -> last < first
    offs = torch.arange(t_sb, dtype=torch.int32, device=ranges.device)
    sb = (first[:, :, None] + offs).reshape(g, d * t_sb)
    mask = (offs[None, None, :] <= (last - first)[:, :, None]).reshape(
        g, d * t_sb)
    lo = starts[:, :, None].expand(g, d, t_sb).reshape(g, -1)
    hi = ends[:, :, None].expand(g, d, t_sb).reshape(g, -1)
    (sb_c, lo_c, hi_c), overflow = _sort_compact(
        mask, [torch.where(mask, sb, -1), lo, torch.where(mask, hi, 0)],
        sb_cap)
    return sb_c, lo_c, hi_c, overflow


def _superblock_pack(sorted_cols) -> torch.Tensor:
    """Morton-sorted source columns (coordinates, then g*m; [Ns] each) ->
    [Nsb, 8 * len(cols)] rows of 8 bodies: x*8 | y*8 | (z*8 |) gm*8, the
    zero-padded tail included."""
    pad = (-sorted_cols[0].shape[0]) % _SB
    return torch.cat([torch.nn.functional.pad(c, (0, pad)).reshape(-1, _SB)
                      for c in sorted_cols], dim=1)


def _padded_lists(coord_lists, lm, direct_sb, sb_packed, g_const: float):
    """The grid/dynamic evaluators' packed list [G, 8, K] and lens [2, G]:
    the approx section (coordinates, g * lm) in lanes [0, L), the gathered
    superblock bodies in [L, K), lanes outside their range's [lo, hi) or
    of empty entries at gm = 0; lens = (approx cells with mass, 8 x valid
    superblocks)."""
    dims = len(coord_lists)
    sb_idx, lo, hi = direct_sb
    gg, c = sb_idx.shape
    dmask = sb_idx >= 0
    safe = torch.where(dmask, sb_idx, 0)
    rows = sb_packed[safe.long()].reshape(gg, c, dims + 1, _SB)
    body = safe[:, :, None] * _SB + torch.arange(
        _SB, dtype=torch.int32, device=sb_idx.device)
    lane_ok = dmask[:, :, None] & (body >= lo[:, :, None]) & (
        body < hi[:, :, None])
    direct = rows.permute(0, 2, 1, 3).reshape(gg, dims + 1, c * _SB)
    direct[:, dims] = torch.where(lane_ok.reshape(gg, -1), direct[:, dims],
                                  0.0)
    approx = torch.stack(list(coord_lists) + [g_const * lm], dim=1)
    src = torch.cat([torch.cat([approx, direct], dim=2),
                     torch.zeros((gg, 8 - dims - 1, approx.shape[2] + c * _SB),
                                 dtype=lm.dtype, device=lm.device)], dim=1)
    lens = torch.stack([(lm > 0).sum(1), _SB * dmask.sum(1)]).to(torch.int32)
    return src, lens


def _evaluate_pallas(
    positions_grouped: torch.Tensor,  # [G, S, D]
    coord_lists,  # D approx coordinate arrays [G, L]
    lm: torch.Tensor,  # [G, L] approx masses (zero-padded)
    direct_sb,  # (sb_idx, lo, hi) [G, C] each
    sb_packed: torch.Tensor,  # [Nsb, 8 * (D + 1)] packed sorted sources
    *,
    g_const: float,
    softening: float,
    compensated: bool = False,
    dynamic: bool = True,
    k_tile: int = 2048,
    eval_chunk: int | None = None,
) -> torch.Tensor:
    """The grid / dynamic route (``_evaluate_pallas`` and
    ``_evaluate_pallas_3d`` in the JAX package): pad the approx section to
    a multiple of 2048 (a narrower compaction must still tile at k_tile),
    pack each group's list with its gathered superblocks and evaluate it
    with K7 (``dynamic``) or K6 (which ``compensated`` forces; it takes its
    default k_tile, as in the JAX package).  With ``eval_chunk`` (3D: 64
    groups) the packed lists are built and evaluated that many groups at a
    time, which bounds their memory.  Returns acc [G, S, D]."""
    apad = (-lm.shape[1]) % 2048
    coord_lists = [torch.nn.functional.pad(a, (0, apad)) for a in coord_lists]
    lm = torch.nn.functional.pad(lm, (0, apad))
    section = lm.shape[1]
    gg = lm.shape[0]
    chunk = min(eval_chunk or gg, gg)
    out = []
    for c0 in range(0, gg, chunk):
        sl = slice(c0, c0 + chunk)
        src, lens = _padded_lists([a[sl] for a in coord_lists], lm[sl],
                                  [a[sl] for a in direct_sb], sb_packed,
                                  g_const)
        tgt = positions_grouped[sl].float()
        if dynamic and not compensated:
            out.append(list_eval.list_eval_dynamic(
                tgt, src, lens, softening=float(softening),
                section_offset=section, k_tile=k_tile))
        else:
            out.append(list_eval.list_eval_pallas(
                tgt, src, lens, softening=float(softening),
                section_offset=section, compensated=compensated))
    return torch.cat(out)


def window_local(ranges: torch.Tensor, range_offset) -> torch.Tensor:
    """Direct ranges [G, D, 2] with their starts made window-local (the
    sources start at global slot ``range_offset``); empty entries keep
    start 0."""
    starts = torch.where(ranges[:, :, 1] > 0,
                         ranges[:, :, 0] - range_offset, 0)
    return torch.stack([starts.to(ranges.dtype), ranges[:, :, 1]], dim=-1)


def resolve_eval(eval_mode, compensated: bool, eval_k_tile,
                 runs_k_tile: int):
    """The JAX package's evaluator resolution on its kernel route:
    ``None`` -> "runs"; ``compensated`` forces "grid" (the Kahan path lives
    in K6); k_tile defaults to ``runs_k_tile`` for runs (capped at
    ``list_eval.runs_k_max``) and 2048 for grid / dynamic.  Returns
    (eval_mode, k_tile)."""
    eval_mode = eval_mode or "runs"
    if eval_mode not in ("runs", "grid", "dynamic"):
        raise ValueError(f"unknown eval_mode {eval_mode!r}")
    if compensated:
        eval_mode = "grid"
    if eval_mode == "runs":
        return eval_mode, min(eval_k_tile or runs_k_tile,
                              list_eval.runs_k_max())
    return eval_mode, eval_k_tile or 2048


def bh_accelerations_grouped(
    positions: torch.Tensor,
    masses: torch.Tensor,
    *,
    g: float,
    theta: float = THETA_DEFAULT,
    max_depth: int = MAX_DEPTH_DEFAULT,
    softening: float = BH_SOFTENING,
    group_size: int | None = None,
    frontier_cap: int | None = None,
    list_cap: int | None = None,
    direct_cap: int | None = None,
    direct_cell_max: int = 32,
    direct_body_cap: int | None = None,
    return_diagnostics: bool = False,
    compensated: bool = False,
    eval_k_tile: int | None = None,
    eval_mode: str | None = None,
    run_cap: int | None = None,
    split_eval: bool | None = None,
):
    """Grouped Barnes-Hut accelerations [N, 2] (+ per-body overflow [N]
    with ``return_diagnostics``).  ``None`` caps resolve from
    :func:`cap_defaults`.  Spans: ``nbody.tree`` (the quadtree, the source
    sort), then :func:`grouped_eval`'s ``nbody.collect`` (the groups and
    the walk) and ``nbody.eval`` (the tables, the evaluator, the
    un-sort)."""
    if positions.shape[1] != 2:
        raise ValueError(
            "the 2D grouped engine takes [N, 2] positions; 3D goes through "
            "ops.bh3d.bh3_accelerations_grouped")
    with span("nbody.tree"):
        tree = build_quadtree(positions, masses, max_depth=max_depth)
        src_order = torch.argsort(tree.codes, stable=True)
        psort = positions[src_order]
        sorted_x = psort[:, 0].contiguous()
        sorted_y = psort[:, 1].contiguous()
        sorted_gm = g * masses[src_order]
    return grouped_eval(
        tree, sorted_x=sorted_x, sorted_y=sorted_y, sorted_gm=sorted_gm,
        g=g, theta=theta, softening=softening, group_size=group_size,
        frontier_cap=frontier_cap, list_cap=list_cap, direct_cap=direct_cap,
        direct_cell_max=direct_cell_max, direct_body_cap=direct_body_cap,
        return_diagnostics=return_diagnostics, target_sorted=psort,
        target_order=src_order, compensated=compensated,
        eval_k_tile=eval_k_tile, eval_mode=eval_mode, run_cap=run_cap,
        split_eval=split_eval,
    )


def grouped_eval(
    tree: Quadtree,
    *,
    target_order: torch.Tensor | None = None,  # [Nt] stable Morton order
    target_sorted: torch.Tensor | None = None,  # [Nt, 2] in that order
    target_positions: torch.Tensor | None = None,  # [Nt, 2]
    target_codes: torch.Tensor | None = None,  # [Nt] leaf codes in tree
    sorted_x: torch.Tensor,  # [Ns] all sources in Morton order
    sorted_y: torch.Tensor,
    sorted_gm: torch.Tensor,  # [Ns] g * mass, same order
    g: float,
    theta: float = THETA_DEFAULT,
    softening: float = BH_SOFTENING,
    group_size: int | None = None,
    frontier_cap: int | None = None,
    list_cap: int | None = None,
    direct_cap: int | None = None,
    direct_cell_max: int = 32,
    direct_body_cap: int | None = None,
    return_diagnostics: bool = False,
    compensated: bool = False,
    eval_k_tile: int | None = None,
    eval_mode: str | None = None,
    run_cap: int | None = None,
    split_eval: bool | None = None,
    window_cells=None,
    range_offset=None,
    n_sources_hint: int | None = None,
):
    """Grouped evaluation of targets against a prebuilt tree, through the
    runs evaluator (kernel K2 on CUDA, its twin on the CPU), per Morton
    quarter (K4) where ``split_eval`` resolves on, or through the padded
    two-section lists: K6 with ``eval_mode="grid"`` or ``compensated``,
    K7 with ``eval_mode="dynamic"``.

    The targets come as ``target_order`` / ``target_sorted``, or as
    ``target_positions`` (with their leaf codes ``target_codes``, else
    computed in ``tree``), which are stably Morton-sorted here.

    Sharded sources (``parallel/steps.py``): ``sorted_*`` may hold only a
    Morton-contiguous window of the global sorted order.  Then
    ``window_cells=(c_lo, c_hi)`` gates direct emission to the leaf cells
    the window covers (see :func:`_collect_lists`), ``range_offset`` is
    the global index of the window's first slot (device scalar), and
    ``n_sources_hint`` (the global body count) keys the caps, the
    frontier schedule and the split gate, as in the JAX package."""
    if target_order is None:
        if target_codes is None:
            target_codes = morton_codes(target_positions, tree.bounds,
                                        tree.max_depth)
        target_order = torch.argsort(target_codes, stable=True)
        target_sorted = target_positions[target_order]
    n = target_sorted.shape[0]
    ns = n_sources_hint or sorted_x.shape[0]
    eval_mode, k_tile = resolve_eval(eval_mode, compensated, eval_k_tile,
                                     256)

    if group_size is None:
        group_size = DEFAULT_GROUP_SIZE
    defaults = cap_defaults(group_size, ns)
    frontier_cap = frontier_cap or defaults["frontier_cap"]
    list_cap = list_cap or defaults["list_cap"]
    direct_cap = direct_cap or defaults["direct_cap"]
    direct_body_cap = direct_body_cap or defaults["direct_body_cap"]

    with span("nbody.collect"):
        # groups of gs Morton-consecutive targets, the last padded with
        # copies of the last body (a tight bbox; results sliced off)
        gs = min(group_size, max(n, 1))
        n_pad = ((n + gs - 1) // gs) * gs
        tsort = torch.cat(
            [target_sorted, target_sorted[-1:].expand(n_pad - n, 2)], dim=0)
        pg = tsort.reshape(-1, gs, 2)  # [G, S, 2]

        # Q sub-bboxes per group over slices of its run (tight even where
        # the run straddles a Morton seam)
        n_sub = max(4, gs // 128)
        if gs % n_sub:
            n_sub = 1
        sub = pg.reshape(pg.shape[0], n_sub, gs // n_sub, 2)
        bbox = (sub[..., 0].amin(2), sub[..., 0].amax(2),
                sub[..., 1].amin(2), sub[..., 1].amax(2))

        if split_eval is None:
            # the JAX package's auto gate: on only for the runs evaluator
            # at dcm >= 128 and >= 768K bodies
            split_eval = (eval_mode == "runs" and gs % 4 == 0 and gs >= 512
                          and n_sub % 4 == 0 and direct_cell_max >= 128
                          and ns >= 768 * 1024)
        elif split_eval and (gs % 4 or n_sub % 4):
            raise ValueError(
                "split_eval=True requires group_size and n_sub divisible by 4 "
                f"(got {gs}, {n_sub})")
        split_eval = split_eval and eval_mode == "runs"

        collected = _collect_lists(
            bbox, tree, theta=theta, softening=softening,
            frontier_caps=frontier_schedule(frontier_cap, tree.max_depth, ns),
            list_cap=list_cap, direct_cap=direct_cap,
            direct_cell_max=direct_cell_max, quarter_bits=split_eval,
            window_cells=window_cells,
        )
        (lx, ly, lm), ranges, overflow_g = collected[:3]
        if range_offset is not None:
            ranges = window_local(ranges, range_offset)

    with span("nbody.eval"):
        rc = run_cap or defaults["run_cap"]
        kw = dict(g_const=g, softening=softening, k_tile=k_tile, run_cap=rc,
                  t_cap=direct_body_cap // k_tile + 2 * rc)
        if eval_mode != "runs":
            sb_idx, sb_lo, sb_hi, ovf_e = _expand_ranges_superblocks(
                ranges, direct_cell_max, direct_body_cap // _SB + direct_cap)
            acc = _evaluate_pallas(
                pg, (lx, ly), lm, (sb_idx, sb_lo, sb_hi),
                _superblock_pack((sorted_x, sorted_y, sorted_gm)), g_const=g,
                softening=softening, compensated=compensated,
                dynamic=eval_mode == "dynamic", k_tile=k_tile)
        elif split_eval:
            acc, ovf_e = _evaluate_runs_split(
                pg, (lx, ly), lm, ranges, collected[3], (sorted_x, sorted_y),
                sorted_gm, **kw)
        else:
            acc, ovf_e = _evaluate_runs(
                pg, (lx, ly), lm, ranges, (sorted_x, sorted_y), sorted_gm,
                **kw)
        overflow_g = overflow_g | ovf_e

        # un-sort: ``target_order`` is a permutation, so one scatter
        # restores body order (unique indices: deterministic)
        out = torch.empty((n, 2), dtype=acc.dtype, device=acc.device)
        out[target_order] = acc.reshape(-1, 2)[:n]
        if return_diagnostics:
            ovf = torch.empty((n,), dtype=torch.bool, device=acc.device)
            ovf[target_order] = overflow_g.repeat_interleave(gs)[:n]
            return out, ovf
        return out
