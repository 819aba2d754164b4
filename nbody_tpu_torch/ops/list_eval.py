"""Grouped Barnes-Hut list evaluation: the CUDA kernels K2, K3 and K4
(``csrc/runs_eval.cu``), K6 and K7 (``csrc/list_eval.cu``), and their
plain PyTorch twins.

Counterparts of ``nbody_tpu.ops.list_eval``:

* :func:`list_eval_runs` (the Pallas ``_runs_kernel``): K2 at
  ``seg_pack=1``, K3 at ``seg_pack=P>1``, one CUDA kernel.  Each Morton
  group's bodies take the Barnes-Hut pair force (softened direction,
  unsoftened magnitude, project.cu:651-658, guard (d2 > 0) & (gm > 0))
  from the occupied tiles of its approx list and from its direct k-tiles,
  read straight from the Morton-sorted transposed source table and masked
  to their [lo, hi) lanes.  With ``seg_pack = P`` every direct step packs
  P table entries ("segments") of k_tile/P lanes, each masked to its own
  window.
* :func:`list_eval_runs_split` (the Pallas ``_runs_split_kernel``): K4,
  the same pair force per Morton *quarter* of each group (i = 4g + q)
  over three sections: the group's approx list, the quarter's compacted
  extension table and the quarter's own direct tiles.
* :func:`list_eval_pallas` (the Pallas ``_kernel``): K6, the same pair
  force against a packed [G, 8, K] list of two left-compacted sections
  (approx cells, then direct bodies from ``section_offset``), visiting
  every k-tile that overlaps either section, optionally
  Kahan-compensated across tiles.
* :func:`list_eval_dynamic` (the Pallas ``_dyn_kernel``): K7, the same
  list walked over exactly its occupied tiles.

Each is for 2D and 3D targets.  The wrappers launch a kernel for CUDA
tensors and take the twin only for CPU tensors.  The counters
``ops.list_eval.KERNEL_LAUNCHES`` count K2 launches, ``PACKED_LAUNCHES``
K3, ``SPLIT_LAUNCHES`` K4, ``GRID_LAUNCHES`` K6 (plain and compensated),
``DYNAMIC_LAUNCHES`` K7 (``utils.profiling``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils.profiling import count
from . import _cuda

# segment counts the CUDA kernel is instantiated for
CUDA_SEG_PACKS = (1, 2, 4, 8)
# K2/K3's launch shape: threads per block (runs_eval.cu's kRunsThreads),
# r thread slices per target and RUNS_THREADS / r targets a block, and the
# warps one SM is counted to hold at once (__launch_bounds__(256, 4) and
# ~46 KB of shared memory a block: four blocks of eight warps)
RUNS_THREADS = 256
RUNS_WAVE_WARPS = 32
# K6/K7's launch shape: threads per block (list_eval.cu's kThreads), the
# H100's SMs, and the warps one SM is counted to hold at once:
# __launch_bounds__(256, 4) caps the kernel at 64 registers, so at least
# four blocks of eight warps fit on an SM
LIST_THREADS = 256
SMS = 132
LIST_WAVE_WARPS = 32
# K4's launch shape: threads per block, one target each (runs_eval.cu's
# kSplitThreads), and the blocks one SM is counted to hold
# (__launch_bounds__(256, 3))
SPLIT_THREADS = 256
SPLIT_WAVE_BLOCKS = 3

# Same constants as nbody_tpu.ops.list_eval: ``runs_k_max`` is the TPU
# kernel's VMEM ceiling on k_tile.  The grouped engine keeps applying it
# so its tile tables equal the JAX package's; the CUDA kernel itself is
# not limited by it.
_VMEM_BUDGET = 12 * 1024 * 1024
_LIVE = 3


def runs_k_max(s_tile: int = 512) -> int:
    """The JAX package's k_tile ceiling for the runs evaluator (1024 at
    the default s_tile), kept for tile-table parity."""
    return max(128, _VMEM_BUDGET // (2 * _LIVE * s_tile * 4)) // 128 * 128


def _check_seg_pack(seg_pack: int, k_tile: int) -> None:
    if seg_pack < 1 or (seg_pack > 1 and k_tile % (128 * seg_pack)):
        raise ValueError(
            f"seg_pack={seg_pack} (kernel K3 when > 1) needs k_tile "
            f"divisible by {128 * seg_pack} (got {k_tile})")


def _tile_partials(targets: torch.Tensor, src: torch.Tensor,
                   softening: float) -> torch.Tensor:
    """The twins' pair force: targets [S, D] against source tiles
    [D + 1, n_tiles, k] (coordinates, then gm); returns the per-tile
    partial sums [S, n_tiles, D]."""
    dims = targets.shape[1]
    disp = [src[ax][None] - targets[:, ax, None, None]
            for ax in range(dims)]  # each [S, n_tiles, k]
    d2 = sum(da * da for da in disp)
    gm = src[dims][None]
    valid = (d2 > 0.0) & (gm > 0.0)
    safe = torch.where(valid, d2, torch.ones_like(d2))
    w = gm / (safe * (safe * torch.rsqrt(safe) + softening))
    w = torch.where(valid, w, torch.zeros_like(w))
    return torch.stack([(w * da).sum(-1) for da in disp], dim=-1)


def _pair_sum(targets: torch.Tensor, src: torch.Tensor,
              softening: float) -> torch.Tensor:
    """Per-tile partial sums, then the sum over tiles.  Returns [S, D]."""
    return _tile_partials(targets, src, softening).sum(1)


def _list_tiles(table: torch.Tensor, lanes: int, k_tile: int,
                max_tiles: int | None = None) -> torch.Tensor:
    """The occupied tiles of one list [rows, W] (approx or extension):
    ceil(lanes / k_tile) tiles, at most ``max_tiles``, zero-padded past W.
    Returns [rows, n_tiles, k_tile]."""
    rows, width = table.shape
    n_t = -(-lanes // k_tile)
    if max_tiles is not None:
        n_t = min(n_t, max_tiles)
    used = min(n_t * k_tile, width)
    out = torch.zeros((rows, n_t * k_tile), dtype=table.dtype,
                      device=table.device)
    out[:, :used] = table[:, :used]
    return out.reshape(rows, n_t, k_tile)


def _direct_tiles(tiles: torch.Tensor, n_entries: int, sources_t,
                  rows: int, sw: int) -> torch.Tensor:
    """The first ``n_entries`` entries of one direct table [3, T] as
    [rows, n_entries, sw] source lanes: lanes outside an entry's [lo, hi)
    window, past the source table, or of entries past T get gm = 0."""
    t_cap = tiles.shape[1]
    npad = sources_t.shape[1]
    lane = torch.arange(sw, device=tiles.device)
    seg = torch.arange(n_entries, device=tiles.device)
    have = seg < t_cap
    start, lo, hi = torch.where(
        have, tiles[:, seg.clamp(max=t_cap - 1)], 0).long()
    col = start[:, None] + lane[None, :]  # [entries, sw]
    keep = (lane >= lo[:, None]) & (lane < hi[:, None]) & (col < npad)
    dsrc = sources_t[:rows, col.clamp(max=npad - 1)]
    dsrc[rows - 1] = torch.where(keep, dsrc[rows - 1], 0.0)
    return dsrc


def list_eval_runs_plain(
    targets: torch.Tensor,  # [G, S, D]
    approx: torch.Tensor,  # [G, 8, A]
    sources_t: torch.Tensor,  # [8, Npad]
    tiles: torch.Tensor,  # [G, 3, T]
    lens: torch.Tensor,  # [2, G]
    *,
    softening: float,
    k_tile: int,
    seg_pack: int = 1,
) -> torch.Tensor:
    """K2's and K3's plain twin: per group, the occupied approx tiles and
    the direct tiles as [n_tiles, k_tile] source lanes (direct lanes
    outside their segment's [lo, hi) get gm = 0 before the guard; table
    entries past T are empty), per-tile partial sums, then the sum over
    tiles."""
    _check_seg_pack(seg_pack, k_tile)
    g_n, s, dims = targets.shape
    t_cap = tiles.shape[2]
    rows = dims + 1  # coordinates, then gm
    out = torch.zeros_like(targets)
    for g, (a_lanes, d_t) in enumerate(lens.t().tolist()):
        src = [_list_tiles(approx[g, :rows], a_lanes, k_tile)]
        d_t = min(d_t, -(-t_cap // seg_pack))
        if d_t:
            src.append(_direct_tiles(
                tiles[g], d_t * seg_pack, sources_t, rows,
                k_tile // seg_pack).reshape(rows, d_t, k_tile))
        src = torch.cat(src, dim=1)  # [rows, n_tiles, k]
        if src.shape[1]:
            out[g] = _pair_sum(targets[g], src, softening)
    return out


def list_eval_runs(
    targets: torch.Tensor,  # [G, S, D] group body positions, D = 2 or 3
    approx: torch.Tensor,  # [G, 8, A] approx lists, rows [x, y, (z,) gm, 0...]
    sources_t: torch.Tensor,  # [8, Npad] all sorted sources transposed
    tiles: torch.Tensor,  # [G, 3, T] int32 [start, lo, hi] per tile/segment
    lens: torch.Tensor,  # [2, G] int32 [approx lanes, direct (packed) tiles]
    *,
    softening: float,
    k_tile: int = 2048,
    seg_pack: int = 1,
) -> torch.Tensor:
    """Gather-free list evaluation; the same tensors as
    ``nbody_tpu.ops.list_eval.list_eval_runs``.  Returns [G, S, D].

    With ``seg_pack = P > 1`` the ``tiles`` entries are (k_tile/P)-lane
    segments and ``lens[1]`` counts packed tiles (ceil(segments / P)).

    On CUDA: kernel K2 (P = 1) or K3 (P in 2, 4, 8), heaviest groups first
    (by :func:`runs_group_lanes`), f32 2D or 3D targets, int32 tables,
    contiguous inputs only, any k_tile.  On the CPU: the plain twin."""
    _check_seg_pack(seg_pack, k_tile)
    if not targets.is_cuda:
        return list_eval_runs_plain(
            targets, approx, sources_t, tiles, lens, softening=softening,
            k_tile=k_tile, seg_pack=seg_pack)
    out = _launch_runs(targets, approx, sources_t, tiles, lens,
                       softening=softening, k_tile=k_tile, seg_pack=seg_pack)
    count("ops.list_eval.KERNEL_LAUNCHES" if seg_pack == 1
          else "ops.list_eval.PACKED_LAUNCHES")
    return out


def _slice_shape(g: int, s: int, threads: int, wave_warps: int) -> tuple:
    """(r, targets per block, blocks) of a launch over G groups of S
    targets with r thread slices per target: the fewest of 1, 2, 4, 8 whose
    G x S x r threads make at least two waves of ``wave_warps`` warps on
    each of the ``SMS`` SMs (8 when none does); a block of ``threads``
    threads holds threads / r targets."""
    wave = SMS * wave_warps * 32  # threads
    r = next((r for r in (1, 2, 4) if g * s * r >= 2 * wave), 8)
    per_block = threads // r
    return r, per_block, g * -(-s // per_block)


def runs_launch_shape(g: int, s: int) -> tuple:
    """K2/K3's launch on [G, S] targets: (r, targets per block, blocks),
    r slices per target as :func:`_slice_shape` picks them for
    ``RUNS_THREADS`` and ``RUNS_WAVE_WARPS``.  Every unit's partial is
    summed by one thread and partials enter in unit order, so r moves
    time, never bits."""
    return _slice_shape(g, s, RUNS_THREADS, RUNS_WAVE_WARPS)


def runs_group_lanes(approx, sources_t, tiles, lens, *, k_tile: int,
                     seg_pack: int = 1) -> torch.Tensor:
    """The source lanes each group's evaluation needs [G] int64, which
    K2/K3 stage once per block: approx lanes below lens[0] (at most A) and
    each of the first min(lens[1] x P, T) direct entries' [lo, hi),
    clipped to its k_tile / P window and the source table."""
    t_cap = tiles.shape[2]
    start, lo, hi = tiles.unbind(1)  # each [G, T]
    hi = torch.minimum(hi.clamp(max=k_tile // seg_pack),
                       sources_t.shape[1] - start)
    span = (hi - lo.clamp(min=0)).clamp(min=0)
    live = (torch.arange(t_cap, device=tiles.device)[None]
            < (lens[1, :, None] * seg_pack).clamp(max=t_cap))
    # integer sums are int64
    return lens[0].clamp(max=approx.shape[2]) + (span * live).sum(1)


def runs_occupancy(dims: int, seg_pack: int) -> int:
    """Blocks of K2/K3 (``dims``, ``seg_pack``) that one SM of the current
    card holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    n = ctypes.c_int(0)
    _cuda.check(_cuda.library().nbody_runs_occupancy(
        dims, seg_pack, RUNS_THREADS, ctypes.byref(n)), "runs occupancy")
    return n.value


def runs_lanes_staged(targets, approx, sources_t, tiles, lens, *,
                      softening: float, k_tile: int = 2048,
                      seg_pack: int = 1) -> int:
    """Run K2/K3 once on CUDA tensors and return the lanes it staged,
    summed over the groups (each group's first block counts).  Not counted
    in the launch counters: a measurement, not the main path."""
    staged = torch.zeros(1, dtype=torch.int64, device=targets.device)
    _launch_runs(targets, approx, sources_t, tiles, lens,
                 softening=softening, k_tile=k_tile, seg_pack=seg_pack,
                 staged=staged)
    return int(staged)


def _launch_runs(targets, approx, sources_t, tiles, lens, *, softening,
                 k_tile, seg_pack, staged=None) -> torch.Tensor:
    _check_seg_pack(seg_pack, k_tile)
    dev = targets.device
    g, s, dims = targets.shape
    name = "runs_eval (K2)" if seg_pack == 1 else "runs_eval packed (K3)"
    if dims not in (2, 3):
        raise ValueError(f"targets have {dims} coordinates; K2/K3 take 2 or 3")
    if seg_pack not in CUDA_SEG_PACKS:
        raise ValueError(
            f"seg_pack={seg_pack}: the CUDA kernel is built for "
            f"{CUDA_SEG_PACKS}")
    _cuda.require(targets, "targets", torch.float32, (g, s, dims), dev)
    _cuda.require(approx, "approx", torch.float32, (g, 8, None), dev)
    _cuda.require(sources_t, "sources_t", torch.float32, (8, None), dev)
    _cuda.require(tiles, "tiles", torch.int32, (g, 3, None), dev)
    _cuda.require(lens, "lens", torch.int32, (2, g), dev)
    if k_tile < 1:
        raise ValueError(f"k_tile={k_tile}: a tile holds at least one lane")
    if g > 65535:
        raise ValueError(f"{g} groups exceed the grid's y dimension")
    # the heaviest groups first: their blocks set the kernel's time
    order = torch.argsort(
        runs_group_lanes(approx, sources_t, tiles, lens, k_tile=k_tile,
                         seg_pack=seg_pack),
        descending=True, stable=True).to(torch.int32)
    slices = runs_launch_shape(g, s)[0]
    out = torch.empty((g, s, dims), dtype=torch.float32, device=dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        code = lib.nbody_runs_eval(
            targets.data_ptr(), approx.data_ptr(), sources_t.data_ptr(),
            tiles.data_ptr(), lens.data_ptr(), out.data_ptr(), g, s,
            approx.shape[2], sources_t.shape[1], tiles.shape[2], k_tile,
            float(softening), dims, seg_pack, RUNS_THREADS, slices,
            order.data_ptr(), None if staged is None else staged.data_ptr(),
            _cuda.stream_of(out),
        )
    _cuda.check(code, name)
    return out


def _check_split(targets: torch.Tensor, ext: torch.Tensor, tiles, lens):
    g, s, _ = targets.shape
    if s % 4:
        raise ValueError(
            f"quarter-split evaluation (K4) needs S % 4 == 0 targets per "
            f"group, got {s}")
    for name, t, lead in (("ext", ext, 0), ("tiles", tiles, 0),
                          ("lens", lens, 1)):
        if t.shape[lead] != 4 * g:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}: quarter-split tables "
                f"hold 4G = {4 * g} quarters along dim {lead}")


def list_eval_runs_split_plain(
    targets: torch.Tensor,  # [G, S, D]
    approx: torch.Tensor,  # [G, 8, A]
    ext: torch.Tensor,  # [4G, 8, E]
    sources_t: torch.Tensor,  # [8, Npad]
    tiles: torch.Tensor,  # [4G, 3, T]
    lens: torch.Tensor,  # [3, 4G]
    *,
    softening: float,
    k_tile: int,
) -> torch.Tensor:
    """K4's plain twin: per quarter i = 4g + q, its S/4 targets against
    the group's occupied approx tiles, the quarter's occupied extension
    tiles (at most ceil(E / k_tile)) and its direct tiles (at most T;
    lanes outside [lo, hi) get gm = 0), per-tile partial sums, then the
    sum over tiles."""
    _check_split(targets, ext, tiles, lens)
    g_n, s, dims = targets.shape
    sq = s // 4
    t_cap = tiles.shape[2]
    e_tiles = -(-ext.shape[2] // k_tile)
    rows = dims + 1
    out = torch.zeros_like(targets)
    for i, (a_lanes, e_lanes, d_t) in enumerate(lens.t().tolist()):
        g, q = divmod(i, 4)
        src = [_list_tiles(approx[g, :rows], a_lanes, k_tile),
               _list_tiles(ext[i, :rows], e_lanes, k_tile, e_tiles)]
        d_t = min(d_t, t_cap)
        if d_t > 0:
            src.append(_direct_tiles(tiles[i], d_t, sources_t, rows, k_tile))
        src = torch.cat(src, dim=1)
        if src.shape[1]:
            out[g, q * sq:(q + 1) * sq] = _pair_sum(
                targets[g, q * sq:(q + 1) * sq], src, softening)
    return out


def list_eval_runs_split(
    targets: torch.Tensor,  # [G, S, D] group body positions, D = 2 or 3
    approx: torch.Tensor,  # [G, 8, A] group approx lists
    ext: torch.Tensor,  # [4G, 8, E] per-quarter compacted extension tables
    sources_t: torch.Tensor,  # [8, Npad] all sorted sources transposed
    tiles: torch.Tensor,  # [4G, 3, T] int32 per-quarter direct tiles
    lens: torch.Tensor,  # [3, 4G] int32 [approx lanes, ext lanes, tiles]
    *,
    softening: float,
    k_tile: int = 512,
) -> torch.Tensor:
    """Quarter-split gather-free list evaluation; the same tensors as
    ``nbody_tpu.ops.list_eval.list_eval_runs_split``.  Quarter q of group
    g is row i = 4g + q of ``ext``, ``tiles`` and ``lens`` and targets
    [qS/4, (q+1)S/4) of group g.  Returns [G, S, D].

    On CUDA: kernel K4 (heaviest quarters first, by
    :func:`split_quarter_lanes`), f32 2D or 3D targets, int32 tables,
    contiguous inputs only, any k_tile.  On the CPU: the plain twin."""
    if not targets.is_cuda:
        return list_eval_runs_split_plain(
            targets, approx, ext, sources_t, tiles, lens,
            softening=softening, k_tile=k_tile)
    out = _launch_split(targets, approx, ext, sources_t, tiles, lens,
                        softening=softening, k_tile=k_tile)
    count("ops.list_eval.SPLIT_LAUNCHES")
    return out


def split_launch_shape(n_quarters: int, s: int) -> tuple:
    """K4's launch on 4G quarters of S / 4 targets: (targets per thread,
    blocks per quarter, blocks).  One target a thread, ``SPLIT_THREADS`` a
    block, so a quarter of S / 4 targets takes ceil(S / 4 / SPLIT_THREADS)
    blocks, each staging the quarter's lanes once.  Targets never share a
    sum, so the shape moves time, never bits."""
    per_quarter = max(1, -(-(s // 4) // SPLIT_THREADS))
    return 1, per_quarter, n_quarters * per_quarter


def split_quarter_lanes(approx, ext, sources_t, tiles, lens, *,
                        k_tile: int) -> torch.Tensor:
    """The source lanes each quarter's evaluation needs [4G] int64, which
    K4 stages once per block: approx lanes below lens[0] (at most A),
    extension lanes below lens[1] (at most E) and each of the first
    min(lens[2], T) direct entries' [lo, hi), clipped to the k_tile window
    and the source table."""
    t_cap = tiles.shape[2]
    start, lo, hi = tiles.long().unbind(1)  # each [4G, T]
    hi = torch.minimum(hi.clamp(max=k_tile), sources_t.shape[1] - start)
    span = (hi - lo.clamp(min=0)).clamp(min=0)
    live = (torch.arange(t_cap, device=tiles.device)[None]
            < lens[2, :, None].clamp(max=t_cap))
    return (lens[0].long().clamp(max=approx.shape[2])
            + lens[1].long().clamp(max=ext.shape[2]) + (span * live).sum(1))


def split_occupancy(dims: int) -> int:
    """Blocks of K4 (``dims``) that one SM of the current card holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    n = ctypes.c_int(0)
    _cuda.check(_cuda.library().nbody_runs_split_occupancy(
        dims, SPLIT_THREADS, ctypes.byref(n)), "runs_split occupancy")
    return n.value


def split_lanes_staged(targets, approx, ext, sources_t, tiles, lens, *,
                       softening: float, k_tile: int = 512) -> int:
    """Run K4 once on CUDA tensors and return the lanes it staged, summed
    over the quarters (each quarter's first block counts).  Not counted in
    ``ops.list_eval.SPLIT_LAUNCHES``: a measurement, not the main path."""
    staged = torch.zeros(1, dtype=torch.int64, device=targets.device)
    _launch_split(targets, approx, ext, sources_t, tiles, lens,
                  softening=softening, k_tile=k_tile, staged=staged)
    return int(staged)


def _launch_split(targets, approx, ext, sources_t, tiles, lens, *,
                  softening, k_tile, staged=None) -> torch.Tensor:
    _check_split(targets, ext, tiles, lens)
    dev = targets.device
    g, s, dims = targets.shape
    if dims not in (2, 3):
        raise ValueError(f"targets have {dims} coordinates; K4 takes 2 or 3")
    nq = 4 * g
    _cuda.require(targets, "targets", torch.float32, (g, s, dims), dev)
    _cuda.require(approx, "approx", torch.float32, (g, 8, None), dev)
    _cuda.require(ext, "ext", torch.float32, (nq, 8, None), dev)
    _cuda.require(sources_t, "sources_t", torch.float32, (8, None), dev)
    _cuda.require(tiles, "tiles", torch.int32, (nq, 3, None), dev)
    _cuda.require(lens, "lens", torch.int32, (3, nq), dev)
    if k_tile < 1:
        raise ValueError(f"k_tile={k_tile}: a tile holds at least one lane")
    if nq > 65535:
        raise ValueError(f"{nq} quarters exceed the grid's y dimension")
    # the heaviest quarters first: their blocks set the kernel's time
    order = torch.argsort(
        split_quarter_lanes(approx, ext, sources_t, tiles, lens,
                            k_tile=k_tile),
        descending=True, stable=True).to(torch.int32)
    out = torch.empty((g, s, dims), dtype=torch.float32, device=dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        code = lib.nbody_runs_eval_split(
            targets.data_ptr(), approx.data_ptr(), ext.data_ptr(),
            sources_t.data_ptr(), tiles.data_ptr(), lens.data_ptr(),
            out.data_ptr(), nq, s, approx.shape[2], ext.shape[2],
            sources_t.shape[1], tiles.shape[2], k_tile,
            -(-ext.shape[2] // k_tile), float(softening), dims,
            SPLIT_THREADS, order.data_ptr(),
            None if staged is None else staged.data_ptr(),
            _cuda.stream_of(out),
        )
    _cuda.check(code, "runs_eval split (K4)")
    return out


# -- K6 and K7: the padded two-section list evaluators ---------------------

def resolve_list_tiles(s: int, k: int, section_offset: int,
                       k_tile: int) -> tuple:
    """The JAX wrappers' tile resolution for a [G, S, D] x [G, 8, K] call
    (``list_eval_pallas`` and ``list_eval_dynamic`` alike): the target
    tile divides S, k_tile is clamped to the TPU's VMEM budget, then to a
    divisor of ``section_offset`` (a tile may not straddle the sections),
    and K is padded to a whole number of k-tiles.  Returns (k_tile,
    n_k_tiles); the tile boundaries decide which tiles ``lens`` marks
    occupied."""
    s_tile = 512  # the JAX wrappers' default target tile, for tile parity
    if s % s_tile:
        s_tile = s if s < s_tile else math.gcd(s, s_tile)
    if k_tile < 128:
        raise ValueError(f"k_tile={k_tile}: tiles are multiples of 128 lanes")
    k_tile = min(k_tile, max(128, _VMEM_BUDGET // (_LIVE * s_tile * 4)))
    k_tile = k_tile // 128 * 128
    if section_offset % k_tile:
        k_tile = math.gcd(section_offset, k_tile)
        if k_tile % 128:
            raise ValueError(
                f"section_offset {section_offset} not tileable (need a "
                "multiple of 128 that also divides it); pad the approx "
                "section")
    return k_tile, -(-k // k_tile)


def _occupied_tiles(a_n: int, d_n: int, k_tile: int, off_tile: int,
                    n_k_tiles: int, dynamic: bool) -> list:
    """The k-tiles one group's evaluation visits, in order.  Grid (K6):
    every tile overlapping either section.  Dynamic (K7): ceil(a_n / k)
    tiles from 0, then ceil(d_n / k) from ``off_tile``; tiles past K hold
    no lanes and are dropped."""
    if dynamic:
        a_t, d_t = -(-a_n // k_tile), -(-d_n // k_tile)
        tiles = list(range(a_t)) + list(range(off_tile, off_tile + d_t))
        return [j for j in tiles if j < n_k_tiles]
    off = off_tile * k_tile
    return [j for j in range(n_k_tiles)
            if j * k_tile < a_n
            or ((j + 1) * k_tile > off and j * k_tile < off + d_n)]


def _list_eval_plain(targets, sources, lens, *, softening, section_offset,
                     k_tile, compensated, dynamic):
    g_n, s, dims = targets.shape
    k_tile, n_k_tiles = resolve_list_tiles(s, sources.shape[2],
                                           section_offset, k_tile)
    rows = dims + 1
    src = torch.nn.functional.pad(
        sources[:, :rows], (0, n_k_tiles * k_tile - sources.shape[2]),
    ).reshape(g_n, rows, n_k_tiles, k_tile)
    out = torch.zeros_like(targets)
    for g, (a_n, d_n) in enumerate(lens.t().tolist()):
        idx = _occupied_tiles(a_n, d_n, k_tile, section_offset // k_tile,
                              n_k_tiles, dynamic)
        if not idx:
            continue
        part = _tile_partials(targets[g], src[g][:, idx], softening)
        acc = torch.zeros_like(targets[g])
        comp = torch.zeros_like(acc)
        for t in range(part.shape[1]):  # the running sum, in tile order
            if not compensated:
                acc = acc + part[:, t]
                continue
            y = part[:, t] - comp  # Kahan across tiles
            tot = acc + y
            comp = (tot - acc) - y
            acc = tot
        out[g] = acc - comp
    return out


def list_eval_pallas_plain(
    targets: torch.Tensor,  # [G, S, D]
    sources: torch.Tensor,  # [G, 8, K]
    lens: torch.Tensor,  # [2, G]
    *,
    softening: float,
    section_offset: int,
    k_tile: int = 2048,
    compensated: bool = False,
) -> torch.Tensor:
    """K6's plain twin: per group, every k-tile overlapping either section
    (the whole tile, its zero-gm lanes dropped by the guard), per-tile
    partial sums, then their running sum in tile order or, when
    ``compensated``, their Kahan chain."""
    return _list_eval_plain(
        targets, sources, lens, softening=softening,
        section_offset=section_offset, k_tile=k_tile,
        compensated=compensated, dynamic=False)


def list_eval_dynamic_plain(
    targets: torch.Tensor,  # [G, S, D]
    sources: torch.Tensor,  # [G, 8, K]
    lens: torch.Tensor,  # [2, G]
    *,
    softening: float,
    section_offset: int,
    k_tile: int = 2048,
) -> torch.Tensor:
    """K7's plain twin: per group, the ceil(a_n / k) approx tiles and the
    ceil(d_n / k) direct tiles, per-tile partial sums, then their running
    sum in tile order."""
    return _list_eval_plain(
        targets, sources, lens, softening=softening,
        section_offset=section_offset, k_tile=k_tile,
        compensated=False, dynamic=True)


def list_launch_shape(g: int, s: int) -> tuple:
    """K6/K7's launch on [G, S] targets: (r, targets per block, blocks).
    Each target gets r thread slices, the fewest of 1, 2, 4, 8 whose
    G x S x r threads make at least two waves of ``LIST_WAVE_WARPS`` warps
    on each of the ``SMS`` SMs (8 when none does); a block of
    ``LIST_THREADS`` threads holds LIST_THREADS / r targets.  The result
    decides the kernel's summation order, so it depends on (G, S) alone."""
    return _slice_shape(g, s, LIST_THREADS, LIST_WAVE_WARPS)


def list_eval_occupancy(dims: int, mode: int) -> int:
    """Blocks of K6/K7 (``mode`` 0: K6, 1: K6 compensated, 2: K7) that one
    SM of the current card holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    n = ctypes.c_int(0)
    _cuda.check(_cuda.library().nbody_list_eval_occupancy(
        dims, mode, LIST_THREADS, ctypes.byref(n)), "list_eval occupancy")
    return n.value


def _launch_list_eval(targets, sources, lens, *, softening, section_offset,
                      k_tile, mode: int, name: str) -> torch.Tensor:
    dev = targets.device
    g, s, dims = targets.shape
    if dims not in (2, 3):
        raise ValueError(f"targets have {dims} coordinates; {name} takes 2 "
                         "or 3")
    k = sources.shape[2]
    _cuda.require(targets, "targets", torch.float32, (g, s, dims), dev)
    _cuda.require(sources, "sources", torch.float32, (g, 8, k), dev)
    _cuda.require(lens, "lens", torch.int32, (2, g), dev)
    k_tile, n_k_tiles = resolve_list_tiles(s, k, section_offset, k_tile)
    if g > 65535:
        raise ValueError(f"{g} groups exceed the grid's y dimension")
    slices = list_launch_shape(g, s)[0]
    out = torch.empty((g, s, dims), dtype=torch.float32, device=dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        code = lib.nbody_list_eval(
            targets.data_ptr(), sources.data_ptr(), lens.data_ptr(),
            out.data_ptr(), g, s, k, k_tile, n_k_tiles,
            section_offset // k_tile, float(softening), dims, mode,
            LIST_THREADS, slices, _cuda.stream_of(out),
        )
    _cuda.check(code, name)
    return out


def list_eval_pallas(
    targets: torch.Tensor,  # [G, S, D] group body positions, D = 2 or 3
    sources: torch.Tensor,  # [G, 8, K] packed rows [x, y, (z,) gm, 0...]
    lens: torch.Tensor,  # [2, G] int32 occupied lengths of the two sections
    *,
    softening: float,
    section_offset: int,  # start of the second (direct) section in K
    k_tile: int = 2048,
    compensated: bool = False,
) -> torch.Tensor:
    """Accelerations [G, S, D] of each group's bodies due to its packed
    two-section list; the same tensors as
    ``nbody_tpu.ops.list_eval.list_eval_pallas``.  gm == 0 marks padding;
    approx cells occupy [0, lens[0]), direct bodies
    [section_offset, section_offset + lens[1]).

    On CUDA: kernel K6 (Kahan across tiles when ``compensated``), f32 2D
    or 3D targets, int32 lens, contiguous inputs only.  On the CPU: the
    plain twin."""
    if not targets.is_cuda:
        return list_eval_pallas_plain(
            targets, sources, lens, softening=softening,
            section_offset=section_offset, k_tile=k_tile,
            compensated=compensated)
    out = _launch_list_eval(
        targets, sources, lens, softening=softening,
        section_offset=section_offset, k_tile=k_tile,
        mode=1 if compensated else 0,
        name="list_eval grid (K6, compensated)" if compensated
        else "list_eval grid (K6)")
    count("ops.list_eval.GRID_LAUNCHES")
    return out


def list_eval_dynamic(
    targets: torch.Tensor,  # [G, S, D] group body positions, D = 2 or 3
    sources: torch.Tensor,  # [G, 8, K] packed rows (see list_eval_pallas)
    lens: torch.Tensor,  # [2, G] int32 occupied section lengths
    *,
    softening: float,
    section_offset: int,
    k_tile: int = 2048,
) -> torch.Tensor:
    """Occupancy-proportional list evaluation: each group visits exactly
    its ceil(a_n / k) + ceil(d_n / k) occupied tiles; the same tensors
    and result as :func:`list_eval_pallas` (without compensation), as
    ``nbody_tpu.ops.list_eval.list_eval_dynamic``.

    On CUDA: kernel K7.  On the CPU: the plain twin."""
    if not targets.is_cuda:
        return list_eval_dynamic_plain(
            targets, sources, lens, softening=softening,
            section_offset=section_offset, k_tile=k_tile)
    out = _launch_list_eval(
        targets, sources, lens, softening=softening,
        section_offset=section_offset, k_tile=k_tile,
        mode=2, name="list_eval dynamic (K7)")
    count("ops.list_eval.DYNAMIC_LAUNCHES")
    return out
