"""Grouped Barnes-Hut list evaluation: the CUDA kernels K2 and K3
(``csrc/runs_eval.cu``) and their plain PyTorch twin.

Counterpart of ``nbody_tpu.ops.list_eval.list_eval_runs`` (the Pallas
``_runs_kernel``): K2 at ``seg_pack=1``, K3 at ``seg_pack=P>1``, each
for 2D and 3D targets.  Each Morton group's bodies take the Barnes-Hut
pair force (softened direction, unsoftened magnitude, project.cu:651-658,
guard (d2 > 0) & (gm > 0)) from the occupied tiles of its approx list
and from its direct k-tiles, read straight from the Morton-sorted
transposed source table and masked to their [lo, hi) lanes.  With
``seg_pack = P`` every direct step packs P table entries ("segments") of
k_tile/P lanes, each masked to its own window.  The other Pallas
evaluators of the JAX module (``list_eval_pallas`` K6,
``list_eval_dynamic`` K7, ``list_eval_runs_split`` K4) are not ported yet
(ROADMAP Queue B).

:func:`list_eval_runs` launches a kernel for CUDA tensors and takes the
twin only for CPU tensors.  ``KERNEL_LAUNCHES`` counts K2 launches,
``PACKED_LAUNCHES`` K3 launches.
"""

from __future__ import annotations

import torch

from . import _cuda

KERNEL_LAUNCHES = 0  # K2 (seg_pack == 1)
PACKED_LAUNCHES = 0  # K3 (seg_pack > 1)
# segment counts the CUDA kernel is instantiated for
CUDA_SEG_PACKS = (1, 2, 4, 8)
_MAX_SMEM = 232448  # bytes of shared memory one block may use on an H100
# threads per block of K2: one target body each; S=2048 groups make
# 16 blocks per group
RUNS_THREADS = 128

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
    """The kernels' plain twin: per group, the occupied approx tiles and
    the direct tiles as [n_tiles, k_tile] source lanes (direct lanes
    outside their segment's [lo, hi) get gm = 0 before the guard; table
    entries past T are empty), per-tile partial sums, then the sum over
    tiles."""
    _check_seg_pack(seg_pack, k_tile)
    g_n, s, dims = targets.shape
    a = approx.shape[2]
    npad = sources_t.shape[1]
    t_cap = tiles.shape[2]
    rows = dims + 1  # coordinates, then gm
    sw = k_tile // seg_pack  # lanes per segment
    lane = torch.arange(sw, device=targets.device)
    out = torch.zeros_like(targets)
    for g, (a_lanes, d_t) in enumerate(lens.t().tolist()):
        a_t = -(-a_lanes // k_tile)
        width = min(a_t * k_tile, a)
        ap = torch.zeros((rows, a_t * k_tile), dtype=approx.dtype,
                         device=approx.device)
        ap[:, :width] = approx[g, :rows, :width]
        src = [ap.reshape(rows, a_t, k_tile)]
        d_t = min(d_t, -(-t_cap // seg_pack))
        if d_t:
            seg = torch.arange(d_t * seg_pack, device=targets.device)
            have = seg < t_cap
            start, lo, hi = torch.where(
                have, tiles[g, :, seg.clamp(max=t_cap - 1)], 0).long()
            col = start[:, None] + lane[None, :]  # [segments, sw]
            keep = ((lane >= lo[:, None]) & (lane < hi[:, None])
                    & (col < npad))
            dsrc = sources_t[:rows, col.clamp(max=npad - 1)]
            dsrc[dims] = torch.where(keep, dsrc[dims], 0.0)
            src.append(dsrc.reshape(rows, d_t, k_tile))
        src = torch.cat(src, dim=1)  # [rows, n_tiles, k]
        if src.shape[1] == 0:
            continue
        disp = [src[ax][None] - targets[g, :, ax, None, None]
                for ax in range(dims)]  # each [S, n_tiles, k]
        d2 = sum(da * da for da in disp)
        gm = src[dims][None]
        valid = (d2 > 0.0) & (gm > 0.0)
        safe = torch.where(valid, d2, torch.ones_like(d2))
        w = gm / (safe * (safe * torch.rsqrt(safe) + softening))
        w = torch.where(valid, w, torch.zeros_like(w))
        for ax in range(dims):
            out[g, :, ax] = (w * disp[ax]).sum(-1).sum(-1)
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

    On CUDA: kernel K2 (P = 1) or K3 (P in 2, 4, 8), f32 2D or 3D
    targets, int32 tables, contiguous inputs only.  On the CPU: the
    plain twin."""
    _check_seg_pack(seg_pack, k_tile)
    if not targets.is_cuda:
        return list_eval_runs_plain(
            targets, approx, sources_t, tiles, lens, softening=softening,
            k_tile=k_tile, seg_pack=seg_pack)
    global KERNEL_LAUNCHES, PACKED_LAUNCHES
    dev = targets.device
    g, s, dims = targets.shape
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
    if k_tile < 1 or 16 * k_tile > _MAX_SMEM:
        raise ValueError(
            f"k_tile={k_tile}: the staged tile must fit {_MAX_SMEM} bytes "
            "of shared memory (16 B per lane)")
    if g > 65535:
        raise ValueError(f"{g} groups exceed the grid's y dimension")
    out = torch.empty((g, s, dims), dtype=torch.float32, device=dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        code = lib.nbody_runs_eval(
            targets.data_ptr(), approx.data_ptr(), sources_t.data_ptr(),
            tiles.data_ptr(), lens.data_ptr(), out.data_ptr(), g, s,
            approx.shape[2], sources_t.shape[1], tiles.shape[2], k_tile,
            float(softening), dims, seg_pack, RUNS_THREADS,
            _cuda.stream_of(out),
        )
    if seg_pack == 1:
        _cuda.check(code, "runs_eval (K2)")
        KERNEL_LAUNCHES += 1
    else:
        _cuda.check(code, "runs_eval packed (K3)")
        PACKED_LAUNCHES += 1
    return out
