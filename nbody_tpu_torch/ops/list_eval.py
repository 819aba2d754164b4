"""Grouped Barnes-Hut list evaluation: the CUDA kernel K2
(``csrc/runs_eval.cu``) and its plain PyTorch twin.

Counterpart of ``nbody_tpu.ops.list_eval.list_eval_runs`` at
``seg_pack=1`` (the Pallas ``_runs_kernel``).  Each Morton group's
bodies take the Barnes-Hut pair force (softened direction, unsoftened
magnitude, project.cu:651-658, guard (d2 > 0) & (gm > 0)) from the
occupied tiles of its approx list and from its direct k-tiles, read
straight from the Morton-sorted transposed source table and masked to
their [lo, hi) lanes.  The other Pallas evaluators of the JAX module
(``list_eval_pallas`` K6, ``list_eval_dynamic`` K7, ``seg_pack > 1`` K3,
``list_eval_runs_split`` K4) are not ported yet (ROADMAP Queue B).

:func:`list_eval_runs` launches the kernel for CUDA tensors and takes the
twin only for CPU tensors.  ``KERNEL_LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _cuda

KERNEL_LAUNCHES = 0
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


def list_eval_runs_plain(
    targets: torch.Tensor,  # [G, S, D]
    approx: torch.Tensor,  # [G, 8, A]
    sources_t: torch.Tensor,  # [8, Npad]
    tiles: torch.Tensor,  # [G, 3, T]
    lens: torch.Tensor,  # [2, G]
    *,
    softening: float,
    k_tile: int,
) -> torch.Tensor:
    """The kernel's plain twin: per group, the occupied approx tiles and
    the direct tiles as [n_tiles, k_tile] source lanes (direct lanes
    outside [lo, hi) get gm = 0 before the guard), per-tile partial sums,
    then the sum over tiles."""
    g_n, s, dims = targets.shape
    a = approx.shape[2]
    npad = sources_t.shape[1]
    rows = dims + 1  # coordinates, then gm
    lane = torch.arange(k_tile, device=targets.device)
    out = torch.zeros_like(targets)
    for g, (a_lanes, d_t) in enumerate(lens.t().tolist()):
        a_t = -(-a_lanes // k_tile)
        width = min(a_t * k_tile, a)
        ap = torch.zeros((rows, a_t * k_tile), dtype=approx.dtype,
                         device=approx.device)
        ap[:, :width] = approx[g, :rows, :width]
        src = [ap.reshape(rows, a_t, k_tile)]
        if d_t:
            start, lo, hi = tiles[g, :, :d_t].long()  # [d_t] each
            col = start[:, None] + lane[None, :]  # [d_t, k]
            keep = (lane >= lo[:, None]) & (lane < hi[:, None]) & (col < npad)
            dsrc = sources_t[:rows, col.clamp(max=npad - 1)]  # [rows, d_t, k]
            dsrc[dims] = torch.where(keep, dsrc[dims], 0.0)
            src.append(dsrc)
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
    targets: torch.Tensor,  # [G, S, D] group body positions
    approx: torch.Tensor,  # [G, 8, A] approx lists, rows [x, y, gm, 0...]
    sources_t: torch.Tensor,  # [8, Npad] all sorted sources transposed
    tiles: torch.Tensor,  # [G, 3, T] int32 [start, lo, hi] per tile
    lens: torch.Tensor,  # [2, G] int32 [approx lanes, direct tiles]
    *,
    softening: float,
    k_tile: int = 2048,
    seg_pack: int = 1,
) -> torch.Tensor:
    """Gather-free list evaluation; the same tensors as
    ``nbody_tpu.ops.list_eval.list_eval_runs``.  Returns [G, S, D].

    On CUDA: kernel K2, f32 2D targets, int32 tables, contiguous inputs
    only.  On the CPU: the plain twin."""
    if seg_pack != 1:
        raise NotImplementedError(
            "seg_pack > 1 (kernel K3, _runs_kernel with packed segments) "
            "is not yet ported (ROADMAP Queue B, K3)")
    if not targets.is_cuda:
        return list_eval_runs_plain(
            targets, approx, sources_t, tiles, lens, softening=softening,
            k_tile=k_tile)
    global KERNEL_LAUNCHES
    dev = targets.device
    g, s = targets.shape[0], targets.shape[1]
    _cuda.require(targets, "targets", torch.float32, (g, s, 2), dev)
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
    out = torch.empty((g, s, 2), dtype=torch.float32, device=dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        code = lib.nbody_runs_eval(
            targets.data_ptr(), approx.data_ptr(), sources_t.data_ptr(),
            tiles.data_ptr(), lens.data_ptr(), out.data_ptr(), g, s,
            approx.shape[2], sources_t.shape[1], tiles.shape[2], k_tile,
            float(softening), RUNS_THREADS, _cuda.stream_of(out),
        )
    _cuda.check(code, "runs_eval (K2)")
    KERNEL_LAUNCHES += 1
    return out
