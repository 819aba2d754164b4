"""Exact per-body Barnes-Hut: the stackless, level-synchronous frontier
traversal over the dense pyramid (counterpart of
``nbody_tpu.ops.barnes_hut``, the 2D parity engine, ``bh_mode="exact"``).

Every body walks the pyramid with its own bounded frontier of candidate
cells, root first: at each level the frontier cells' (mass, COM, count)
are gathered, accepted cells (non-empty and singleton, theta-accepted or
at max depth) contribute ``w * disp`` with ``w = G*M / (d2 * d)`` and
``d = sqrt(d2) + softening``, and the non-empty children of opened cells
are compacted into the next level's frontier.  See the JAX module for
why this is force-equal to the reference's per-body stack DFS
(project.cu:593-675), including the max-depth aggregates that their own
members accept (project.cu:378/760) and the singleton self-skip
(project.cu:646/760).

The operation order is the JAX package's: ``size < theta * d`` (no
divide), the ``d2 > 0`` guard on the weight, ``MASS_SKIP_THRESHOLD`` on
the cell mass, and the self-skip on ``own_codes >> 2 (max_depth -
level)``.  Frontiers are compacted by a scatter into ``[B, cap + 1]``
columns and a slice, as JAX's ``mode="drop"`` update: entries past the
cap and masked entries land in the dropped last column, so frontiers and
overflow flags come out equal to the JAX package's.

The XLA code of the reference is eager PyTorch here: no kernel.  The
body chunks are a Python loop over a static count with no host reads, so
a CUDA graph can hold the whole force pass.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import (
    BH_SOFTENING,
    MASS_SKIP_THRESHOLD,
    MAX_DEPTH_DEFAULT,
    THETA_DEFAULT,
)
from .tree import Quadtree, TreeLevel, build_quadtree, level_cell_size


def _frontier_caps(max_depth: int, cap: int) -> list:
    caps = [1]
    for level in range(1, max_depth + 1):
        caps.append(min(4 * caps[-1], cap, 4**level))
    return caps


def _traverse_chunk(
    px: torch.Tensor,  # [B]
    py: torch.Tensor,  # [B]
    own_codes: torch.Tensor,  # [B] leaf Morton code of each body
    tree: Quadtree,
    levels: Tuple[TreeLevel, ...],  # tree.levels, unpacked once
    *,
    theta: float,
    softening: float,
    g: float,
    frontier_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (acc_x [B], acc_y [B], overflowed [B] bool)."""
    max_depth = tree.max_depth
    caps = _frontier_caps(max_depth, frontier_cap)
    b = px.shape[0]
    dev = px.device

    acc_x = torch.zeros_like(px)
    acc_y = torch.zeros_like(py)
    overflow = torch.zeros((b,), dtype=torch.bool, device=dev)
    frontier = torch.zeros((b, 1), dtype=torch.int32, device=dev)  # root
    quad = torch.arange(4, dtype=torch.int32, device=dev)

    for level in range(max_depth + 1):
        lv = levels[level]
        valid = frontier >= 0
        idx = torch.where(valid, frontier, 0)
        gidx = idx.long()
        m = lv.mass[gidx]  # [B, F]
        cx = lv.comx[gidx]
        cy = lv.comy[gidx]
        cnt = lv.count[gidx]

        dx = cx - px[:, None]
        dy = cy - py[:, None]
        d2 = dx * dx + dy * dy
        d = torch.sqrt(d2) + softening
        size = level_cell_size(tree.bounds, level).to(px.dtype)
        theta_ok = size < theta * d  # size/d < theta without the divide

        nonempty = valid & (cnt > 0) & (m > MASS_SKIP_THRESHOLD)
        singleton = cnt == 1
        at_max = level == max_depth
        accept = nonempty if at_max else nonempty & (singleton | theta_ok)

        own_cell = own_codes >> (2 * (max_depth - level))
        self_skip = singleton & (frontier == own_cell[:, None])
        accept = accept & ~self_skip

        # w = G*M / (d2 * (d + eps)); d2 == 0 (a body exactly on an
        # accepted COM) gives 0 instead of the reference's inf*0 = NaN
        pos = d2 > 0
        safe = torch.where(pos, d2, torch.ones_like(d2))
        w = torch.where(accept & pos, g * m / (safe * d),
                        torch.zeros_like(d2))
        acc_x = acc_x + (w * dx).sum(1)
        acc_y = acc_y + (w * dy).sum(1)

        if at_max:
            break

        open_ = nonempty & ~singleton & ~theta_ok
        # children at level+1 (Morton: 4c .. 4c+3); non-empty ones only
        f = frontier.shape[1]
        children = (idx[:, :, None] * 4 + quad).reshape(b, 4 * f)
        child_cnt = levels[level + 1].count[children.long()]
        cmask = (open_[:, :, None].expand(b, f, 4).reshape(b, 4 * f)
                 & (child_cnt > 0))

        next_cap = caps[level + 1]
        slot = torch.cumsum(cmask.to(torch.int32), 1, dtype=torch.int32) - 1
        last = torch.where(cmask, slot, -1).amax(1)
        overflow = overflow | (last >= next_cap)
        # masked and past-cap entries all land in the dropped column
        col = torch.where(cmask, torch.clamp(slot, max=next_cap), next_cap)
        nxt = torch.full((b, next_cap + 1), -1, dtype=torch.int32, device=dev)
        nxt.scatter_(1, col.long(), torch.where(cmask, children, -1))
        frontier = nxt[:, :next_cap]

    return acc_x, acc_y, overflow


def traverse_accelerations(
    positions: torch.Tensor,
    own_codes: torch.Tensor,
    tree: Quadtree,
    *,
    g: float,
    theta: float = THETA_DEFAULT,
    softening: float = BH_SOFTENING,
    frontier_cap: int = 256,
    body_chunk: int = 8192,
):
    """Traverse a prebuilt tree for the given bodies, ``body_chunk``
    bodies at a time (each chunk holds [chunk, frontier_cap] working
    tensors; the tree is shared).  ``own_codes`` are the bodies' leaf
    Morton codes in ``tree`` (bodies of another cloud: codes that match
    no singleton of theirs).  Returns (acc [N, 2], overflowed [N] bool)."""
    n = positions.shape[0]
    dev = positions.device
    chunk = min(body_chunk, max(n, 1))
    n_pad = ((n + chunk - 1) // chunk) * chunk
    px = torch.zeros((n_pad,), dtype=positions.dtype, device=dev)
    py = torch.zeros_like(px)
    px[:n] = positions[:, 0]
    py[:n] = positions[:, 1]
    # padded bodies take own code -1: it matches no cell, so no self-skip;
    # their accelerations are sliced off below
    own = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    own[:n] = own_codes
    levels = tree.levels
    ax, ay, ovf = [], [], []
    for c0 in range(0, n_pad, chunk):
        sl = slice(c0, c0 + chunk)
        cx, cy, co = _traverse_chunk(
            px[sl], py[sl], own[sl], tree, levels, theta=theta,
            softening=softening, g=g, frontier_cap=frontier_cap)
        ax.append(cx)
        ay.append(cy)
        ovf.append(co)
    acc = torch.stack([torch.cat(ax)[:n], torch.cat(ay)[:n]], dim=-1)
    return acc, torch.cat(ovf)[:n]


def bh_accelerations(
    positions: torch.Tensor,
    masses: torch.Tensor,
    *,
    g: float,
    theta: float = THETA_DEFAULT,
    max_depth: int = MAX_DEPTH_DEFAULT,
    softening: float = BH_SOFTENING,
    frontier_cap: int = 256,
    body_chunk: int = 8192,
    return_diagnostics: bool = False,
):
    """Build + traverse: Barnes-Hut accelerations [N, 2] (and the overflow
    flags [N] with ``return_diagnostics``)."""
    tree = build_quadtree(positions, masses, max_depth=max_depth)
    acc, ovf = traverse_accelerations(
        positions, tree.codes, tree, g=g, theta=theta, softening=softening,
        frontier_cap=frontier_cap, body_chunk=body_chunk)
    if return_diagnostics:
        return acc, ovf
    return acc
