"""Morton run merging (counterpart of ``nbody_tpu.ops.experiments``; only
``merge_ranges`` is ported — the runs evaluator uses it)."""

from __future__ import annotations

import torch

from .bh_grouped import _INT_MAX, _sort_compact


def merge_ranges(ranges: torch.Tensor, cap: int | None = None):
    """Merge overlapping/adjacent per-group body ranges into maximal runs.

    Per row: sort by start, running max of ends, a run starts where a
    start exceeds every prior end; the starts and ends of the runs are
    compacted to the left.  ranges: [G, D, 2] (start, count), zero-count
    padded.  Returns ([G, min(D, cap), 2] merged (start, count), overflow
    [G]); ``cap`` defaults to min(D, 256)."""
    starts, counts = ranges[:, :, 0], ranges[:, :, 1]
    if cap is None:
        cap = min(ranges.shape[1], 256)
    valid = counts > 0
    key = torch.where(valid, starts, _INT_MAX)
    # valid starts are distinct (direct cells are disjoint), so the order
    # is the JAX package's
    s_sorted, perm = torch.sort(key, dim=1, stable=True)
    e_sorted = torch.gather(torch.where(valid, starts + counts, 0), 1, perm)
    v_sorted = s_sorted < _INT_MAX
    cmax = torch.cummax(e_sorted, dim=1).values
    prev_cmax = torch.cat([torch.full_like(cmax[:, :1], -1), cmax[:, :-1]], 1)
    new_run = v_sorted & (s_sorted > prev_cmax)
    nxt = torch.cat([new_run[:, 1:] | ~v_sorted[:, 1:],
                     torch.ones_like(new_run[:, :1])], 1)
    is_last = v_sorted & nxt
    (ms,), ovf_s = _sort_compact(
        new_run, [torch.where(new_run, s_sorted, 0)], cap)
    (me,), _ = _sort_compact(is_last, [torch.where(is_last, cmax, 0)], cap)
    return torch.stack([ms, (me - ms).clamp(min=0)], dim=-1), ovf_s
