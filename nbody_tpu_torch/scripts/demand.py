"""Per-level traversal-demand calibration (sizes the frontier/list caps);
the port of ``scripts/demand.py``.

Runs the grouped collector with ``fmul`` x the engine's own frontier
schedule (default 2x) and ``return_demand=True``, printing the max over
groups of the opened-children demand entering each level, plus the
approx/direct per-group maxima: the numbers behind ``frontier_schedule``
/ ``cap_defaults`` in ops/bh_grouped.py and ops/bh3d.py.  Demand is
counted BEFORE truncation, so a level whose demand exceeds its
(multiplied) cap shows; if one does, re-run with a larger fmul (deeper
levels were under-walked).  list/direct caps do not affect the counts
(the masks are summed before compaction), so they stay small here.  The
merged-run demand (what ``run_cap`` bounds) is counted exactly in NumPy
from the direct ranges.

Usage: python -m nbody_tpu_torch.scripts.demand [--device cpu]
           n=524288,dims=3,init=uniform [spec...]
Optional keys: gs, theta, dcm (override direct_cell_max), fmul, steps
(advance the state that many steps with the engine first: demand shifts
as the cloud collapses).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

G = 6.67e-11


def initial_cloud(n: int, dims: int, init: str, rng):
    """(masses f64 [N], positions f64 [N, dims]) as the JAX script draws
    them: the reference's distribution, or two Gaussian blobs."""
    masses = 10 ** rng.uniform(-1, np.log10(0.5), n)
    if init == "blobs":
        k = n // 2
        c = rng.uniform(-0.05, 0.05, (2, dims))
        pts = np.concatenate([
            rng.normal(c[0], 0.004, (k, dims)),
            rng.normal(c[1], 0.004, (n - k, dims)),
        ])
        return masses, np.clip(pts, -0.1, 0.1)
    return masses, rng.uniform(-0.1, 0.1, (n, dims))


def merged_run_demand(ranges: np.ndarray) -> int:
    """Max over groups of the merged body runs (bh_grouped.merge_ranges
    semantics) of ``ranges`` [G, D, 2] (start, count), zero-count padded."""
    demand = 0
    for rg in ranges:
        rg = rg[rg[:, 1] > 0]
        if not len(rg):
            continue
        rg = rg[np.argsort(rg[:, 0])]
        ends = rg[:, 0] + rg[:, 1]
        # a new run starts where an interval does not touch the running
        # max end of everything before it
        prev_end = np.maximum.accumulate(ends)[:-1]
        demand = max(demand, int(1 + np.sum(rg[1:, 0] > prev_end)))
    return demand


def run(n, dims, init="uniform", gs=2048, theta=0.5, dcm=None, fmul=2,
        steps=0, device="cuda") -> dict:
    """Print and return the demand of one configuration (and the tree's
    root bounds, which the ``steps`` evolution moves)."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    m_np, p_np = initial_cloud(n, dims, init, rng)
    masses = torch.tensor(m_np, dtype=torch.float32, device=device)
    pos = torch.tensor(p_np, dtype=torch.float32, device=device)

    if dims == 3:
        from ..ops.bh3d import _collect_lists_3d as collect
        from ..ops.bh3d import bh3_accelerations_grouped as engine
        from ..ops.bh3d import (direct_cell_max_default, frontier_peak_3d,
                                frontier_schedule_3d)
        from ..ops.tree3d import build_octree as build
        from ..ops.tree3d import default_max_depth3

        md = default_max_depth3(n)
        dcm = dcm or direct_cell_max_default(n)
        kids = 8
        sched = frontier_schedule_3d(frontier_peak_3d(n), md, n)
    else:
        from ..ops.bh_grouped import _collect_lists as collect
        from ..ops.bh_grouped import bh_accelerations_grouped as engine
        from ..ops.bh_grouped import frontier_peak, frontier_schedule
        from ..ops.tree import build_quadtree as build

        md = 9
        dcm = dcm or 32
        kids = 4
        sched = frontier_schedule(frontier_peak(n), md, n)

    for _ in range(steps):
        pos = pos + engine(pos, masses, g=G, theta=theta)

    generous = tuple(min(kids**lv, fmul * c) for lv, c in enumerate(sched))
    tree = build(pos, masses, max_depth=md)
    tsort = pos[torch.argsort(tree.codes, stable=True)]
    n_sub = max(4, gs // 128)
    sub = tsort.reshape(-1, n_sub, gs // n_sub, dims)
    bbox = tuple(f(sub[..., a], 2) for a in range(dims)
                 for f in (torch.amin, torch.amax))
    out = collect(bbox, tree, theta=theta, softening=1e-15,
                  frontier_caps=generous, list_cap=4096, direct_cap=4096,
                  direct_cell_max=dcm, return_demand=True)
    stats = out[-1]
    runs = merged_run_demand(out[1].cpu().numpy())
    fr = stats["frontier"].cpu().tolist()
    truncated = [lv + 1 for lv, d in enumerate(fr) if d > generous[lv + 1]]
    approx, direct = int(stats["approx"]), int(stats["direct"])
    print(
        f"N={n} dims={dims} init={init} gs={gs} theta={theta} dcm={dcm} "
        f"steps={steps} fmul={fmul}\n"
        f"  engine schedule:                    {list(sched)}\n"
        f"  frontier demand entering levels 1..{md}: {fr}\n"
        f"  approx max/group: {approx}   direct max/group: {direct}   "
        f"merged runs max/group: {runs}"
        + (f"\n  WARNING: demand TRUNCATED at levels {truncated} — re-run "
           "with a larger fmul" if truncated else ""),
        flush=True,
    )
    return dict(frontier=fr, approx=approx, direct=direct, runs=runs,
                schedule=list(sched), truncated=truncated,
                bounds=tree.bounds.cpu().tolist())


def main(argv=None) -> int:
    from ._cli import parse

    device, specs = parse(argv, "nbody_tpu_torch.scripts.demand", __doc__)
    for parts in specs:
        run(int(parts.get("n", 65536)), int(parts.get("dims", 2)),
            init=parts.get("init", "uniform"), gs=int(parts.get("gs", 2048)),
            theta=float(parts.get("theta", 0.5)),
            dcm=int(parts["dcm"]) if "dcm" in parts else None,
            fmul=int(parts.get("fmul", 2)),
            steps=int(parts.get("steps", 0)), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
