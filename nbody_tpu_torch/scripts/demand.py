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

``engine=barnes_hut_adaptive`` (3D) measures the adaptive engine: the
pyramid's levels and the refinement's, walked with quarter bits; it also
prints the direct bodies and the merged runs a quarter group takes
(``direct_body_cap``, ``run_cap``) and the refinement's cells a level.
``init=plummer`` (3D) draws a Plummer sphere in Henon units (G = 1; key
``seed``), which ``steps`` advances by semi-implicit Euler steps (the
``plummer_1m`` deployment's softening and dt) of the engine at 4x its
caps; e.g. ``n=1048576,dims=3,init=plummer,engine=
barnes_hut_adaptive,steps=10``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

G = 6.67e-11
# the Plummer sphere's evolution, in Henon units
PLUMMER_SOFTENING = 0.01
PLUMMER_DT = 1.0 / 64


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
        steps=0, device="cuda", engine="barnes_hut", seed=0) -> dict:
    """Print and return the demand of one configuration (and the tree's
    root bounds, which the ``steps`` evolution moves)."""
    device = torch.device(device)
    adaptive = engine == "barnes_hut_adaptive"
    if (adaptive or init == "plummer") and dims != 3:
        raise ValueError(f"{engine}, init={init}: 3D only")
    if init == "plummer":
        from ..rng import plummer

        masses, pos, vel = (t.float().to(device) for t in plummer(
            torch.Generator().manual_seed(seed), n))
        g, softening = 1.0, PLUMMER_SOFTENING
    else:
        m_np, p_np = initial_cloud(n, dims, init,
                                   np.random.default_rng(seed))
        masses = torch.tensor(m_np, dtype=torch.float32, device=device)
        pos = torch.tensor(p_np, dtype=torch.float32, device=device)
        vel, g, softening = None, G, 1e-15
    refine = None

    if dims == 3:
        from ..ops import bh3d, tree3d

        md = tree3d.default_max_depth3(n)
        dcm = dcm or bh3d.direct_cell_max_default(n)
        kids = 8
        caps = (bh3d.cap_defaults_adaptive if adaptive
                else bh3d.cap_defaults_3d)(n)
        sched = (bh3d.frontier_schedule_adaptive if adaptive
                 else bh3d.frontier_schedule_3d)(caps["frontier_cap"], md, n)
        engine_fn = (bh3d.bh3_accelerations_adaptive if adaptive
                     else bh3d.bh3_accelerations_grouped)
    else:
        from ..ops.bh_grouped import _collect_lists as collect
        from ..ops.bh_grouped import bh_accelerations_grouped as engine_fn
        from ..ops.bh_grouped import frontier_peak, frontier_schedule
        from ..ops.tree import build_quadtree as build

        md = 9
        dcm = dcm or 32
        kids = 4
        sched = frontier_schedule(frontier_peak(n), md, n)

    for _ in range(steps):
        if vel is None:
            pos = pos + engine_fn(pos, masses, g=G, theta=theta)
        else:
            acc = engine_fn(pos, masses, g=g, theta=theta,
                            softening=softening,
                            **{k: 4 * c for k, c in caps.items()})
            vel = vel + acc * PLUMMER_DT
            pos = pos + vel * PLUMMER_DT

    generous = tuple(min(kids**lv, fmul * c) for lv, c in enumerate(sched))
    n_sub = max(4, gs // 128)
    walk = dict(theta=theta, softening=softening, frontier_caps=generous,
                direct_cell_max=dcm, return_demand=True)
    if dims == 3:
        if adaptive:
            tree, refine, order = tree3d.build_octree_adaptive(
                pos, masses, md, dcm)
        else:
            tree = tree3d.build_octree(pos, masses, max_depth=md)
            order = torch.argsort(tree.codes, stable=True)
        bbox = bh3d.sub_boxes_3d(pos[order].reshape(-1, gs, 3), n_sub)
        lists = (dict(list_cap=4 * caps["list_cap"],
                      direct_cap=4 * caps["direct_cap"], quarter_bits=True,
                      refine=refine) if adaptive
                 else dict(list_cap=4096, direct_cap=4096))
        out = bh3d._collect_lists_3d(bbox, tree, **walk, **lists)
    else:
        tree = build(pos, masses, max_depth=md)
        sub = pos[torch.argsort(tree.codes, stable=True)].reshape(
            -1, n_sub, gs // n_sub, dims)
        bbox = tuple(f(sub[..., a], 2) for a in range(dims)
                     for f in (torch.amin, torch.amax))
        out = collect(bbox, tree, list_cap=4096, direct_cap=4096, **walk)
    stats = out[-1]
    if adaptive:  # the merged runs and direct bodies of the worst quarter
        ranges, bits = out[1], out[3]["bits"]
        runs = bodies = 0
        for q in range(4):
            rq = torch.stack([ranges[..., 0], torch.where(
                ((bits >> q) & 1) > 0, ranges[..., 1], 0)], -1)
            runs = max(runs, merged_run_demand(rq.cpu().numpy()))
            bodies = max(bodies, int(rq[..., 1].sum(1).max()))
    else:
        runs, bodies = merged_run_demand(out[1].cpu().numpy()), None
    fr = stats["frontier"].cpu().tolist()
    truncated = [lv + 1 for lv, d in enumerate(fr) if d > generous[lv + 1]]
    approx, direct = int(stats["approx"]), int(stats["direct"])
    cells = None if refine is None else [r.shape[0] for r in refine.raw]
    print(
        f"N={n} dims={dims} init={init} engine={engine} gs={gs} "
        f"theta={theta} dcm={dcm} steps={steps} fmul={fmul}\n"
        f"  engine schedule:                    "
        f"{list(sched[:len(fr) + 1])}\n"
        f"  frontier demand entering levels 1..{len(fr)}: {fr}\n"
        + (f"  refined cells a level below {md}: {cells}\n" if cells
           is not None else "")
        + f"  approx max/group: {approx}   direct max/group: {direct}   "
        + (f"a quarter's direct bodies max: {bodies}   merged runs max a "
           f"quarter: {runs}" if adaptive else
           f"merged runs max/group: {runs}")
        + (f"\n  WARNING: demand TRUNCATED at levels {truncated} — re-run "
           "with a larger fmul" if truncated else ""),
        flush=True,
    )
    return dict(frontier=fr, approx=approx, direct=direct, runs=runs,
                bodies=bodies, cells=cells,
                schedule=list(sched[:len(fr) + 1]), truncated=truncated,
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
            steps=int(parts.get("steps", 0)), device=device,
            engine=parts.get("engine", "barnes_hut"),
            seed=int(parts.get("seed", 0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
