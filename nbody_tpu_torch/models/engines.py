"""Force engines: naive dense, all-pairs (kernel K1), grouped Barnes-Hut
in 2D (kernel K2, or K4 with quarter-split evaluation) and 3D (kernels
K2 and K3, or K4), each with the padded-list evaluators K6 (grid,
compensated) and K7 (dynamic) on request, and the exact per-body 2D
Barnes-Hut (``bh_mode="exact"``, eager torch) — counterpart of
``nbody_tpu.models.engines``.  One engine is the port's alone:
``barnes_hut_adaptive``, 3D grouped Barnes-Hut whose tree goes as deep
as the state needs (``ops/bh3d.bh3_accelerations_adaptive``), on one
device, step by step.

Every engine is an acceleration function of one signature:

    accel_fn(positions [N, D], masses [N]) -> accelerations [N, D]

(or ``(acc, overflow [N] bool)`` with ``return_diagnostics``).  The
kernels launch for CUDA tensors; CPU tensors take their plain twins.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import SimConfig, grouped_options
from ..physics import pair_accelerations_chunked, pair_accelerations_dense


# the Barnes-Hut engines (the ones with traversal caps and a tree)
BH_ENGINES = ("barnes_hut", "barnes_hut_adaptive")


def check_adaptive(config: SimConfig, fused: bool = False) -> None:
    """Raise, naming the missing case, where ``barnes_hut_adaptive``
    cannot run: it is 3D, on one device, in the per-step loop."""
    if config.engine != "barnes_hut_adaptive":
        return
    if config.n_dim != 3:
        raise ValueError("engine barnes_hut_adaptive is 3D only: it has no "
                         "2D (quadtree) form; use --dims 3")
    if config.mesh.dp > 1:
        raise ValueError("engine barnes_hut_adaptive runs on one device: "
                         "it has no sharded mode for --devices > 1")
    if fused:
        raise ValueError("engine barnes_hut_adaptive runs the per-step "
                         "loop only: it has no --fused (CUDA graph) form, "
                         "as its refinement is sized on the host each "
                         "step")


def resolved_caps(config: SimConfig) -> dict:
    """The traversal caps a Barnes-Hut engine will use — explicit
    config values, else the calibrated defaults; the basis of the 4x
    adaptive-caps retry (simulation.py)."""
    if config.engine == "barnes_hut_adaptive":
        from ..ops.bh3d import cap_defaults_adaptive

        d = cap_defaults_adaptive(config.n_bodies)
    elif config.n_dim == 3:
        from ..ops.bh3d import cap_defaults_3d

        d = cap_defaults_3d(config.n_bodies)
    else:
        from ..ops.bh_grouped import DEFAULT_GROUP_SIZE, cap_defaults

        d = cap_defaults(config.group_size or DEFAULT_GROUP_SIZE,
                         config.n_bodies)
    return dict(
        frontier_cap=config.frontier_cap or d["frontier_cap"],
        list_cap=config.list_cap or d["list_cap"],
        direct_cap=config.direct_cap or d["direct_cap"],
        direct_body_cap=config.direct_body_cap or d["direct_body_cap"],
        run_cap=config.run_cap or d["run_cap"],
    )


def _no_overflow(fn: Callable, return_diagnostics: bool) -> Callable:
    """Wrap an engine that cannot overflow in the diagnostics signature."""
    if not return_diagnostics:
        return fn

    def accel(positions, masses):
        acc = fn(positions, masses)
        return acc, torch.zeros((positions.shape[0],), dtype=torch.bool,
                                device=positions.device)

    return accel


def make_accel_fn(config: SimConfig,
                  return_diagnostics: bool = False) -> Callable:
    """Build the configured engine's acceleration function."""
    engine = config.engine
    g = config.g

    if engine == "naive":
        # main_approach_1.cpp semantics: dense O(N^2), no softening
        def naive(positions, masses):
            return pair_accelerations_dense(positions, masses, g=g)

        return _no_overflow(naive, return_diagnostics)

    if engine == "allpairs":
        from ..ops import allpairs
        from ..utils.occupancy import resolve_tiles

        if config.dtype == "float64":
            # the kernel is f32; float64 keeps full precision on the
            # chunked dense path, as in the JAX package
            def chunked(positions, masses):
                return pair_accelerations_chunked(positions, masses, g=g)

            return _no_overflow(chunked, return_diagnostics)

        def tiled(positions, masses):
            n = positions.shape[0]
            if n < 512:
                # tiny problems: the dense path (engines.py:104 of the
                # JAX package)
                return pair_accelerations_dense(positions, masses, g=g)
            tb, sb = resolve_tiles(n, config.target_block,
                                   config.source_block, config.compensated,
                                   verbose=config.verbose_occupancy)
            return allpairs.allpairs_accelerations(
                positions, masses, g=g, softening=0.0, target_block=tb,
                source_block=sb, compensated=config.compensated)

        return _no_overflow(tiled, return_diagnostics)

    # the grouped Barnes-Hut engines' options
    bh_kw = dict(
        grouped_options(config), max_depth=config.resolved_max_depth,
        return_diagnostics=return_diagnostics,
        compensated=config.compensated, eval_mode=config.eval_mode,
        eval_k_tile=config.eval_k_tile, run_cap=config.run_cap,
        split_eval=config.split_eval)
    if engine == "barnes_hut":
        if config.n_dim == 3:
            if config.bh_mode == "exact":
                raise ValueError(
                    "bh_mode='exact' is 2D-only (it mirrors the reference's "
                    "per-body quadtree DFS); 3D Barnes-Hut uses the grouped "
                    "octree engine (bh_mode='grouped')")
            from ..ops.bh3d import bh3_accelerations_grouped

            def grouped3(positions, masses):
                return bh3_accelerations_grouped(
                    positions, masses, collect=config.collect3, **bh_kw)

            return grouped3
        if config.bh_mode == "exact":
            from ..ops.barnes_hut import bh_accelerations

            def exact(positions, masses):
                return bh_accelerations(
                    positions, masses, g=g, theta=config.theta,
                    max_depth=config.resolved_max_depth,
                    softening=config.softening,
                    frontier_cap=config.frontier_cap or 256,
                    return_diagnostics=return_diagnostics,
                )

            return exact
        from ..ops.bh_grouped import bh_accelerations_grouped

        def grouped(positions, masses):
            return bh_accelerations_grouped(positions, masses, **bh_kw)

        return grouped

    if engine == "barnes_hut_adaptive":
        check_adaptive(config)
        if config.bh_mode == "exact":
            raise ValueError("bh_mode='exact' is 2D-only; "
                             "barnes_hut_adaptive is grouped")
        from ..ops.bh3d import bh3_accelerations_adaptive

        def adaptive3(positions, masses):
            return bh3_accelerations_adaptive(positions, masses, **bh_kw)

        return adaptive3

    raise ValueError(f"unknown engine {engine!r}")
