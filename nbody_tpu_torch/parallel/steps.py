"""Sharded simulation steps (counterpart of ``nbody_tpu.parallel.steps``):
each builder returns one rank's step, ``SimState -> SimState`` on the
rank's slab of the bodies, whose collectives go through the mesh's axes
(``parallel/collectives.py``):

* ``dp_allpairs`` — all_gather of (positions, masses); the slab's targets
  against the whole cloud on K1.  Comm O(N) per step.
* ``ring_allpairs`` — source slabs rotate by ppermute, so each rank sees
  the whole cloud in D hops while holding 2/D of it; partial
  accelerations summed in hop order.
* ``dp2d_allpairs`` — 2-D (dp x sp) interaction sharding: targets over dp,
  source stripes over sp, partials psum'd over sp.
* ``dp_barnes_hut`` — the leaf rows of each slab, one psum, the global
  pyramid on every rank, the exact per-body traversal of the slab
  (``ops/barnes_hut.py``).  Comm O(tree), independent of N.
* ``dp_barnes_hut_grouped`` / ``_grouped3`` — all_gather the cloud, build
  the quadtree / octree on every rank, grouped evaluation of the slab
  (K2; K3 and K4 in 3D where their gates resolve on; K6/K7 by
  ``eval_mode`` in 2D).
* ``dp_barnes_hut_sharded`` / ``_sharded3`` — the psum'd pyramid, the
  rank's Morton-sorted slab and its ring neighbours' (ppermute halos) as
  a source window placed at its global Morton indices, direct ranges
  gated to the window: per-rank sources O(N/D + tree).

Every step ends in the semi-implicit Euler update (``physics.integrate``,
the JAX package's ``_integrate_arrays``) with the GLOBAL (psum'd) count
of bodies whose caps overflowed in ``state.overflow``, which every rank
holds, so a retry decision on it is the same on every rank.  No
collective sits inside a grouped pass, whose data-dependent gates (the
3D segment-packing and spill gates) may then decide differently per
rank.  Each step's collectives run inside ``nbody.exchange`` spans
(``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import ROOT_PAD_FRACTION, SimConfig, grouped_options
from ..physics import integrate
from ..state import SimState
from ..utils.profiling import span
from .mesh import Mesh


def _make_accel_vs(config: SimConfig) -> Callable:
    """(tgt_pos, src_pos, src_masses) -> acc of targets due to sources, on
    K1 (its plain twin for CPU tensors), unsoftened, at the all-pairs
    engine's tile choice for the target count."""
    from ..ops.allpairs import allpairs_accelerations_vs
    from ..utils.occupancy import resolve_tiles

    def accel_vs(tgt, src, src_m):
        tb, sb = resolve_tiles(tgt.shape[0], config.target_block,
                               config.source_block,
                               verbose=config.verbose_occupancy)
        return allpairs_accelerations_vs(
            tgt, src, src_m, g=config.g, softening=0.0, target_block=tb,
            source_block=sb)

    return accel_vs


def _global_bounds(positions: torch.Tensor, ax) -> torch.Tensor:
    """ComputeRootBounds over every rank's bodies: the per-coordinate
    pmin / pmax padded as ``tree.root_bounds`` / ``tree3d.root_bounds_3d``
    pad (so one rank gives their bits)."""
    dims = positions.shape[1]
    with span("nbody.exchange"):
        lo = [ax.pmin(positions[:, d].min()) for d in range(dims)]
        hi = [ax.pmax(positions[:, d].max()) for d in range(dims)]
    max_dim = torch.stack([h - l for l, h in zip(lo, hi)]).max()
    pad = torch.where(max_dim == 0.0, torch.full_like(max_dim, 1e-6),
                      ROOT_PAD_FRACTION * max_dim)
    return torch.stack([b for l, h in zip(lo, hi)
                        for b in (l - pad, h + pad)])


def _n_overflow(ax, ovf: torch.Tensor) -> torch.Tensor:
    n = ovf.sum(dtype=torch.int32)
    with span("nbody.exchange"):
        return ax.psum(n)


def make_dp_allpairs_step(config: SimConfig, mesh: Mesh) -> Callable:
    """Bodies sharded over dp; per-step all_gather of the source cloud."""
    ax = mesh.axes[config.mesh.axis_name]
    accel_vs = _make_accel_vs(config)

    def step(state: SimState) -> SimState:
        with span("nbody.exchange"):
            all_pos = ax.all_gather(state.positions)
            all_m = ax.all_gather(state.masses)
        acc = accel_vs(state.positions, all_pos, all_m)
        return integrate(state, acc, config.dt)

    return step


def make_ring_allpairs_step(config: SimConfig, mesh: Mesh) -> Callable:
    """Bodies sharded on both sides; source slabs rotate around the ring
    (ppermute), the partial accelerations summed in hop order."""
    ax = mesh.axes[config.mesh.axis_name]
    n_dev = ax.size
    accel_vs = _make_accel_vs(config)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    def step(state: SimState) -> SimState:
        src_p, src_m = state.positions, state.masses
        acc = None
        for hop in range(n_dev):
            part = accel_vs(state.positions, src_p, src_m)
            acc = part if acc is None else acc + part
            if hop != n_dev - 1:
                with span("nbody.exchange"):
                    src_p = ax.ppermute(src_p, perm)
                    src_m = ax.ppermute(src_m, perm)
        return integrate(state, acc, config.dt)

    return step


def make_dp2d_allpairs_step(config: SimConfig, mesh: Mesh) -> Callable:
    """2-D interaction sharding: targets over the first axis (dp), source
    stripes over the second (sp), partial accelerations psum'd over sp.
    The state is the rank's dp slab (replicated over sp)."""
    dp_ax, sp_ax = (mesh.axes[name] for name in mesh.axis_names)
    sp = sp_ax.size
    accel_vs = _make_accel_vs(config)

    def step(state: SimState) -> SimState:
        with span("nbody.exchange"):
            all_pos = dp_ax.all_gather(state.positions)
            all_m = dp_ax.all_gather(state.masses)
        n = all_pos.shape[0]
        if n % sp:
            # without this the last n % sp bodies would silently drop as
            # force sources
            raise ValueError(
                f"dp2d_allpairs: global body count {n} not divisible by "
                f"the sp axis ({sp}); pad n_bodies or change the mesh")
        block = n // sp
        k = sp_ax.axis_index()
        part = accel_vs(state.positions, all_pos[k * block:(k + 1) * block],
                        all_m[k * block:(k + 1) * block])
        with span("nbody.exchange"):
            acc = sp_ax.psum(part)
        return integrate(state, acc, config.dt)

    return step


def make_dp_barnes_hut_step(config: SimConfig, mesh: Mesh) -> Callable:
    """Distributed exact Barnes-Hut: local leaf rows, one psum, the global
    pyramid on every rank, the per-body traversal of the rank's own
    bodies."""
    from ..ops.barnes_hut import traverse_accelerations
    from ..ops.tree import leaf_raw, morton_codes, pyramid_from_raw

    ax = mesh.axes[config.mesh.axis_name]
    md = config.resolved_max_depth
    frontier_cap = config.frontier_cap or 256

    def step(state: SimState) -> SimState:
        p, m = state.positions, state.masses
        bounds = _global_bounds(p, ax)
        codes = morton_codes(p, bounds, md)
        # ONE psum of the packed leaf rows: raw sums, counts included,
        # add across ranks; occupancy bits come after, in the pyramid
        raw = leaf_raw(p, m, codes, md)
        with span("nbody.exchange"):
            raw = ax.psum(raw)
        tree = pyramid_from_raw(raw, bounds, codes, md)
        acc, ovf = traverse_accelerations(
            p, codes, tree, g=config.g, theta=config.theta,
            softening=config.softening, frontier_cap=frontier_cap,
            body_chunk=min(8192, p.shape[0]))
        return integrate(state, acc, config.dt,
                         overflow=_n_overflow(ax, ovf))

    return step


def _grouped_kw(config: SimConfig) -> dict:
    """The grouped pass's options from the config (what the JAX package's
    grouped steps pass; no ``compensated``)."""
    return dict(
        grouped_options(config), eval_mode=config.eval_mode,
        eval_k_tile=config.eval_k_tile, run_cap=config.run_cap,
        split_eval=config.split_eval, return_diagnostics=True)


def make_dp_barnes_hut_grouped_step(config: SimConfig,
                                    mesh: Mesh) -> Callable:
    """Sharded grouped Barnes-Hut: all_gather the cloud (O(N) comm), build
    the quadtree on every rank, grouped evaluation of the rank's own
    bodies only: the evaluation, the bottleneck, scales as 1/D."""
    from ..ops.bh_grouped import grouped_eval
    from ..ops.tree import build_quadtree

    ax = mesh.axes[config.mesh.axis_name]
    kw = _grouped_kw(config)

    def step(state: SimState) -> SimState:
        with span("nbody.exchange"):
            all_pos = ax.all_gather(state.positions)
            all_m = ax.all_gather(state.masses)
        tree = build_quadtree(all_pos, all_m,
                              max_depth=config.resolved_max_depth)
        src_order = torch.argsort(tree.codes, stable=True)
        psort = all_pos[src_order]
        acc, ovf = grouped_eval(
            tree, target_positions=state.positions,
            sorted_x=psort[:, 0].contiguous(),
            sorted_y=psort[:, 1].contiguous(),
            sorted_gm=config.g * all_m[src_order], **kw)
        return integrate(state, acc, config.dt,
                         overflow=_n_overflow(ax, ovf))

    return step


def _source_window(ax, codes: torch.Tensor, cols, leaf_cnt: torch.Tensor):
    """The sharded modes' source window, placed at its global Morton
    indices (``nbody_tpu/parallel/steps.py:399-468``, 3D ``:630-688``).

    ``cols`` are the rank's per-body source columns (coordinates, g*m).
    The rank sorts its own bodies by code and swaps the sorted slab with
    its ring neighbours (two halos for D > 2, one for D == 2: the left
    neighbour is then the right one); the window is sorted again.  The
    global leaf counts (psum'd) give the leaf cells the window fully
    covers, [c_lo, c_hi], and their global index range [g0, g1): a count
    match says the window holds exactly the global order there, else it
    degrades to an empty window (every close cell then aggregates).  Slot
    i of the returned columns holds global index base + i, base =
    g0 rounded down to a multiple of 8; slots outside the live range get
    g*m = 0.  Returns (columns, (c_lo, c_hi), base); no host reads."""
    n_dev = ax.size
    order = torch.argsort(codes, stable=True)
    csort = codes[order]
    own = torch.stack([c[order] for c in cols], dim=1)  # [nl, D + 1]
    if n_dev > 1:
        perm_from_left = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        with span("nbody.exchange"):
            parts = [(ax.ppermute(own, perm_from_left),
                      ax.ppermute(csort, perm_from_left)), (own, csort)]
            if n_dev > 2:
                perm_from_right = [(i, (i - 1) % n_dev)
                                   for i in range(n_dev)]
                parts.append((ax.ppermute(own, perm_from_right),
                              ax.ppermute(csort, perm_from_right)))
        win = torch.cat([w for w, _ in parts])
        wc = torch.cat([c for _, c in parts])
        wo = torch.argsort(wc, stable=True)
        wc, win = wc[wo], win[wo]
    else:
        wc, win = csort, own

    leaf_cum = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=codes.device),
        torch.cumsum(leaf_cnt, 0, dtype=torch.int32)])
    # t[i] with a 0-d index tensor reads i on the host (torch's indexing
    # takes it as an int); torch.take reads it on the device
    c_min, c_max = wc[0], wc[-1]
    complete_lo = (wc == c_min).sum() == torch.take(leaf_cnt, c_min.long())
    complete_hi = (wc == c_max).sum() == torch.take(leaf_cnt, c_max.long())
    c_lo = torch.where(complete_lo, c_min, c_min + 1)
    c_hi = torch.where(complete_hi, c_max, c_max - 1)
    c_hi = torch.maximum(c_hi, c_lo - 1)  # may be empty
    g0 = torch.take(leaf_cum, c_lo.long())
    n_range = torch.take(leaf_cum, (c_hi + 1).long()) - g0
    ok = ((wc >= c_lo) & (wc <= c_hi)).sum() == n_range
    # degraded mode on a failed count match (ownership drifted more than
    # a slab): an empty window, every close cell aggregates at max depth
    zero = torch.zeros_like(g0)
    g0 = torch.where(ok, g0, zero)
    c_lo_eff = torch.where(ok, c_lo, zero + 1)
    c_hi_eff = torch.where(ok, c_hi, zero)
    n_range = torch.where(ok, n_range, zero)

    # slot i holds global index base + i, base 8-aligned (jnp.roll by
    # shift, as an index map: no host read of the shift)
    pad8 = g0 % 8
    base = g0 - pad8
    shift = pad8 - (wc < c_lo).sum()
    slot = torch.arange(wc.shape[0], device=codes.device)
    win = win[torch.remainder(slot - shift, wc.shape[0])]
    live = (slot >= pad8) & (slot < pad8 + n_range)
    win[:, -1] = torch.where(live, win[:, -1], 0.0)
    return [c.contiguous() for c in win.unbind(1)], (c_lo_eff, c_hi_eff), base


def make_dp_barnes_hut_sharded_step(config: SimConfig,
                                    mesh: Mesh) -> Callable:
    """Grouped-speed Barnes-Hut without replicating the cloud: per-rank
    sources O(N/D + tree).

    1. one psum of the packed leaf rows replicates the global pyramid;
    2. each rank Morton-sorts its own bodies and swaps sorted slabs with
       its ring neighbours (ppermute), a window placed at its global
       Morton indices (:func:`_source_window`);
    3. the grouped pass gates direct ranges to the window
       (``window_cells``): close cells outside it open to singletons and
       max-depth aggregates served by the pyramid, the reference DFS's own
       close-cell treatment (project.cu:641-658).

    Bodies stay with their owners: ranks should be seeded with contiguous
    global-Morton slabs (``shard_state`` of a Morton-sorted state), or the
    count match fails and the window degrades (``run`` shards an unsorted
    random state, as the JAX package's CLI does)."""
    from ..ops.bh_grouped import grouped_eval
    from ..ops.tree import RAW_CNT, leaf_raw, morton_codes, pyramid_from_raw

    ax = mesh.axes[config.mesh.axis_name]
    md = config.resolved_max_depth
    kw = _grouped_kw(config)

    def step(state: SimState) -> SimState:
        p, m = state.positions, state.masses
        bounds = _global_bounds(p, ax)
        codes = morton_codes(p, bounds, md)
        raw = leaf_raw(p, m, codes, md)
        with span("nbody.exchange"):
            raw = ax.psum(raw)
        tree = pyramid_from_raw(raw, bounds, codes, md)
        (wx, wy, wgm), window, base = _source_window(
            ax, codes, (p[:, 0], p[:, 1], config.g * m),
            raw[:, RAW_CNT].to(torch.int32))
        acc, ovf = grouped_eval(
            tree, target_positions=p, target_codes=codes, sorted_x=wx,
            sorted_y=wy, sorted_gm=wgm, window_cells=window,
            range_offset=base, n_sources_hint=p.shape[0] * ax.size, **kw)
        return integrate(state, acc, config.dt,
                         overflow=_n_overflow(ax, ovf))

    return step


def make_dp_barnes_hut_grouped3_step(config: SimConfig,
                                     mesh: Mesh) -> Callable:
    """3D mirror of the grouped step: all_gather the cloud, build the
    octree (and the dense collector's spatial pyramid where its gate
    resolves on) on every rank, grouped evaluation of the rank's
    bodies."""
    from ..ops.bh3d import _resolve_collect, grouped_eval_3d
    from ..ops.collect_dense3 import build_spatial_pyramid
    from ..ops.tree3d import build_octree

    ax = mesh.axes[config.mesh.axis_name]
    kw = _grouped_kw(config)

    def step(state: SimState) -> SimState:
        with span("nbody.exchange"):
            all_pos = ax.all_gather(state.positions)
            all_m = ax.all_gather(state.masses)
        tree = build_octree(all_pos, all_m,
                            max_depth=config.resolved_max_depth)
        spyr = None
        if _resolve_collect(config.collect3, all_pos.shape[0]) == "dense":
            spyr = build_spatial_pyramid(tree)
        src_order = torch.argsort(tree.codes, stable=True)
        psort = all_pos[src_order]
        acc, ovf = grouped_eval_3d(
            state.positions, tree,
            sorted_srcs=(psort[:, 0].contiguous(), psort[:, 1].contiguous(),
                         psort[:, 2].contiguous(),
                         config.g * all_m[src_order]),
            collect=config.collect3, spyr=spyr, **kw)
        return integrate(state, acc, config.dt,
                         overflow=_n_overflow(ax, ovf))

    return step


def make_dp_barnes_hut_sharded3_step(config: SimConfig,
                                     mesh: Mesh) -> Callable:
    """3D (octree) mirror of :func:`make_dp_barnes_hut_sharded_step`.  As
    in the JAX package it passes the caps and the group shape but not the
    evaluator options (eval_mode, k_tile, run cap, split), which resolve
    from the global N."""
    from ..ops.bh3d import grouped_eval_3d
    from ..ops.tree3d import (
        R3_CNT,
        leaf_raw_3d,
        morton_codes_3d,
        pyramid_from_raw_3d,
    )

    ax = mesh.axes[config.mesh.axis_name]
    md = config.resolved_max_depth
    opts = grouped_options(config)

    def step(state: SimState) -> SimState:
        p, m = state.positions, state.masses
        bounds = _global_bounds(p, ax)
        codes = morton_codes_3d(p, bounds, md)
        raw = leaf_raw_3d(p, m, codes, md)
        with span("nbody.exchange"):
            raw = ax.psum(raw)
        tree = pyramid_from_raw_3d(raw, bounds, codes, md)
        srcs, window, base = _source_window(
            ax, codes, (p[:, 0], p[:, 1], p[:, 2], config.g * m),
            raw[:, R3_CNT].to(torch.int32))
        acc, ovf = grouped_eval_3d(
            p, tree, target_codes=codes, sorted_srcs=tuple(srcs),
            window_cells=window, range_offset=base,
            n_sources_hint=p.shape[0] * ax.size, return_diagnostics=True,
            **opts)
        return integrate(state, acc, config.dt,
                         overflow=_n_overflow(ax, ovf))

    return step


STEP_BUILDERS = {
    "dp_allpairs": make_dp_allpairs_step,
    "ring_allpairs": make_ring_allpairs_step,
    "dp_barnes_hut": make_dp_barnes_hut_step,
    "dp_barnes_hut_grouped": make_dp_barnes_hut_grouped_step,
    "dp_barnes_hut_sharded": make_dp_barnes_hut_sharded_step,
    "dp_barnes_hut_grouped3": make_dp_barnes_hut_grouped3_step,
    "dp_barnes_hut_sharded3": make_dp_barnes_hut_sharded3_step,
    "dp2d_allpairs": make_dp2d_allpairs_step,
}


def make_sharded_step(config: SimConfig, mesh: Mesh,
                      mode: str = "dp_allpairs") -> Callable:
    """This rank's sharded step.  ``mode="auto"`` picks the Barnes-Hut
    distribution (grouped full replication vs the sharded-source window)
    from the per-device memory model (:mod:`.memory`)."""
    if mode == "auto":
        from .memory import choose_bh_mode

        mode = choose_bh_mode(config, mesh.size, verbose=mesh.is_root,
                              device=mesh.device)
    try:
        builder = STEP_BUILDERS[mode]
    except KeyError:
        raise ValueError(
            f"unknown mode {mode!r}; options: {sorted(STEP_BUILDERS)}"
        ) from None
    return builder(config, mesh)
