"""Simulation driver: the reference step loop with its side effects
(counterpart of ``nbody_tpu.models.simulation``, ``run_contract`` only).

``run_contract`` appends positions every step including step 0
(savePositions, project.cu:876/909), brackets force+update work in the
"parallel" stopwatch and the whole loop in the total timer
(project.cu:985-1007, 1083-1102), surfaces per-step cap overflow from
``state.overflow`` and, for Barnes-Hut, retries an overflowed step with
every cap at 4x.  With ``metrics_csv`` it records one metrics row for
step 0 before the total clock starts and one after every step inside the
total timer but outside the parallel stopwatch; with ``checkpoint_every``
it writes a checkpoint every that many steps.  The port runs eagerly:
CUDA launches are asynchronous, so each stopwatch bracket ends in
``torch.cuda.synchronize()``.

Not ported yet (the constructor raises): the fused ``lax.scan`` runs
(ROADMAP A3), quadtree dumps (A6) and multi-device steps (A11).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional, Tuple

import torch

from ..config import SimConfig
from ..physics import integrate
from ..rng import random_state
from ..state import SimState
from ..utils.checkpoint import save_checkpoint
from ..utils.metrics import MetricsWriter, tree_stats, tree_stats_3d
from ..utils.textio import PositionsWriter
from ..utils.timing import RunTiming, Stopwatch
from .engines import make_accel_fn, resolved_caps


def _unported(config: SimConfig) -> Optional[str]:
    if config.mesh.dp > 1:
        return "multi-device runs, --devices > 1 (ROADMAP A11)"
    if config.save_tree_dumps:
        return "--save-tree-dumps (ROADMAP A6)"
    return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Simulation:
    def __init__(self, config: SimConfig, state: Optional[SimState] = None,
                 device="cuda"):
        """``state`` defaults to ``random_state(config, device)``; a given
        state keeps its own device."""
        missing = _unported(config)
        if missing:
            raise NotImplementedError(f"{missing} is not yet ported")
        self.config = config
        self.state = state if state is not None else random_state(
            config, device=device)
        self.step_fn = self._make_step(config)
        self._step_fallback = None  # lazily-built 4x-cap retry step

    @staticmethod
    def _make_step(config: SimConfig):
        accel = make_accel_fn(config, return_diagnostics=True)
        dt = config.dt

        def step(state: SimState) -> SimState:
            acc, ovf = accel(state.positions, state.masses)
            return integrate(state, acc, dt, overflow=ovf.sum())

        return step

    def run_contract(self) -> Tuple[SimState, RunTiming]:
        """Reference-shaped run with file side effects and timing."""
        cfg = self.config
        state = self.state
        device = state.device
        timing = RunTiming()
        watch = Stopwatch()
        if cfg.save_positions or cfg.metrics_csv:
            os.makedirs(cfg.output_dir or ".", exist_ok=True)

        writer = None
        if cfg.save_positions:
            writer = PositionsWriter(
                os.path.join(cfg.output_dir, "positions.txt"))
            writer.append(float(state.time), state.positions.cpu().numpy())

        metrics = None
        if cfg.metrics_csv:
            metrics = MetricsWriter(
                os.path.join(cfg.output_dir, cfg.metrics_csv), g=cfg.g)
            # tree stats only mean something for the tree engine, and
            # rebuild the tree once per recorded step
            record_tree = cfg.metrics_tree and cfg.engine == "barnes_hut"
            metrics.record(state, self._tree_stats(state, record_tree))

        if device.type == "cuda":
            # build the kernels before the clock starts, as the
            # reference's nvcc build happens outside its timers
            from ..ops import _cuda

            _cuda.library()

        t_total0 = time.perf_counter()
        overflow_steps = 0
        for step_idx in range(cfg.n_steps):
            prev = state
            watch.start()
            state = self.step_fn(state)
            _sync(device)
            watch.stop()
            n_ovf = int(state.overflow)

            if n_ovf and cfg.adaptive_caps:
                print(
                    f"step {step_idx}: caps overflowed for {n_ovf} bodies; "
                    "retrying with 4x caps (adaptive)", file=sys.stderr)
                watch.start()
                state = self._fallback_step()(prev)
                _sync(device)
                watch.stop()
                n_ovf = int(state.overflow)

            if n_ovf:
                overflow_steps += 1
                if overflow_steps <= 3:
                    print(
                        f"WARNING: step {step_idx}: traversal caps "
                        f"overflowed for {n_ovf} bodies (forces drop "
                        "interactions); raise --frontier-cap / list/direct "
                        "caps", file=sys.stderr)

            if writer is not None:
                writer.append(float(state.time),
                              state.positions.cpu().numpy())
            if metrics is not None:
                metrics.record(state, self._tree_stats(state, record_tree))
            if cfg.checkpoint_every and (
                    step_idx + 1) % cfg.checkpoint_every == 0:
                save_checkpoint(self._checkpoint_path(), state)

        if overflow_steps > 3:
            print(
                f"WARNING: traversal caps overflowed on {overflow_steps} of "
                f"{cfg.n_steps} steps (first 3 reported above)",
                file=sys.stderr)

        timing.total_ms = (time.perf_counter() - t_total0) * 1e3
        timing.parallel_us = watch.accum_us
        if writer is not None:
            writer.flush()
        if metrics is not None:
            metrics.flush()
        self.state = state
        return state, timing

    def _fallback_step(self):
        """The adaptive-caps retry step: every traversal cap at 4x its
        resolved value (built on first overflow).  In 3D it re-collects
        through the gather walk, as the JAX package's retry does: 4x caps
        widen its frontiers."""
        if self._step_fallback is None:
            caps = {k: 4 * v for k, v in resolved_caps(self.config).items()}
            self._step_fallback = self._make_step(
                self.config.replace(collect3="gather", **caps))
        return self._step_fallback

    def _tree_stats(self, state: SimState, enabled: bool):
        if not enabled:
            return None
        stats = tree_stats_3d if state.positions.shape[1] == 3 else tree_stats
        return stats(state.positions, state.masses,
                     max_depth=self.config.resolved_max_depth)

    def _checkpoint_path(self) -> str:
        cfg = self.config
        return cfg.checkpoint_path or os.path.join(cfg.output_dir,
                                                   "checkpoint.npz")
