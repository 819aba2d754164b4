"""Simulation: the reference step loop, two execution modes
(counterpart of ``nbody_tpu.models.simulation``).

* ``run_contract`` — per-step host loop with the reference's side
  effects: positions appended every step including step 0
  (savePositions, project.cu:876/909), quadtree dumps at the first and
  last steps (project.cu:890-893, 962-965), force+update work bracketed
  in the "parallel" stopwatch and the whole loop in the total timer
  (project.cu:985-1007, 1083-1102); per-step cap overflow surfaces from
  ``state.overflow`` and, for Barnes-Hut, an overflowed step is retried
  with every cap at 4x.  With ``metrics_csv`` it records one metrics row
  for step 0 before the total clock starts and one after every step
  inside the total timer but outside the parallel stopwatch; with
  ``checkpoint_every`` it writes a checkpoint every that many steps.
  CUDA launches are asynchronous, so each stopwatch bracket ends in
  ``torch.cuda.synchronize()``.

* ``run_scan`` / ``run_scan_trajectory`` — the fused run, the
  counterpart of the JAX package's one ``lax.scan`` program: no per-step
  host crossing, no adaptive retry, per-step overflow counts kept on the
  device and warned about after the run.  On the card every step runs
  as a CUDA graph (:class:`StepGraph`: captured once, replayed every
  step); the step's data-dependent gates (3D Barnes-Hut's segment
  packing and the dense collector's spill pass) are conditional nodes in
  it, as they are ``lax.cond`` in the JAX package.  Every CPU run goes
  step by step with the same semantics.

A multi-device run gives each rank a ``Simulation`` of its slab with the
sharded step of ``parallel/steps.py`` (``step_fn``), its 4x-caps retry
builder (``step_fallback_fn``) and its ``mesh``: every rank steps its
slab, the retry decision reads the global overflow count every rank
holds, and rank 0 alone writes positions, dumps, metrics and
checkpoints, from the state gathered over the mesh (a collective every
rank joins).  Its fused run is one CUDA graph a rank, its NCCL
collectives captured in it, as the JAX package's ``run_scan`` is one
``lax.scan`` of the shard_map step; only thread ranks (a test device:
``parallel.thread_meshes``) go step by step.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SimConfig
from ..ops import _graph
from ..physics import integrate
from ..rng import random_state
from ..state import SimState
from ..utils.checkpoint import save_checkpoint
from ..utils.metrics import MetricsWriter, tree_stats, tree_stats_3d
from ..utils.profiling import span
from ..utils.textio import PositionsWriter
from ..utils.timing import RunTiming, Stopwatch
from .engines import (BH_ENGINES, check_adaptive, make_accel_fn,
                      resolved_caps)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# why a fused run on thread ranks goes step by step
THREAD_GATE = ("thread ranks run step by step: D threads share one stream "
               "and meet at a Python barrier, which a CUDA graph cannot "
               "hold (a test device only)")


class Simulation:
    def __init__(self, config: SimConfig, state: Optional[SimState] = None,
                 device="cuda", step_fn=None, step_fallback_fn=None,
                 mesh=None):
        """``state`` defaults to ``random_state(config, device)``; a given
        state keeps its own device.  ``step_fn`` replaces the engine's
        step (a sharded step of ``parallel/steps.py``: ``state`` is then
        the rank's slab and ``mesh`` its mesh); ``step_fallback_fn`` is a
        0-arg builder of its 4x-caps retry step, without which an
        overflowed custom step warns but is not retried."""
        self.config = config
        self.state = state if state is not None else random_state(
            config, device=device)
        self.mesh = mesh
        self.is_root = mesh is None or mesh.is_root
        self._custom_step = step_fn is not None
        self.step_fn = step_fn or self._make_step(config)
        self._step_fallback = None  # lazily-built 4x-cap retry step
        self._step_fallback_builder = step_fallback_fn
        # the last fused run: per-step overflow counts, its route
        # ("graph" or "eager"), the capture's and the run's wall times
        self.last_scan_overflow = None
        self.last_scan_route = None
        # {conditional branch of the graph: replays that took it}, and
        # {counter: what a replay counts outside the branches}
        self.last_branch_counts = {}
        self.last_replay_launches = {}
        self.last_capture_ms = 0.0
        self.last_scan_ms = 0.0
        # the last run's steps retried at 4x caps (the contract loop), and
        # its steps that ended with caps overflowed
        self.last_retried_steps = 0
        self.last_overflowed_steps = 0

    @staticmethod
    def _make_step(config: SimConfig):
        accel = make_accel_fn(config, return_diagnostics=True)
        dt = config.dt

        def step(state: SimState) -> SimState:
            acc, ovf = accel(state.positions, state.masses)
            return integrate(state, acc, dt, overflow=ovf.sum())

        return step

    def run_contract(self) -> Tuple[SimState, RunTiming]:
        """Reference-shaped run with file side effects and timing.  Spans
        (``utils/profiling.py``): ``nbody.run`` around it, and a step
        ``nbody.step``, ``nbody.sync`` (the synchronise and the overflow
        count's host read) and, for a retried step, ``nbody.retry`` and
        its own ``nbody.sync``."""
        with span("nbody.run", counted=True):
            return self._contract()

    def _contract(self) -> Tuple[SimState, RunTiming]:
        cfg = self.config
        state = self.state
        device = state.device
        timing = RunTiming()
        watch = Stopwatch()
        if cfg.save_positions or cfg.save_tree_dumps or cfg.metrics_csv:
            os.makedirs(cfg.output_dir or ".", exist_ok=True)

        writer = metrics = None
        if self.is_root and cfg.save_positions:
            writer = PositionsWriter(
                os.path.join(cfg.output_dir, "positions.txt"))
        if self.is_root and cfg.metrics_csv:
            metrics = MetricsWriter(
                os.path.join(cfg.output_dir, cfg.metrics_csv), g=cfg.g)
        # tree stats only mean something for the tree engine, and rebuild
        # the tree once per recorded step
        record_tree = cfg.metrics_tree and cfg.engine in BH_ENGINES
        if cfg.save_positions or cfg.metrics_csv:
            self._record(self._host_state(state), writer, metrics,
                         record_tree)

        if device.type == "cuda":
            # build the kernels before the clock starts, as the
            # reference's nvcc build happens outside its timers
            from ..ops import _cuda

            _cuda.library()

        t_total0 = time.perf_counter()
        overflow_steps = retried_steps = 0
        dump_tree = self._dumps_enabled()
        for step_idx in range(cfg.n_steps):
            if dump_tree and step_idx in (0, cfg.n_steps - 1):
                self._dump_tree(state, first=(step_idx == 0))

            prev = state
            watch.start()
            with span("nbody.step"):
                state = self.step_fn(state)
            with span("nbody.sync"):
                _sync(device)
                watch.stop()
                n_ovf = _graph.host_read(state.overflow)

            retry = self._fallback_step() if (
                n_ovf and cfg.adaptive_caps) else None
            if retry is not None:
                print(
                    f"step {step_idx}: caps overflowed for {n_ovf} bodies; "
                    "retrying with 4x caps (adaptive)", file=sys.stderr)
                retried_steps += 1
                watch.start()
                with span("nbody.retry"):
                    state = retry(prev)
                with span("nbody.sync"):
                    _sync(device)
                    watch.stop()
                    n_ovf = _graph.host_read(state.overflow)

            if n_ovf:
                overflow_steps += 1
                if overflow_steps <= 3:
                    print(
                        f"WARNING: step {step_idx}: traversal caps "
                        f"overflowed for {n_ovf} bodies (forces drop "
                        "interactions); raise --frontier-cap / list/direct "
                        "caps", file=sys.stderr)

            ckpt = cfg.checkpoint_every and (
                step_idx + 1) % cfg.checkpoint_every == 0
            if cfg.save_positions or cfg.metrics_csv or ckpt:
                host = self._host_state(state)
                self._record(host, writer, metrics, record_tree)
                if ckpt and self.is_root:
                    save_checkpoint(self._checkpoint_path(), host)

        if overflow_steps > 3:
            print(
                f"WARNING: traversal caps overflowed on {overflow_steps} of "
                f"{cfg.n_steps} steps (first 3 reported above)",
                file=sys.stderr)

        timing.total_ms = (time.perf_counter() - t_total0) * 1e3
        timing.parallel_us = watch.accum_us
        self.last_retried_steps = retried_steps
        self.last_overflowed_steps = overflow_steps
        if writer is not None:
            writer.flush()
        if metrics is not None:
            metrics.flush()
        self.state = state
        return state, timing

    def _host_state(self, state: SimState) -> SimState:
        """The whole state for host outputs: ``state`` itself, or under a
        mesh the state gathered from every rank (every rank calls this at
        the same points)."""
        if self.mesh is None:
            return state
        from ..parallel.mesh import gather_state

        return gather_state(state, self.mesh)

    def _record(self, state: SimState, writer, metrics,
                record_tree: bool) -> None:
        """Append ``state`` to the positions file and the metrics CSV
        (each None on ranks other than 0)."""
        if writer is not None:
            writer.append(float(state.time), state.positions.cpu().numpy())
        if metrics is not None:
            metrics.record(state, self._tree_stats(state, record_tree))

    def fused_gate(self) -> Optional[str]:
        """Why a fused run of this simulation on the card goes step by
        step (thread ranks), or None when it is one CUDA graph of the
        step: one device, or a rank of a process-group mesh, whose graph
        holds the step's NCCL collectives."""
        if self.mesh is None or all(
                ax.capturable for ax in self.mesh.axes.values()):
            return None
        return THREAD_GATE

    def run_scan(self, n_steps: Optional[int] = None) -> SimState:
        """The whole run with no per-step host crossing (the JAX
        package's ``lax.scan``).  Per-step cap-overflow counts land in
        ``self.last_scan_overflow`` [n_steps] and are warned about after
        the run.  Unlike the contract loop, the fused run keeps
        overflowed steps: there is no adaptive retry; rerun without
        --fused or raise the caps if it warns.

        On the card the step is captured as a CUDA graph and replayed
        (capture and warm-up outside ``last_scan_ms``), but on thread
        ranks, which go step by step; ``last_scan_route`` says which, and
        ``last_branch_counts`` how many replays took each conditional
        branch of the graph.  A capture that fails raises, on the rank
        where it failed: nothing falls back to the step-by-step route.

        Under a mesh each rank replays its own graph, the step's
        collectives in it; ``last_scan_ms`` ends at the rank's own sync,
        and as every replay ends in collectives (the overflow count's
        psum, if no other), rank 0's sync waits for its peers too."""
        n = n_steps if n_steps is not None else self.config.n_steps
        with span("nbody.run", counted=True):
            self.state, _, ovf = self._fused(n, trajectory=False)
            self._report_scan_overflow(ovf)
        return self.state

    def run_scan_trajectory(self, n_steps: Optional[int] = None):
        """:meth:`run_scan` that also returns the stacked position
        history [n_steps + 1, N, D] (step 0 included, like
        savePositions), kept on the device: the per-step positions.txt
        capture without per-step crossings.  Returns (final, traj); under
        a mesh ``traj`` holds every rank's bodies (gathered once, at the
        end) and ``final`` the rank's slab."""
        n = n_steps if n_steps is not None else self.config.n_steps
        with span("nbody.run", counted=True):
            final, traj, ovf = self._fused(n, trajectory=True)
            if self.mesh is not None:
                ax = self.mesh.axes[self.config.mesh.axis_name]
                traj = ax.all_gather(traj.transpose(0, 1)).transpose(0, 1)
            self.state = final
            self._report_scan_overflow(ovf)
        return final, traj

    def _fused(self, n: int, trajectory: bool):
        """(final state, trajectory or None, per-step overflow [n] int32
        on the device) of ``n`` fused steps from ``self.state``.  Spans:
        ``nbody.capture`` (what ``last_capture_ms`` times) and
        ``nbody.replay`` (the replays and their synchronise; counted)."""
        if not self._custom_step:
            check_adaptive(self.config, fused=True)
        state = self.state
        device = state.device
        graph = device.type == "cuda" and self.fused_gate() is None
        self.last_scan_route = "graph" if graph else "eager"
        if device.type == "cuda":
            from ..ops import _cuda

            _cuda.library()  # the kernels' build stays outside the clock
        if graph and n > 0:
            _sync(device)
            with span("nbody.capture"):
                t0 = time.perf_counter()
                g = StepGraph(self.step_fn, state, n, trajectory)
                _sync(device)
                self.last_capture_ms = (time.perf_counter() - t0) * 1e3
            with span("nbody.replay", counted=True):
                t0 = time.perf_counter()
                g.replay(n)
                _sync(device)
                self.last_scan_ms = (time.perf_counter() - t0) * 1e3
            self.last_branch_counts = g.settle()
            self.last_replay_launches = {
                name: k for name, k in g.counts.per_replay.items() if k}
            return g.state, g.trajectory, g.overflow

        self.last_capture_ms = 0.0
        self.last_branch_counts = {}
        self.last_replay_launches = {}
        ovf = torch.zeros((n,), dtype=torch.int32, device=device)
        traj = None
        if trajectory:
            traj = torch.empty((n + 1, *state.positions.shape),
                               dtype=state.dtype, device=device)
            traj[0] = state.positions
        _sync(device)
        t0 = time.perf_counter()
        for k in range(n):
            state = self.step_fn(state)
            ovf[k] = state.overflow
            if traj is not None:
                traj[k + 1] = state.positions
        _sync(device)
        self.last_scan_ms = (time.perf_counter() - t0) * 1e3
        return state, traj, ovf

    def _report_scan_overflow(self, ovf: torch.Tensor) -> None:
        """Warn like the contract loop does (first 3 steps and a summary)
        from the per-step counts a fused run kept (one host read)."""
        counts = ovf.cpu().numpy()
        self.last_scan_overflow = counts
        bad = np.nonzero(counts)[0]
        self.last_retried_steps = 0
        self.last_overflowed_steps = int(bad.size)
        if bad.size == 0:
            return
        for step_idx in bad[:3]:
            print(
                f"WARNING: step {int(step_idx)}: traversal caps overflowed "
                f"for {int(counts[step_idx])} bodies (forces drop "
                "interactions); fused runs do NOT retry — raise "
                "--frontier-cap / list/direct caps or rerun without "
                "--fused for the adaptive-caps retry",
                file=sys.stderr,
            )
        if bad.size > 3:
            print(
                f"WARNING: traversal caps overflowed on {bad.size} of "
                f"{counts.size} steps (first 3 reported above)",
                file=sys.stderr,
            )

    def _dumps_enabled(self) -> bool:
        """Whether this run writes quadtree dumps: asked for, and 2D (the
        JAX package's warning otherwise)."""
        if not self.config.save_tree_dumps:
            return False
        if self.config.n_dim != 2:
            print(
                "WARNING: --save-tree-dumps is 2D-only (the quadtree dump "
                "contract, TraverseTreeToFile project.cu:485-533, has no "
                "3D analogue in the reference); skipping dumps",
                file=sys.stderr,
            )
            return False
        return True

    def _dump_tree(self, state: SimState, first: bool,
                   positions=None) -> None:
        """Write the quadtree dump for this step (TraverseTreeToFile
        contract) from the adaptive tree rebuilt on the host, as the
        reference builds it there every step (project.cu:959): the
        native C++ engine, else the f64 oracle (byte-equal to it).
        ``positions`` overrides the state's (the fused run dumps the
        final tree from a trajectory row; under a mesh, a row of every
        rank's bodies).  Under a mesh every rank calls this (the state is
        gathered) and rank 0 writes."""
        cfg = self.config
        state = self._host_state(state)
        if not self.is_root:
            return
        pos = state.positions if positions is None else positions
        pos = pos.detach().double().cpu().numpy()
        masses = state.masses.detach().double().cpu().numpy()
        try:
            from ..utils import native

            text = native.tree_dump(pos, masses,
                                    max_depth=cfg.resolved_max_depth)
        except RuntimeError:  # NativeUnavailable, or the library failed
            from .oracle import AdaptiveQuadtree

            tree = AdaptiveQuadtree(max_depth=cfg.resolved_max_depth).build(
                pos, masses)
            text = "\n".join(tree.dump_lines(pos)) + "\n"
        name = "quadtree_init.txt" if first else "quadtree_final.txt"
        with open(os.path.join(cfg.output_dir, name), "w") as f:
            f.write(text)

    def _fallback_step(self):
        """The adaptive-caps retry step (built on first overflow): every
        traversal cap at 4x its resolved value; in 3D it re-collects
        through the gather walk, as the JAX package's retry does (4x caps
        widen its frontiers).  A custom step's comes from its
        ``step_fallback_fn``, and is None without one."""
        if self._step_fallback is None:
            if self._custom_step:
                if self._step_fallback_builder is not None:
                    self._step_fallback = self._step_fallback_builder()
            else:
                caps = {k: 4 * v
                        for k, v in resolved_caps(self.config).items()}
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


# the state fields a step carries forward (masses never change)
_CARRIED = ("positions", "velocities", "time", "step", "overflow")


class StepGraph:
    """One step of ``step_fn`` captured as a CUDA graph over static state
    buffers; each replay runs the step's kernels in the eager step's order
    and copies its outputs back into the buffers.  A device-side counter
    k, which the graph advances, picks the row each replay writes: the
    step's overflow count into ``overflow[k]`` and, with ``trajectory``,
    its positions into ``trajectory[k + 1]`` (row 0 holds the initial
    positions).  The step's gates are conditional nodes
    (``ops/_graph.device_if``).

    Warm-up before the capture, so that the capture meets no first use:
    one eager step on a side stream on a copy of the state (the buffers
    start at ``state``, so ``n`` replays take exactly ``n`` steps; it
    takes one branch of each gate), then a throwaway relaxed capture of
    the step that records every branch straight.  A step that reads the
    host (a sync) cannot be captured: the capture raises.  Spans:
    ``nbody.capture.warm`` (the eager step and its synchronise), then each
    capture's ``nbody.capture.enter`` / ``.trace`` / ``.end``
    (``ops/_graph.capture``).

    Counting (``utils.profiling.count``): each count the step makes
    counts once per replay.  The throwaway capture's counts are dropped;
    the real capture's counts outside the gates' branches
    (``counts.per_replay``) are added by :meth:`replay`; a branch's
    counts count on the device, once per replay that takes it, and
    :meth:`settle` adds them after the replays (one host read)."""

    def __init__(self, step_fn, state: SimState, n_steps: int,
                 trajectory: bool = False):
        dev = state.device
        self.state = SimState(masses=state.masses, **{
            f: getattr(state, f).clone() for f in _CARRIED})
        self.overflow = torch.zeros((n_steps,), dtype=torch.int32,
                                    device=dev)
        self.trajectory = None
        if trajectory:
            self.trajectory = torch.empty(
                (n_steps + 1, *state.positions.shape), dtype=state.dtype,
                device=dev)
            self.trajectory[0] = state.positions
        self._k = torch.zeros((), dtype=torch.int64, device=dev)

        def copy_of_state():
            return SimState(masses=state.masses, **{
                f: getattr(state, f).clone() for f in _CARRIED})

        side = torch.cuda.Stream(dev)
        with span("nbody.capture.warm"):
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                step_fn(copy_of_state())
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
        with _graph.counting(_graph.CaptureCounts(dev, warm=True)):
            _graph.capture(torch.cuda.CUDAGraph(),
                           lambda: step_fn(copy_of_state()), dev,
                           stream=side, capture_error_mode="relaxed")

        def step():
            new = step_fn(self.state)
            for f in _CARRIED:
                getattr(self.state, f).copy_(getattr(new, f))
            row = self._k.reshape(1)
            self.overflow.index_copy_(0, row, new.overflow.reshape(1))
            if trajectory:
                self.trajectory.index_copy_(0, row + 1,
                                            new.positions[None])
            self._k += 1

        self.counts = _graph.CaptureCounts(dev)
        self.graph = torch.cuda.CUDAGraph()
        with _graph.counting(self.counts):
            _graph.capture(self.graph, step, dev)

    def replay(self, n: int) -> None:
        """Run ``n`` more steps (asynchronous, like a launch)."""
        for _ in range(n):
            self.graph.replay()
        self.counts.replayed(n)

    def settle(self) -> dict:
        """Count what the replays so far did inside the gates' branches
        (one host read); returns {branch: replays that took it}."""
        return self.counts.settle()
