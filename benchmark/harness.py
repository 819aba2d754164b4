"""One run of one cell: set-up, the measured window, the check.

The unit of work is what a user launches: a new ``Simulation`` of the
program on a fresh state made from (seed, run index), stepped
``steps_per_run`` steps through the traffic's entry (``run_scan``: the
fused run, CUDA graph capture included; ``run_contract``: the per-step
loop with its 4x-cap retries).  The window repeats runs back to back
until ``--seconds`` have passed and ends on a run boundary; each run is
timed by the host clock around the call, ending in a device
synchronise, and making its state stays outside the clock.  The
program's ``SimConfig`` comes from the configuration: its sizes and
constants, and any other field in its ``program`` object.  On a mesh
(the configuration's ``devices`` > 1) every rank does the same on its
own card, rank 0 deciding after each run whether another follows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import os
import re
import time
from typing import List, Optional

import torch

from . import cells, check, states, trace as tracing

# run indices of the warm-up runs (no window run takes them)
WARM_BASE = 1 << 30


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def loop_counts(stderr: str) -> dict:
    """Retried and failed steps of one contract loop, from the lines it
    prints: one per retried step, one per overflowed step (the first
    three) and a total when more overflowed."""
    retried = stderr.count("retrying with 4x caps")
    total = re.search(r"overflowed on (\d+) of \d+ steps", stderr)
    failed = int(total.group(1)) if total else len(
        re.findall(r"WARNING: step \d+: traversal caps overflowed", stderr))
    return dict(retried=retried, failed=failed, capture_ms=0.0, scan_ms=0.0)


# SimConfig fields the harness sets from the configuration's top level
# and the traffic, which its ``program`` settings may not restate
SET_ELSEWHERE = ("n_bodies", "n_dim", "engine", "dtype", "n_steps", "theta",
                 "dt", "g", "softening")


def program_settings(config: dict) -> dict:
    """The configuration's ``program`` object: ``SimConfig`` field names
    and scalar values, applied over what the harness sets.  A name that
    ``SimConfig`` lacks (a program without the field the configuration
    needs), a nested field or a field set elsewhere stops set-up with an
    error that names it."""
    from nbody_tpu_torch.config import SimConfig

    settings = config.get("program", {})
    defaults = SimConfig()
    fields = {f.name for f in dataclasses.fields(SimConfig)}
    for name, value in settings.items():
        if name not in fields:
            raise ValueError(f"program setting {name!r}: SimConfig has no "
                             "such field")
        if dataclasses.is_dataclass(getattr(defaults, name)):
            raise ValueError(f"program setting {name!r}: a nested field, "
                             "which a configuration may not set")
        if name in SET_ELSEWHERE:
            raise ValueError(f"program setting {name!r}: set by the "
                             "configuration's top level or the traffic")
        if not (value is None or isinstance(value, (bool, int, float,
                                                    str))):
            raise ValueError(f"program setting {name!r}: {value!r} is not "
                             "a scalar")
    return settings


class Program:
    """The system under test as one rank of the cell runs it: the
    program's configuration, its state and its ``Simulation``."""

    def __init__(self, cell: cells.Cell, device: torch.device, mesh=None):
        from nbody_tpu_torch.config import MeshConfig, SimConfig

        c = cell.config
        self.cell = cell
        self.device = device
        self.mesh = mesh
        self.entry = cell.traffic["entry"]
        self.steps = int(cell.traffic["steps_per_run"])
        opts = {k: float(c[k]) for k in ("theta", "dt", "g", "softening")
                if k in c}
        self.sim_config = SimConfig(
            n_bodies=int(c["n_bodies"]), n_dim=int(c["n_dim"]),
            engine=c["engine"], dtype=c["dtype"], n_steps=self.steps,
            mesh=MeshConfig(dp=cell.devices), **opts).replace(
                **program_settings(c))
        scale = cell.traffic.get("cap_scale", {})
        if scale:  # {cap: factor} over the program's resolved caps
            from nbody_tpu_torch.models.engines import resolved_caps

            caps = resolved_caps(self.sim_config)
            self.sim_config = self.sim_config.replace(
                **{k: int(f) * caps[k] for k, f in scale.items()})
        self.step_fn = None
        if mesh is not None:
            from nbody_tpu_torch.parallel import make_sharded_step

            self.step_fn = make_sharded_step(self.sim_config, mesh,
                                             c["mode"])

    def state(self, bodies):
        from nbody_tpu_torch.state import make_state

        state = make_state(*bodies, dtype=self.sim_config.torch_dtype(),
                           device=self.device)
        if self.mesh is not None:
            from nbody_tpu_torch.parallel.mesh import shard_state

            state = shard_state(state, self.mesh)
        return state

    def run(self, state, steps: int):
        """One run of ``steps`` steps from ``state`` through the entry:
        (final state, {capture_ms, retried, failed})."""
        from nbody_tpu_torch.models.simulation import Simulation

        sim = Simulation(self.sim_config.replace(n_steps=steps),
                         state=state, step_fn=self.step_fn, mesh=self.mesh)
        if self.entry == "run_scan":
            final = sim.run_scan(steps)
            return final, dict(capture_ms=sim.last_capture_ms,
                               scan_ms=sim.last_scan_ms, retried=0,
                               failed=int((sim.last_scan_overflow != 0)
                                          .sum()))
        if self.entry != "run_contract":
            raise ValueError(f"unknown entry {self.entry!r}")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            final, _ = sim.run_contract()
        return final, loop_counts(err.getvalue())

    def slab(self):
        """(first, one past last) body index this rank holds."""
        n = int(self.cell.config["n_bodies"])
        if self.mesh is None:
            return 0, n
        ax = next(iter(self.mesh.axes.values()))
        s = n // ax.size
        return ax.axis_index() * s, (ax.axis_index() + 1) * s

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's slab of ``t``, in rank order (the benchmark's own
        collective; ``t`` itself on one device)."""
        if self.mesh is None:
            return t
        import torch.distributed as dist

        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    def agree(self, go: bool) -> bool:
        """Rank 0's decision, on every rank."""
        if self.mesh is None:
            return go
        import torch.distributed as dist

        flag = torch.tensor([int(go)], dtype=torch.int32, device=self.device)
        dist.broadcast(flag, 0)
        return bool(flag.item())


@dataclasses.dataclass
class Readings:
    """What the per-layer metrics' readers read: the window's counts and
    spans, and the traced runs' device trace (None without one)."""

    config: dict
    runs: int
    steps: int
    retried_steps: int
    capture_ms: List[float]
    trace: Optional[tracing.Trace] = None
    traced_steps: int = 0
    hand_kernels: frozenset = frozenset()
    sm_clock_hz: float = 0.0


def run_rank(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, mesh=None) -> dict:
    """Set-up, window and check of one rank; its part of the result."""
    program = Program(cell, device, mesh)
    if device.type == "cuda":
        from nbody_tpu_torch.ops import _cuda

        _cuda.library()  # built at a checkout's first run, loaded after
    cfg = cell.config
    for w in range(int(cfg.get("warm_runs", 1))):
        program.run(program.state(states.make_bodies(
            cfg, seed, WARM_BASE + w, device, cell.root)), program.steps)
    sync(device)

    trace_runs = int(cell.traffic.get("trace_runs", 1)) if trace else 0
    # the traced runs' states are made, and the profiler started, first
    queued = [program.state(states.make_bodies(cfg, seed, j, device,
                                               cell.root))
              for j in range(trace_runs)]
    sync(device)
    prof = None
    if trace:
        prof = tracing.Profiler()
        prof.start()
    window_epoch = time.time()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    finals, capture, scan, run_ms = [], [], [], []
    run_s = 0.0
    steps = retried = failed = 0
    parsed = None
    go = True
    while go:
        idx = len(finals)
        state = queued.pop(0) if queued else program.state(
            states.make_bodies(cfg, seed, idx, device, cell.root))
        sync(device)
        t = time.perf_counter()
        with torch.profiler.record_function("benchmark.run"):
            final, info = program.run(state, program.steps)
            sync(device)
        run_ms.append((time.perf_counter() - t) * 1e3)
        run_s += run_ms[-1] * 1e-3
        if prof is not None and idx + 1 == trace_runs:
            parsed = prof.stop()
            prof = None
        finals.append((final.positions.clone(), final.velocities.clone()))
        del final, state
        if prof is None:
            # what a run left for the collector goes outside the clock
            # (a user's process ends after its run)
            gc.collect()
        steps += program.steps
        retried += info["retried"]
        failed += info["failed"]
        capture.append(info["capture_ms"])
        scan.append(info["scan_ms"])
        # every rank profiles the same runs: no broadcast (whose NCCL
        # kernel would join the trace) until the traced runs are done
        go = prof is not None or program.agree(
            time.perf_counter() - t0 < seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    t = time.perf_counter()
    numbers = check.check(program, seed, finals)
    check_s = time.perf_counter() - t
    out = dict(window_epoch=window_epoch, setup_s=setup_s, run_s=run_s,
               check_s=check_s, runs=len(finals), steps=steps, failed=failed,
               memory_peak_bytes=int(peak), run_ms=run_ms,
               capture_ms=capture, scan_ms=scan,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               check=dataclasses.asdict(numbers))
    if trace:
        from . import roofline

        readings = Readings(
            config=cfg, runs=len(finals), steps=steps,
            retried_steps=retried, capture_ms=capture, trace=parsed,
            traced_steps=trace_runs * program.steps,
            hand_kernels=tracing.hand_kernel_names(),
            sm_clock_hz=(roofline.max_sm_clock_hz()
                         if device.type == "cuda" else 0.0))
        out["per_layer"] = cells.read_metrics(cell, readings)
        out["busy_s"] = parsed.busy_s
        out["window_s"] = parsed.window_s
        out["breakdown"] = {"device_ops": parsed.top_device_ops(),
                            "idle_gaps": parsed.top_idle_gaps()}
    return out


def rank_entry(rank: int, cell: cells.Cell, seed: int, seconds: float,
               trace: bool, t_start_epoch: float, out_dir: str,
               device_type: str) -> None:
    """One rank of a mesh cell, in its own process (``parallel.mesh.spawn``
    has joined it to the process group): writes its part of the result
    to ``out_dir/rank<r>.json``."""
    import json

    from nbody_tpu_torch.parallel import make_mesh

    device = (torch.device("cuda", rank) if device_type == "cuda"
              else torch.device("cpu"))
    torch.set_num_threads(1)
    mesh = make_mesh(cell.devices)
    t_start = time.perf_counter() - (time.time() - t_start_epoch)
    part = run_rank(cell, seed, seconds, trace, device, t_start, mesh)
    part["modules"] = forbidden_modules()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(part, f)


FORBIDDEN = ("jax", "jaxlib", "flax", "nbody_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark must not
    load (compared whole: ``nbody_tpu_torch`` is not ``nbody_tpu``)."""
    import sys

    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
