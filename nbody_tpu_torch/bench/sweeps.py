"""Scaling-experiment sweeps (the reference's L7 layer; counterpart of
``nbody_tpu.bench.sweeps``).

The reference's two protocols and the single-device body axis:

* strong — fixed N, vary the device count (first_scaling_script.sh:
  40,000 bodies, threads 1..40,000, 5 repeats, 10 steps);
* weak — N per device fixed (second_scaling_script.sh: bodies = threads);
* bodies — vary N on a fixed device count;
* ``--sweep-axis tiles`` — the processor axis as a launch granularity on
  ONE device: K1's ``target_block`` (512 / 256 / 128 / 64 targets a
  block, i.e. 1 / 2 / 4 / 8 threads a target), the single-card analogue
  of the reference's N_THREADS axis (its grid is sized from N_THREADS,
  project.cu:983).

The results file is the scripts' format, read by plot_first_scale.py /
plot_second_scale.py and by :func:`plots.scaling_analysis`: a header,
then per run a ``n_bodies, n_threads, n_simulations[, repetition],
<program stdout>`` block carrying the two timing lines verbatim
(first_scaling_script.sh:14-15,36; second_scaling_script.sh:13,39), and a
trailing ``# backend: ...`` label line that the reference parsers skip.

A point on one device runs through :class:`Simulation` in this process.
A point on D > 1 devices runs the ranks of ``run --devices D``
(``cli.rank_simulation``) in D processes of their own (NCCL, one card a
rank; gloo processes on ``--device cpu``), and rank 0 hands its timing
lines back through a file: the ranks print from processes of their own.
Every point, on one device or on D, is timed by :func:`timed_contract`:
one untimed step first, then the contract loop.  A process's first step
pays for loading the kernels, NCCL's communicators and the allocator's
pools (about 1.2 s on an H100), which would otherwise land on every
D > 1 point and on the first repeat of the D = 1 points alone.  The
BASELINE configs 4-5 time their points with the same code.  Device
counts above the visible cards are dropped with a warning naming them,
and the label names them too (the JAX package's ``--fake-mesh never``).
Threads never stand in for cards here: D thread ranks on one card are
not a scaling number.

Port-only divergence: ``--sweep-axis group-chunk`` sizes the JAX
package's chunked XLA evaluator, which is not ported (ROADMAP "Not to
port"); nothing in the port reads ``SimConfig.group_chunk``, so that axis
exits 2 and says so rather than sweep a knob that changes nothing.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
from contextlib import redirect_stderr, redirect_stdout
from typing import List

AXIS_DEFAULTS = {"tiles": "64,128,256,512"}

GROUP_CHUNK_UNPORTED = (
    "--sweep-axis group-chunk sizes the JAX package's chunked XLA "
    "evaluator (nbody_tpu/ops/bh_grouped.py _evaluate), which the port "
    "does not have; no port code reads SimConfig.group_chunk, so there is "
    "nothing to sweep. Use --sweep-axis tiles (--engine allpairs) or "
    "devices.")

# ``run`` flags that write files or resume: a sweep point turns them off
_FILE_FLAGS = {"save_positions": False, "save_tree_dumps": False,
               "save_init": False, "metrics_csv": None,
               "checkpoint_every": 0, "resume": None}


def timed_contract(sim):
    """One untimed step of ``sim``, then its contract loop from there;
    returns (RunTiming, what the loop wrote to stderr).  The step pays
    for what a process's first step loads, so the loop is timed warm."""
    err = io.StringIO()
    with redirect_stderr(err):
        sim.state = sim.step_fn(sim.state)
        _, timing = sim.run_contract()
    return timing, err.getvalue()


def _block(timing) -> str:
    """The timing lines as ``run`` prints them: a results-file block."""
    return f"\n{timing.total_line()}\n\n{timing.parallel_line()}\n"


def _point_rank(rank: int, args, mode: str, out_file: str) -> None:
    """One rank of a D-device point (in its own process, its process
    group joined); rank 0 writes its block, seconds a step and retried
    steps to ``out_file``."""
    from ..cli import _build_config, rank_simulation

    with redirect_stdout(io.StringIO()):
        sim = rank_simulation(rank, args, mode, _build_config(args))
        timing, err = timed_contract(sim)
    if rank == 0:
        with open(out_file, "w") as f:
            json.dump({"block": _block(timing),
                       "step_seconds": timing.parallel_us / 1e6 / args.steps,
                       "retried_steps": err.count("retrying with 4x caps")},
                      f)


def run_point(args, mode: str) -> dict:
    """One point on ``args.devices`` processes running ``mode`` (NCCL,
    rank r on card r; gloo on the CPU): rank 0's {block, step_seconds,
    retried_steps}."""
    import torch

    from ..parallel.mesh import spawn

    device_type = torch.device(args.device).type
    if device_type == "cuda":
        from ..ops import _cuda

        _cuda.library()  # built once here, loaded by every rank
    with tempfile.TemporaryDirectory() as tmp:
        out_file = os.path.join(tmp, "point.json")
        spawn(_point_rank, args.devices, (args, mode, out_file),
              device_type=device_type, init_dir=tmp)
        with open(out_file) as f:
            return json.load(f)


def _point_args(args, n_bodies: int, n_devices: int, seed: int):
    """The ``run`` flags of one point: ``args`` with its size, device
    count and seed, and no file outputs."""
    point = {**vars(args), **_FILE_FLAGS, "n_bodies": n_bodies,
             "devices": n_devices, "seed": seed}
    point.pop("fn", None)
    return argparse.Namespace(**point)


def _mode(args) -> str:
    """The sharded mode of a D > 1 point."""
    if args.engine == "barnes_hut":
        return ("dp_barnes_hut_grouped3" if args.dims == 3
                else "dp_barnes_hut_grouped")
    return "dp_allpairs"


def _run_single(args, device, n_bodies: int, seed: int, **over) -> str:
    """One point on one device in this process; returns its block."""
    from ..cli import _build_config
    from ..models.simulation import Simulation
    from ..rng import random_state

    cfg = _build_config(_point_args(args, n_bodies, 1, seed)).replace(**over)
    timing, err = timed_contract(
        Simulation(cfg, state=random_state(cfg, device=device)))
    sys.stderr.write(err)
    return _block(timing)


def _visible_devices(device) -> int:
    """Devices a point may use: the cards torch sees, or on the CPU one
    gloo process a core."""
    import torch

    if device.type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def _write_results(path, lines, backend_label) -> None:
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        f.write(f"# backend: {backend_label}\n")
    print(f"results written to {path}", file=sys.stderr)


def _run_intra_chip_sweep(args, device, axis: str) -> int:
    """The ``tiles`` axis on ONE device: its value plays the reference's
    N_THREADS role in the results file."""
    if args.engine != "allpairs":
        raise SystemExit("--sweep-axis tiles varies the all-pairs target "
                         "block; use --engine allpairs")
    values = [int(x) for x in
              (args.axis_values or AXIS_DEFAULTS[axis]).split(",")]
    lines: List[str] = ["n_bodies, n_threads, n_simulations, runtime"]
    for v in values:
        for rep in range(1, args.repeats + 1):
            lines.append(f"{args.n_bodies}, {v}, {args.steps}, "
                         + _run_single(args, device, args.n_bodies,
                                       args.seed + rep, target_block=v))
            print(f"{axis}: value={v} rep={rep} done", file=sys.stderr)
    _write_results(args.results_file, lines,
                   f"{device.type} single-device, axis={axis}")
    return 0


def run_sweep(args) -> int:
    from . import measurement_device

    axis = args.sweep_axis
    if axis == "group-chunk":
        print(f"ERROR: {GROUP_CHUNK_UNPORTED}", file=sys.stderr)
        return 2
    device = measurement_device(args.device)
    if axis != "devices":
        return _run_intra_chip_sweep(args, device, axis)

    device_counts = ([int(x) for x in args.device_counts.split(",")]
                     if args.device_counts else [1, 2, 4, 8])
    if args.body_counts:
        body_counts = [int(x) for x in args.body_counts.split(",")]
    else:  # second_scaling_script.sh:4 body axis
        body_counts = [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                       4096, 8192, 16384, 32768, 40000]

    visible = _visible_devices(device)
    wanted = (device_counts if args.experiment in ("strong", "weak")
              else [args.devices])
    dropped = [d for d in wanted if d > visible]
    if dropped:
        print(f"WARNING: requested device counts {dropped} exceed the "
              f"{visible} visible device(s); not run", file=sys.stderr)
        if args.experiment == "bodies":
            return 2
        device_counts = [d for d in device_counts if d <= visible]

    header = ("n_bodies, n_threads, n_simulations, repetition, runtime"
              if args.experiment in ("weak", "bodies")
              else "n_bodies, n_threads, n_simulations, runtime")
    lines: List[str] = [header]

    def one_point(n_bodies, n_devices, rep):
        seed = args.seed + rep
        if n_devices > 1:
            return run_point(_point_args(args, n_bodies, n_devices, seed),
                             _mode(args))["block"]
        return _run_single(args, device, n_bodies, seed)

    if args.experiment == "strong":
        for n_dev in device_counts:
            for rep in range(1, args.repeats + 1):
                lines.append(f"{args.n_bodies}, {n_dev}, {args.steps}, "
                             + one_point(args.n_bodies, n_dev, rep))
                print(f"strong: devices={n_dev} rep={rep} done",
                      file=sys.stderr)
    elif args.experiment == "weak":
        for n_dev in device_counts:
            n_bodies = args.n_bodies * n_dev
            for rep in range(1, args.repeats + 1):
                lines.append(f"{n_bodies}, {n_dev}, {args.steps}, {rep}, "
                             + one_point(n_bodies, n_dev, rep))
                print(f"weak: devices={n_dev} N={n_bodies} rep={rep} done",
                      file=sys.stderr)
    else:  # bodies
        for n_bodies in body_counts:
            for rep in range(1, args.repeats + 1):
                lines.append(f"{n_bodies}, {args.devices}, {args.steps}, "
                             f"{rep}, "
                             + one_point(n_bodies, args.devices, rep))
                print(f"bodies: N={n_bodies} rep={rep} done",
                      file=sys.stderr)

    label = (f"cuda-{visible}-card(s), one NCCL process a card above 1 "
             "device" if device.type == "cuda" else
             f"cpu, gloo processes above 1 device ({visible} cores)")
    if dropped:
        label += f" (device counts {dropped} not run: {visible} visible)"
    _write_results(args.results_file, lines, label)
    return 0
