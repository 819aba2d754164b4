"""Command-line interface of the port: the ``run``, ``compare``,
``sweep``, ``plot`` and ``bench`` verbs.

The same flags as ``python -m nbody_tpu`` plus ``--device`` (default
``cuda``), less ``sweep --fake-mesh`` (D thread ranks on one card are not
a scaling number; ``bench/sweeps.py``).  ``run --fused`` runs the whole loop
with no per-step host crossing (on the card a CUDA graph of the step;
``models/simulation.py``).  ``run --devices D`` runs a sharded step
(``--mode``, ``parallel/steps.py``) in D processes over
``torch.distributed``: NCCL with rank r on card r for ``--device cuda``,
gloo for ``--device cpu``; rank 0 prints and writes the outputs.  ``run
--profile DIR`` writes a ``torch.profiler`` trace of the run, the
program's spans in it, to DIR (``utils/profiling.py``; each rank its own
file).  The printed timing lines are the reference's stdout contract
(project.cu:1097/1102, parsed by plot_first_scale.py:58-59).
"""

from __future__ import annotations

import argparse
import os
import sys


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--n-bodies", type=int, default=1024)
    p.add_argument("--dims", type=int, choices=[2, 3], default=2,
                   help="spatial dimensions (3: octree Barnes-Hut, the "
                        "gather walk below 262,144 bodies and the dense "
                        "window collector from there)")
    p.add_argument("--steps", type=int, default=10,
                   help="N_SIMULATIONS analogue (project.cu:9-11)")
    p.add_argument("--dt", type=float, default=1.0)
    p.add_argument("--g", type=float, default=6.67e-11)
    p.add_argument("--engine",
                   choices=["naive", "allpairs", "barnes_hut",
                            "barnes_hut_adaptive"],
                   default="barnes_hut",
                   help="barnes_hut_adaptive: 3D grouped Barnes-Hut whose "
                        "octree goes as deep as the state needs (one "
                        "device, the per-step loop)")
    p.add_argument("--theta", type=float, default=0.5)
    p.add_argument("--max-depth", type=int, default=None,
                   help="tree depth cap; default 9 in 2D (reference "
                        "QUADTREE_MAX_DEPTH, project.cu:61), density-derived "
                        "in 3D (4-7)")
    p.add_argument("--softening", type=float, default=1e-15,
                   help="distance softening (project.cu:634; naive uses 0)")
    p.add_argument("--bh-mode", choices=["grouped", "exact"],
                   default="grouped",
                   help="2D barnes_hut: grouped (Morton groups, the "
                        "kernels) or exact (the per-body frontier "
                        "traversal the f64 oracle checks; eager torch)")
    p.add_argument("--group-size", type=int, default=None,
                   help="Morton group size (default 2048; 3D: 4096 in "
                        "[256K, 768K))")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", choices=["float32", "float64", "bfloat16"],
                   default="float32")
    p.add_argument("--compensated", action="store_true",
                   help="Kahan-compensated accumulation: in the all-pairs "
                        "kernel (K1), and for barnes_hut in the grid list "
                        "evaluator (K6, which it forces)")
    p.add_argument("--target-block", type=int, default=None,
                   help="all-pairs targets a block holds: 512, 256, 128 or "
                        "64 (1, 2, 4 or 8 threads a target; default: "
                        "utils.occupancy); never moves bits")
    p.add_argument("--source-block", type=int, default=None,
                   help="all-pairs sources of one tile, whose partial sum "
                        "enters the total whole (default: utils.occupancy)")
    p.add_argument("--verbose-occupancy", action="store_true",
                   help="print the all-pairs launch shape decision")
    p.add_argument("--frontier-cap", type=int, default=None,
                   help="BH traversal capacity (default: per-level "
                        "schedule from measured demand)")
    p.add_argument("--eval-mode", choices=["grid", "dynamic", "runs"],
                   default=None,
                   help="grouped-BH list evaluator: runs (default; K2/K3, "
                        "K4 when split), grid (padded lists, K6) or dynamic "
                        "(padded lists, occupied tiles only, K7)")
    p.add_argument("--eval-k-tile", type=int, default=None,
                   help="list-evaluator k-tile width (runs: default 256 "
                        "in 2D, 512 in 3D; dynamic: default 2048; grid "
                        "always takes 2048)")
    p.add_argument("--run-cap", type=int, default=None,
                   help="merged Morton runs per group (default 256 in "
                        "2D, N-derived in 3D)")
    p.add_argument("--split-eval", choices=["auto", "on", "off"],
                   default="auto",
                   help="quarter-split runs evaluation (kernel K4; auto: on "
                        "at direct_cell_max >= 128 and N >= 786,432)")
    p.add_argument("--collect3", choices=["auto", "gather", "dense"],
                   default=None,
                   help="3D list collection: gather (the frontier walk), "
                        "dense (the window collector) or auto (dense at "
                        "N >= 262,144)")
    p.add_argument("--no-adaptive-caps", action="store_true",
                   help="disable the 4x-caps retry of an overflowed step")
    p.add_argument("--init-mode", choices=["uniform", "blobs", "plummer"],
                   default="uniform",
                   help="random init distribution: uniform (reference), "
                        "blobs (two dense clusters) or plummer (3D: the "
                        "Plummer sphere in Henon units, G = M = 1)")
    p.add_argument("--load-init", metavar="DIR", default=None,
                   help="load masses/positions/velocities_init.txt from DIR")
    p.add_argument("--save-init", action="store_true",
                   help="save the init triplet to the output dir")
    p.add_argument("--save-positions", action="store_true",
                   help="write per-step positions.txt (plot_2d.py input)")
    p.add_argument("--save-tree-dumps", action="store_true",
                   help="quadtree_init.txt / quadtree_final.txt at the "
                        "first and last steps (2D; plot_quadtree.py input)")
    p.add_argument("--output-dir", default=".")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="write OUTPUT_DIR/checkpoint.npz every K steps "
                        "(0: never)")
    p.add_argument("--metrics-csv", default=None, metavar="FILE",
                   help="per-step energies, momentum and tree statistics "
                        "to OUTPUT_DIR/FILE (step 0 included; the potential "
                        "runs on kernel K5 above 4,096 bodies)")
    p.add_argument("--no-metrics-tree", action="store_true",
                   help="skip the per-step tree statistics in the metrics "
                        "CSV (one tree build per recorded step)")
    p.add_argument("--check-overflow", action="store_true",
                   help="barnes_hut: one diagnostic force pass before the "
                        "run, warning if any traversal/list cap overflowed")
    p.add_argument("--fused", action="store_true",
                   help="whole loop with no per-step host sync: a CUDA "
                        "graph of the step on the card; no adaptive-caps "
                        "retry")
    p.add_argument("--resume", metavar="NPZ", default=None,
                   help="resume from a checkpoint file (takes precedence "
                        "over --load-init)")
    p.add_argument("--devices", type=int, default=1,
                   help="number of devices: one process a device over "
                        "torch.distributed (NCCL on the cards, gloo on "
                        "--device cpu)")
    p.add_argument(
        "--mode",
        choices=["auto", "dp_allpairs", "ring_allpairs", "dp_barnes_hut",
                 "dp_barnes_hut_grouped", "dp_barnes_hut_sharded",
                 "dp_barnes_hut_grouped3", "dp_barnes_hut_sharded3",
                 "dp2d_allpairs"],
        default="auto", help="sharded step selection (--devices > 1)")
    p.add_argument("--hbm-gb", type=float, default=None,
                   help="per-device memory for the sharded-mode gate")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain twins)")


# The Simulation of the last ``run`` in this process (its final state and
# overflow count), for callers that run main() in-process (chip_smoke.py).
last_simulation = None

def _build_config(args):
    from .config import MeshConfig, SimConfig

    return SimConfig(
        n_bodies=args.n_bodies,
        n_dim=args.dims,
        n_steps=args.steps,
        dt=args.dt,
        g=args.g,
        engine=args.engine,
        theta=args.theta,
        max_depth=args.max_depth,
        softening=args.softening,
        bh_mode=args.bh_mode,
        group_size=args.group_size,
        seed=args.seed,
        init_mode=args.init_mode,
        dtype=args.precision,
        compensated=args.compensated,
        target_block=args.target_block,
        source_block=args.source_block,
        verbose_occupancy=args.verbose_occupancy,
        frontier_cap=args.frontier_cap,
        eval_mode=args.eval_mode,
        eval_k_tile=args.eval_k_tile,
        run_cap=args.run_cap,
        split_eval={"auto": None, "on": True, "off": False}[args.split_eval],
        collect3=args.collect3,
        adaptive_caps=not args.no_adaptive_caps,
        save_positions=args.save_positions,
        save_tree_dumps=args.save_tree_dumps,
        output_dir=args.output_dir,
        checkpoint_every=args.checkpoint_every,
        metrics_csv=args.metrics_csv,
        metrics_tree=not args.no_metrics_tree,
        mesh=MeshConfig(dp=args.devices),
        hbm_bytes=int(args.hbm_gb * 1024**3) if args.hbm_gb else None,
    )


def _make_state(args, config, device=None):
    from .rng import random_state
    from .state import make_state

    device = device or args.device
    if args.resume:
        from .utils.checkpoint import load_checkpoint

        return load_checkpoint(args.resume, dtype=config.torch_dtype(),
                               device=device)
    if args.load_init:
        from .utils.textio import load_init_triplet

        m, p, v = load_init_triplet(
            os.path.join(args.load_init, "masses_init.txt"),
            os.path.join(args.load_init, "positions_init.txt"),
            os.path.join(args.load_init, "velocities_init.txt"),
            args.n_bodies,
            n_dim=args.dims,
        )
        return make_state(m, p, v, dtype=config.torch_dtype(),
                          device=device)
    return random_state(config, device=device)


def cmd_run(args) -> int:
    from .models.engines import check_adaptive

    config = _build_config(args)
    try:
        check_adaptive(config, fused=args.fused)
    except ValueError as err:
        print(f"ERROR: {err}", file=sys.stderr)
        return 2
    if args.devices > 1:
        return _run_distributed(args)
    state = _make_state(args, config)

    if args.save_init:
        from .utils.textio import save_init_triplet

        os.makedirs(args.output_dir, exist_ok=True)
        save_init_triplet(
            args.output_dir,
            state.masses.cpu().numpy(),
            state.positions.cpu().numpy(),
            state.velocities.cpu().numpy(),
        )

    from .models.simulation import Simulation

    os.makedirs(args.output_dir, exist_ok=True)
    sim = Simulation(config, state=state)

    if args.check_overflow and args.engine in ("barnes_hut",
                                               "barnes_hut_adaptive"):
        from .models.engines import make_accel_fn

        _, ovf = make_accel_fn(config, return_diagnostics=True)(
            sim.state.positions, sim.state.masses)
        n_ovf = int(ovf.sum())
        if n_ovf:
            print(
                f"WARNING: traversal caps overflowed for {n_ovf} bodies at "
                "step 0; raise --frontier-cap / list/direct caps (forces "
                "for flagged bodies drop interactions)", file=sys.stderr)

    _run_and_report(args, config, sim)
    return 0


def _run_and_report(args, config, sim) -> None:
    import contextlib

    from .utils import profiling

    with (profiling.trace(args.profile) if args.profile
          else contextlib.nullcontext()):
        if args.fused:
            timing = _run_fused(args, config, sim)
        else:
            _, timing = sim.run_contract()
    global last_simulation
    last_simulation = sim
    print()
    # the machine-readable contract lines (project.cu:1097/1102)
    print(timing.total_line())
    print()
    print(timing.parallel_line())


# sharded modes that exist in one dimension only
_MODES_2D = ("dp_barnes_hut", "dp_barnes_hut_grouped", "dp_barnes_hut_sharded")
_MODES_3D = ("dp_barnes_hut_grouped3", "dp_barnes_hut_sharded3")


def _run_distributed(args) -> int:
    """``run --devices D``: resolve the mode (``auto``: the memory gate
    for barnes_hut, dp_allpairs otherwise), refuse a mode of the other
    dimension (2), then run :func:`_run_rank` in one process per device:
    D, or dp x 2 for ``dp2d_allpairs`` (dp = D // 2).  On ``cuda`` each
    rank needs its own card; fewer cards than ranks raise."""
    import torch

    config = _build_config(args)
    mode = args.mode
    if mode == "auto":
        if args.engine == "barnes_hut":
            from .parallel.memory import choose_bh_mode

            dev = torch.device(args.device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", 0)
            mode = choose_bh_mode(config, args.devices, verbose=True,
                                  device=dev)
        else:
            mode = "dp_allpairs"
    if args.dims == 3 and mode in _MODES_2D:
        print(f"ERROR: --mode {mode} is 2D-only; use dp_barnes_hut_grouped3 "
              "(or --mode auto) for 3D", file=sys.stderr)
        return 2
    if args.dims == 2 and mode in _MODES_3D:
        print(f"ERROR: --mode {mode} is 3D-only; use --dims 3, or "
              "dp_barnes_hut_grouped (or --mode auto) for 2D",
              file=sys.stderr)
        return 2
    world = max(args.devices // 2, 1) * 2 if mode == "dp2d_allpairs" else (
        args.devices)
    device_type = torch.device(args.device).type
    if device_type == "cuda":
        visible = torch.cuda.device_count()
        if visible < world:
            raise RuntimeError(
                f"--devices {args.devices} (mode {mode}) runs {world} ranks, "
                f"one a card, but {visible} CUDA device(s) are visible")
        from .ops import _cuda

        _cuda.library()  # built once here, loaded by every rank
    from .parallel.mesh import spawn

    os.makedirs(args.output_dir, exist_ok=True)
    spawn(_run_rank, world, (args, mode), device_type=device_type,
          init_dir=args.output_dir)
    return 0


def _run_rank(rank: int, args, mode: str) -> None:
    """One rank of ``run --devices D`` (in its own process, its process
    group joined): the contract loop or the fused run of
    :func:`rank_simulation`; rank 0 alone prints and writes."""
    import contextlib

    with contextlib.ExitStack() as stack:
        if rank:
            quiet = stack.enter_context(open(os.devnull, "w"))
            stack.enter_context(contextlib.redirect_stdout(quiet))
            stack.enter_context(contextlib.redirect_stderr(quiet))
        config = _build_config(args)
        _run_and_report(args, config,
                        rank_simulation(rank, args, mode, config))


def rank_simulation(rank: int, args, mode: str, config):
    """This rank's Simulation of ``run --devices D``: its slab of the
    state, the sharded step and its 4x-caps retry (rank r on card r)."""
    import torch

    from .models.simulation import Simulation
    from .parallel import make_mesh, make_mesh_2d, make_sharded_step
    from .parallel.mesh import shard_state

    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank)
    state = _make_state(args, config, device)
    if args.save_init and rank == 0:
        from .utils.textio import save_init_triplet

        save_init_triplet(args.output_dir, state.masses.cpu().numpy(),
                          state.positions.cpu().numpy(),
                          state.velocities.cpu().numpy())
    if mode == "dp2d_allpairs":
        mesh = make_mesh_2d(max(args.devices // 2, 1), 2)
    else:
        mesh = make_mesh(args.devices)
    # contiguous slabs of the state as made: no Morton sort first, as
    # the JAX package's CLI (the sharded modes' window then degrades)
    state = shard_state(state, mesh)
    step_fn = make_sharded_step(config, mesh, mode)
    fallback = None
    if "barnes_hut" in mode:
        # the same 4x policy as the single-device loop; the overflow
        # count is psum'd inside the step, so every rank retries alike
        def fallback():
            from .models.engines import resolved_caps

            caps = {k: 4 * v for k, v in resolved_caps(config).items()}
            return make_sharded_step(config.replace(**caps), mesh, mode)

    return Simulation(config, state=state, step_fn=step_fn,
                      step_fallback_fn=fallback, mesh=mesh)


def _run_fused(args, config, sim):
    """``run --fused`` (the JAX CLI's fused branch): the loop as
    ``Simulation.run_scan``, the trajectory kept on the device and
    written once, per-step side effects that need a host sync warned
    about and dropped.  Both timing lines report the fused run's time,
    synchronised; capture and warm-up stay outside it.  On the card it
    prints to stderr that the step ran as a CUDA graph (under
    ``--devices`` each rank's, its collectives in it; rank 0's line),
    with the replays that took each of its conditional branches."""
    from .utils.timing import RunTiming

    # per-step host side effects that cannot run inside one fused run:
    # warn loudly instead of silently dropping them
    unsupported = []
    if args.checkpoint_every:
        unsupported.append("--checkpoint-every")
    if args.metrics_csv:
        unsupported.append("--metrics-csv")
    if unsupported:
        print(
            f"WARNING: {', '.join(unsupported)} ignored under --fused "
            "(needs per-step host sync); rerun without --fused for "
            "those outputs",
            file=sys.stderr,
        )

    dumps = sim._dumps_enabled()
    if dumps:
        sim._dump_tree(sim.state, first=True)
    t0_time = float(sim.state.time)
    if args.save_positions or dumps:
        # the trajectory is captured on the device ([steps + 1, N, D])
        # and written in one host pass afterwards: savePositions every
        # step (project.cu:909) without per-step crossings
        final, traj = sim.run_scan_trajectory(config.n_steps)
    else:
        final, traj = sim.run_scan(config.n_steps), None
    if sim.last_scan_route == "graph":
        taken = "".join(f"; {name}: {k} of {config.n_steps} replays"
                        for name, k in sim.last_branch_counts.items())
        ranks = "" if sim.mesh is None else (
            f" on each of {sim.mesh.size} ranks (rank 0's counts), its "
            "collectives in it")
        print(f"fused: the step ran as a CUDA graph{ranks}, captured in "
              f"{sim.last_capture_ms:.1f} ms and replayed "
              f"{config.n_steps} times{taken}", file=sys.stderr)
    if traj is not None:
        if args.save_positions and sim.is_root:
            from .utils.textio import PositionsWriter

            traj_np = traj.cpu().numpy()
            writer = PositionsWriter(
                os.path.join(args.output_dir, "positions.txt"))
            for k in range(traj_np.shape[0]):
                writer.append(t0_time + k * config.dt, traj_np[k])
            writer.flush()
        if dumps and config.n_steps > 0:  # every rank: a gather
            # the reference dumps the final tree at the TOP of the last
            # step (project.cu:962-965), i.e. after n-1 updates
            sim._dump_tree(final, first=False,
                           positions=traj[config.n_steps - 1])
    return RunTiming(total_ms=sim.last_scan_ms,
                     parallel_us=sim.last_scan_ms * 1e3)


_COMPARE_ENGINES = (
    "naive", "allpairs", "barnes_hut",
    "native", "native_naive", "oracle", "oracle_naive",
)
_HOST_ENGINES = {"native", "native_naive", "oracle", "oracle_naive"}


def _run_engine_final(name: str, config, state0, device):
    """Run ``n_steps`` of one engine from a fixed initial state; returns
    the final positions [N, D] as numpy (float64 for the host engines,
    the configured dtype for the device engines, which run fused:
    ``Simulation.run_scan``, a CUDA graph of the step on the card)."""
    m, p, v = (t.detach().double().cpu().numpy() for t in (
        state0.masses, state0.positions, state0.velocities))

    if name in ("native", "native_naive"):
        from .utils import native

        pos, _ = native.simulate(
            p, v, m, config.n_steps, config.dt, config.g,
            engine="naive" if name == "native_naive" else "barnes_hut",
            theta=config.theta, max_depth=config.resolved_max_depth,
        )
        return pos
    if name in ("oracle", "oracle_naive"):
        from .models import oracle

        return oracle.simulate(
            p, v, m, config.n_steps, dt=config.dt, g=config.g,
            engine="naive" if name == "oracle_naive" else "barnes_hut",
            theta=config.theta, max_depth=config.resolved_max_depth,
        )[-1]

    from .models.simulation import Simulation
    from .state import make_state

    sim = Simulation(
        config.replace(engine=name, save_positions=False,
                       save_tree_dumps=False, metrics_csv=None,
                       checkpoint_every=0),
        state=make_state(m, p, v, dtype=config.torch_dtype(),
                         device=device),
    )
    sim.run_scan()
    return sim.state.positions.double().cpu().numpy()


def cmd_compare(args) -> int:
    """The reference's verification-by-comparison workflow
    (project.cu:1049-1105): run two engines from ONE initial condition
    and print the checkEqual verdict (project.cu:1027-1047); returns 0
    when the final positions agree within ``--tol``, 1 when not, 2 for a
    host engine in 3D.  Both engines start from identical (masses,
    positions, velocities), unlike the reference's main, which reuses the
    mutated velocity array between its CPU and GPU runs."""
    import time

    config = _build_config(args)
    if args.dims == 3:
        used = {args.engine_a, args.engine_b} & _HOST_ENGINES
        if used:
            print(
                f"ERROR: {', '.join(sorted(used))} are 2D-only host "
                "engines (the reference and its oracle are N_DIM=2); in "
                "3D compare e.g. --engine-a naive --engine-b barnes_hut",
                file=sys.stderr,
            )
            return 2
    state0 = _make_state(args, config)

    from .utils.textio import check_equal

    finals = []
    for name in (args.engine_a, args.engine_b):
        t0 = time.perf_counter()
        finals.append(_run_engine_final(name, config, state0, args.device))
        ms = (time.perf_counter() - t0) * 1e3
        print(f"{name} total computation took {ms:.0f} milliseconds.")

    print()
    equal = check_equal(finals[0], finals[1], "final positions", tol=args.tol)
    print()
    return 0 if equal else 1


def cmd_sweep(args) -> int:
    from .bench import DeviceUnavailable
    from .bench.sweeps import run_sweep

    try:
        return run_sweep(args)
    except DeviceUnavailable as e:
        print(f"sweep: {e}", file=sys.stderr)
        return 1


def cmd_plot(args) -> int:
    from .bench import plots

    if args.positions:
        print(plots.trajectories(args.positions, args.out))
    if args.positions_3d:
        print(plots.trajectories_3d(args.positions_3d, args.out))
    if args.quadtree:
        print(plots.quadtree(args.quadtree, args.out))
    if args.analysis:
        for png in plots.scaling_analysis(args.analysis, args.out,
                                          metric=args.metric):
            print(png)
    if not (args.positions or args.quadtree or args.positions_3d
            or args.analysis):
        print("nothing to plot: pass --positions, --positions-3d, "
              "--quadtree and/or --analysis")
        return 2
    return 0


def cmd_bench(args) -> int:
    """The headline benchmark line (``bench/headline.py``)."""
    from .bench.headline import main as bench_main

    return bench_main(args.device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="nbody_tpu_torch",
        description="gravitational N-body framework, PyTorch/CUDA port",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p_run = sub.add_parser("run", help="run one simulation")
    _add_common(p_run)
    p_run.add_argument(
        "--profile", metavar="DIR", default=None,
        help="write a torch.profiler trace of the run (host operators, the "
             "card's kernels, the program's nbody.* spans) to DIR, for "
             "TensorBoard or Perfetto")
    p_run.set_defaults(fn=cmd_run)

    p_compare = sub.add_parser(
        "compare",
        help="run two engines from one init and print the checkEqual "
        "verdict (project.cu:1027-1047 workflow)",
    )
    _add_common(p_compare)
    p_compare.add_argument(
        "--engine-a", choices=_COMPARE_ENGINES, default="native",
        help="first engine (native/oracle run the f64 host reference)",
    )
    p_compare.add_argument(
        "--engine-b", choices=_COMPARE_ENGINES, default="barnes_hut",
        help="second engine",
    )
    p_compare.add_argument(
        "--tol", type=float, default=1e-10,
        help="element tolerance (reference checkEqual uses 1e-10 for its "
        "f64-vs-f64 runs; f32 device engines vs the f64 host engines need "
        "a looser budget, e.g. 1e-5)",
    )
    p_compare.set_defaults(fn=cmd_compare)

    p_sweep = sub.add_parser(
        "sweep", help="strong/weak scaling experiment sweeps")
    _add_common(p_sweep)
    p_sweep.add_argument(
        "--experiment", choices=["strong", "weak", "bodies"],
        default="strong",
        help="strong: fixed N, vary devices (first_scaling_script.sh "
        "analogue); weak: N per device fixed, vary devices; bodies: vary N "
        "on fixed devices (second_scaling_script.sh analogue)")
    p_sweep.add_argument("--repeats", type=int, default=5,
                         help="repetitions per config (scripts use 5)")
    p_sweep.add_argument("--device-counts", type=str, default="",
                         help="comma list, e.g. 1,2,4,8; counts above the "
                              "visible cards are dropped with a warning")
    p_sweep.add_argument("--body-counts", type=str, default="",
                         help="comma list for --experiment bodies")
    p_sweep.add_argument("--results-file", default="scaling_results.txt")
    p_sweep.add_argument(
        "--sweep-axis", choices=["devices", "group-chunk", "tiles"],
        default="devices",
        help="processor axis: devices, one process a device (default), or "
        "tiles: K1's target block on ONE device, the single-card analogue "
        "of the reference's N_THREADS axis (project.cu:983); group-chunk "
        "sizes an evaluator the port does not have and exits 2")
    p_sweep.add_argument("--axis-values", type=str, default="",
                         help="comma list for --sweep-axis tiles (default "
                              "64,128,256,512)")
    p_sweep.set_defaults(fn=cmd_sweep)

    p_bench = sub.add_parser("bench", help="headline benchmark JSON line")
    p_bench.add_argument("--device", default="cuda",
                         help="torch device: cuda (the kernels) or cpu "
                              "(their plain twins, N=2,048)")
    p_bench.set_defaults(fn=cmd_bench)

    p_plot = sub.add_parser(
        "plot", help="vectorised analysis plots (large-N capable; needs "
                     "matplotlib)")
    p_plot.add_argument("--positions", default=None, metavar="FILE")
    p_plot.add_argument("--positions-3d", default=None, metavar="FILE",
                        help="five-column 3D positions.txt (functional "
                        "replacement for the reference's broken "
                        "plot_3d.py)")
    p_plot.add_argument("--quadtree", default=None, metavar="FILE")
    p_plot.add_argument("--analysis", default=None, metavar="FILE",
                        help="sweep results file: the reference's "
                        "mean-runtime / speedup / efficiency analyses "
                        "(plot_first_scale.py:105-154) or the runtime-"
                        "vs-N errorbar plot for weak/bodies sweeps "
                        "(plot_second_scale.py:58-88)")
    p_plot.add_argument("--metric", choices=["parallel", "total"],
                        default="parallel",
                        help="which timing line the analysis uses")
    p_plot.add_argument("--out", default=None)
    p_plot.set_defaults(fn=cmd_plot)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
