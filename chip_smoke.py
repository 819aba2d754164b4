#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (nbody_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing what it found; the first failure exits non-zero:

0. the card: ``nvidia-smi`` name and power limit, torch's device name;
1. build the CUDA kernels from nbody_tpu_torch/csrc (one nvcc per
   source, started together, sm_90a);
2. kernel K1 (all-pairs) against its plain PyTorch twin on the card;
   2b. K1's 3D instantiation, at N=65,536 and a ragged N;
3. kernel K2 (grouped Barnes-Hut runs evaluation) against its twin on
   the tables of a real 2D grouped-BH state;
   3b. K2 (3D) and K3 (segment-packed) against their twins, and K3
   against K2, on the packed and plain tables of one 3D grouped-BH state
   at N=131,072 (both built from the same merged runs);
   3c. K4 (quarter-split evaluation) against its twin on the tables of
   a real 3D state at N=1,048,576 (the default route: dense collector,
   split on), and K4's 2D instantiation on a 2D state with
   ``split_eval=True``;
4. the 2D main path: ``nbody_tpu_torch.cli.main(["run", ...])`` for
   barnes_hut at N=40,960 and allpairs at N=65,536, 10 steps each;
   4b. the 3D main path below the dense band: ``run --dims 3`` for
   barnes_hut at N=131,072, at the smallest N of [131,072, 262,144) whose
   initial state the run-length gate sends to K3, and at N=65,536 (below
   the packing N gate: K2), and allpairs at N=65,536 (K1), 10 steps each;
   4c. the 3D default route at scale: ``run --dims 3`` barnes_hut at
   N=262,144 (dense collector, K2 or K3) and N=1,048,576 (dense
   collector, K4), printing escaped groups, retried steps and peak
   device memory.
   Every run has the kernels' launch counters reset just before it and
   read just after; each run is then replayed in lockstep against the
   plain twins;
5. times on the card (CUDA events, after a warm-up), kernel beside twin;
   5b. the same for the 3D kernels and the 3D grouped-BH step;
   5c. K4 beside its twin and K2, the 3D step at both sizes, the gates'
   A/Bs (dense vs gather collector, split on vs off) and a
   ``torch.profiler`` split of the 1,048,576-body step.

The line before the last is the kernel summary JSON, the last line
``{"ok": true, "device": {...}}``.  There is no CPU path: without CUDA,
or outside a checkout that holds nbody_tpu_torch, it exits 1 and prints
no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
import time

G = 6.67e-11
# Kernel vs twin, and the whole grouped-BH path: |kernel - twin| at most
# 1e-5 of the largest |a| — the bound the JAX package holds its runs
# evaluator to against its XLA route (tests/test_list_eval.py:131).  Both
# sides are f32 and differ only in summation order.
KERNEL_TOL = 1e-5
# Main-path runs, kernels vs twins, in lockstep: the reference's workload
# is chaotic (unsoftened close encounters at dt=1 eject bodies, which
# moves the root bounds and so every Morton group), so two free runs that
# differ in rounding part ways and their final positions say nothing about
# the kernels.  Instead the states of the kernel run go through both
# force passes: the accelerations must agree within KERNEL_TOL x max|a|,
# and the positions after the last compared step within
# KERNEL_TOL x max|a| x dt^2 plus 4 ulp of the largest coordinate (the
# rounding of p + v dt).


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cloud(n: int, seed: int, device, dims: int = 2):
    """Bodies of the reference's distribution (project.cu:30-35)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    lo, hi = math.log10(0.1), math.log10(0.5)
    m = 10 ** (lo + (hi - lo) * torch.rand(n, generator=gen))
    p = -0.1 + 0.2 * torch.rand((n, dims), generator=gen)
    return p.to(device), m.to(device)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got, want) -> float:
    import torch

    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = torch.isfinite(got).all() and err <= KERNEL_TOL * scale
    print(f"  {name}: max|kernel - twin| = {err:.3e}, max|twin| = "
          f"{scale:.3e}, bound {KERNEL_TOL:g} x max|twin| -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its twin")
    return err


@contextlib.contextmanager
def spying(module, name: str, seen: list):
    """Record the (args, kwargs) of every call of ``module.name``."""
    orig = getattr(module, name)

    def spy(*a, **kw):
        seen.append((a, kw))
        return orig(*a, **kw)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, orig)


def capture_tables(positions, masses, gate=None, **kw3):
    """The (args, kwargs) that one grouped-BH force pass hands the runs
    wrapper (K2 or K3), and the mean merged-run length.  ``gate`` forces
    the 3D run-length gate: "packed", "plain" or None (its own choice);
    ``kw3`` goes to the 3D engine."""
    from nbody_tpu_torch.ops import bh3d, bh_grouped, experiments, list_eval

    runs, seen = [], []
    thr = bh_grouped.SEG_PACK_MIN_RUN_LANES
    if gate is not None:
        bh_grouped.SEG_PACK_MIN_RUN_LANES = (
            -1.0 if gate == "packed" else float("inf"))
    try:
        with spying(list_eval, "list_eval_runs", seen), \
                spying(experiments, "merge_ranges", runs):
            if positions.shape[1] == 3:
                bh3d.bh3_accelerations_grouped(positions, masses, g=G,
                                               **kw3)
            else:
                bh_grouped.bh_accelerations_grouped(positions, masses, g=G,
                                                    group_size=2048)
    finally:
        bh_grouped.SEG_PACK_MIN_RUN_LANES = thr
    counts = experiments.merge_ranges(*runs[0][0], **runs[0][1])[0][:, :, 1]
    mean_len = float(counts.sum()) / max(int((counts > 0).sum()), 1)
    return seen[0][0], seen[0][1], mean_len


def capture_split(positions, masses, **kw):
    """The (args, kwargs) that one grouped-BH force pass hands the K4
    wrapper: 3D at the resolved defaults, 2D with ``kw`` (split_eval)."""
    from nbody_tpu_torch.ops import bh3d, bh_grouped, list_eval

    seen = []
    with spying(list_eval, "list_eval_runs_split", seen):
        if positions.shape[1] == 3:
            bh3d.bh3_accelerations_grouped(positions, masses, g=G, **kw)
        else:
            bh_grouped.bh_accelerations_grouped(positions, masses, g=G, **kw)
    if len(seen) != 1:
        fail(f"one force pass called K4's wrapper {len(seen)} times")
    return seen[0]


def direct_fill(args):
    """(direct tiles, mean live lanes per direct tile) of a runs or split
    table."""
    import torch

    tiles, lens = args[-2], args[-1]
    t_cap = tiles.shape[2]
    n_d = lens[-1].clamp(max=t_cap)
    live = torch.arange(t_cap, device=tiles.device)[None] < n_d[:, None]
    span = (tiles[:, 2] - tiles[:, 1]).clamp(min=0) * live
    n = int(n_d.sum())
    return n, float(span.sum()) / max(n, 1)


def lanes_visited(args, k_tile: int, split: bool) -> int:
    """Source lanes the kernel visits per target, summed over its
    blocks' targets: pairs evaluated, computed from the tables (K2: per
    group, approx tiles and direct [lo, hi) lanes; K4: per quarter,
    approx, extension and direct tiles)."""
    import torch

    tgt, approx = args[0], args[1]
    tiles, lens = args[-2], args[-1]
    a_w, t_cap = approx.shape[2], tiles.shape[2]
    span = (tiles[:, 2] - tiles[:, 1]).clamp(min=0)  # [rows, T]
    n_d = lens[-1].clamp(max=t_cap)
    live = torch.arange(t_cap, device=tiles.device)[None] < n_d[:, None]
    direct = (span * live).sum(1)
    approx_l = (-(-lens[0] // k_tile) * k_tile).clamp(max=a_w)
    total = approx_l + direct
    per_row = tgt.shape[1]
    if split:
        e_w = args[2].shape[2]
        total = total + (-(-lens[1] // k_tile) * k_tile).clamp(max=e_w)
        per_row //= 4
    return int(total.sum()) * per_row


@contextlib.contextmanager
def plain_twins():
    """Route the main path's kernel wrappers to their plain twins."""
    from nbody_tpu_torch.ops import allpairs, list_eval

    orig = (allpairs.allpairs_accelerations_vs, list_eval.list_eval_runs,
            list_eval.list_eval_runs_split)
    allpairs.allpairs_accelerations_vs = (
        lambda t, s, m, *, target_block, **kw:
        allpairs.allpairs_accelerations_plain(t, s, m, **kw))
    list_eval.list_eval_runs = list_eval.list_eval_runs_plain
    list_eval.list_eval_runs_split = list_eval.list_eval_runs_split_plain
    try:
        yield
    finally:
        (allpairs.allpairs_accelerations_vs, list_eval.list_eval_runs,
         list_eval.list_eval_runs_split) = orig


COUNTERS = (("k1", "allpairs", "KERNEL_LAUNCHES"),
            ("k2", "list_eval", "KERNEL_LAUNCHES"),
            ("k3", "list_eval", "PACKED_LAUNCHES"),
            ("k4", "list_eval", "SPLIT_LAUNCHES"),
            ("dense", "collect_dense3", "DENSE_PASSES"),
            ("escaped", "collect_dense3", "ESCAPED_GROUPS"),
            ("spills", "collect_dense3", "SPILL_PASSES"))


def reset_counts():
    import importlib

    for _, mod, name in COUNTERS:
        setattr(importlib.import_module(f"nbody_tpu_torch.ops.{mod}"), name,
                0)


def read_counts() -> dict:
    import importlib

    return {key: getattr(importlib.import_module(
        f"nbody_tpu_torch.ops.{mod}"), name) for key, mod, name in COUNTERS}


def main_path_run(engine: str, n: int, dims: int, steps: int):
    """One ``run`` through the CLI with the counters reset just before
    and read just after; returns (final positions, launch counts).  The
    counts also carry the steps retried at 4x caps and the peak device
    memory of the run."""
    import torch

    from nbody_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["run", "--device", "cuda", "--dims", str(dims),
                       "--engine", engine, "--n-bodies", str(n),
                       "--steps", str(steps)])
    counts = read_counts()
    counts["retried"] = err.getvalue().count("retrying with 4x caps")
    counts["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    text = out.getvalue()
    print(text.strip())
    if err.getvalue().strip():
        print(err.getvalue().strip())
    state = cli.last_simulation.state
    tag = f"{dims}D {engine} N={n}"
    if rc != 0:
        fail(f"run {tag} exited {rc}")
    if "GPU total computation took" not in text or (
            "GPU parallel computation took" not in text):
        fail(f"run {tag} did not print both timing lines")
    if int(state.overflow) != 0:
        fail(f"run {tag}: {int(state.overflow)} bodies overflowed")
    if not bool(torch.isfinite(state.positions).all()):
        fail(f"run {tag}: non-finite positions")
    print(f"  {tag}: {steps} steps, overflow 0, positions finite; kernel "
          f"launches K1 {counts['k1']}, K2 {counts['k2']}, K3 "
          f"{counts['k3']}, K4 {counts['k4']}; dense collector passes "
          f"{counts['dense']}, escaped groups {counts['escaped']} (spill "
          f"passes {counts['spills']}); steps retried at 4x caps "
          f"{counts['retried']}; peak device memory "
          f"{counts['peak_gib']:.2f} GiB", flush=True)
    return state.positions.clone(), counts


def lockstep(engine: str, n: int, dims: int, steps: int, twin_steps: int,
             final, device) -> None:
    """Replay a main-path run as ``run_contract`` steps it (a step whose
    caps overflow is recomputed with every cap at 4x, through the gather
    walk): every step through the kernels, the first ``twin_steps`` also
    through the twins; the replay must end at the CLI run's positions bit
    for bit."""
    import torch

    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.engines import make_accel_fn, resolved_caps
    from nbody_tpu_torch.physics import integrate
    from nbody_tpu_torch.rng import random_state

    cfg = SimConfig(n_bodies=n, n_dim=dims, n_steps=steps, engine=engine)
    accel = make_accel_fn(cfg, return_diagnostics=True)
    accel4 = None
    state = random_state(cfg, device=device)
    worst, d, bound, retries = 0.0, None, None, 0
    for k in range(steps):
        prev = state
        fn = accel
        acc, ovf = fn(prev.positions, prev.masses)
        if int(ovf.sum()):
            if accel4 is None:
                caps = {c: 4 * v for c, v in resolved_caps(cfg).items()}
                accel4 = make_accel_fn(
                    cfg.replace(collect3="gather", **caps),
                    return_diagnostics=True)
            fn = accel4
            acc, ovf = fn(prev.positions, prev.masses)
            retries += 1
        state = integrate(prev, acc, cfg.dt, overflow=ovf.sum())
        if k >= twin_steps:
            continue
        with plain_twins():
            acc_t, _ = fn(prev.positions, prev.masses)
        err = float((acc - acc_t).abs().max())
        scale = float(acc_t.abs().max())
        worst = max(worst, err / scale)
        if not err <= KERNEL_TOL * scale:
            fail(f"{dims}D {engine}: force pass through the kernels differs "
                 f"from the twins by {err:.3e} (max|a| {scale:.3e})")
        twin_p = integrate(prev, acc_t, cfg.dt).positions
        d = float((state.positions - twin_p).abs().max())
        pmax = float(state.positions.abs().max())
        bound = KERNEL_TOL * scale * cfg.dt ** 2 + 4 * pmax * 2.0 ** -23
        if not d <= bound:
            fail(f"{dims}D {engine}: positions after step {k} differ from "
                 f"the twins' step by {d:.3e} (bound {bound:.3e})")
    if not torch.equal(state.positions, final):
        fail(f"{dims}D {engine}: replaying the run did not reproduce the CLI "
             "run's final positions bit for bit")
    print(f"  {dims}D {engine} N={n}: {twin_steps} lockstep force passes "
          f"within {worst:.3e} x max|a| (bound {KERNEL_TOL:g}); positions "
          f"after step {twin_steps - 1} kernels vs twins {d:.3e} (bound "
          f"{bound:.3e}); the {steps}-step replay ({retries} steps retried "
          "at 4x caps) reproduces the CLI run bit for bit -> ok", flush=True)


def first_packed_n(device) -> int:
    """The smallest N of the 3D band [131072, 262144) whose initial
    uniform state the run-length gate sends to K3."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.rng import random_state

    for n in (131072, 163840, 196608, 229376, 262143):
        st = random_state(SimConfig(n_bodies=n, n_dim=3), device=device)
        _, kw, mean_len = capture_tables(st.positions, st.masses)
        print(f"  N={n}: mean merged run length of the initial state "
              f"{mean_len:.1f} lanes -> seg_pack {kw['seg_pack']}",
              flush=True)
        if kw["seg_pack"] > 1:
            return n
    fail("the run-length gate picks K2 for every N of [131072, 262144)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a GPU", file=sys.stderr)
        return 1
    try:
        import nbody_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import nbody_tpu_torch ({e}); run it "
              "from the root of a checkout", file=sys.stderr)
        return 1
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.engines import make_accel_fn
    from nbody_tpu_torch.physics import integrate
    from nbody_tpu_torch.rng import random_state
    from nbody_tpu_torch.ops import _cuda, allpairs, bh_grouped, list_eval
    from nbody_tpu_torch.utils.occupancy import resolve_tiles

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- phase 0: the card ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        "nvidia-smi unavailable")
    kind = torch.cuda.get_device_name(0)
    print(f"phase 0: card: {card}", flush=True)
    print(f"phase 0: torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {kind}, count {torch.cuda.device_count()}", flush=True)

    # -- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    _cuda.library()
    print(f"phase 1: built/loaded kernels in {time.perf_counter() - t0:.1f}"
          f" s (nvcc {_cuda.build_seconds:.1f} s, one per source, in "
          "parallel)", flush=True)
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    # -- phase 2: K1 against its twin ------------------------------------
    err = {}
    for dims in (2, 3):
        cases = ((65536, 0.0, False), (40000, 0.0, False))
        if dims == 2:
            cases += ((40000, 1e-3, False), (65536, 0.0, True))
        print(f"phase 2{'' if dims == 2 else 'b'}: K1 (all-pairs, {dims}D) "
              "vs plain twin", flush=True)
        for n, soft, comp in cases:
            p, m = cloud(n, seed=n + int(comp) + dims, device=dev, dims=dims)
            tb, sb = resolve_tiles(n)
            kw = dict(g=G, softening=soft, source_block=sb, compensated=comp)
            got = allpairs.allpairs_accelerations_vs(p, p, m,
                                                     target_block=tb, **kw)
            want = allpairs.allpairs_accelerations_plain(p, p, m, **kw)
            torch.cuda.synchronize()
            e = compare(f"{dims}D N={n} eps={soft:g} compensated={comp}",
                        got, want)
            err.setdefault(f"k1_{dims}d", e)  # the main path's shape

    # -- phase 3: K2 against its twin on real 2D tables -------------------
    print("phase 3: K2 (runs evaluation, 2D) vs plain twin, grouped BH "
          "N=65536 group_size 2048 k_tile 256", flush=True)
    args, kw, _ = capture_tables(*cloud(65536, seed=7, device=dev))
    tgt, approx, srct, tiles, lens = args
    print(f"  tables: targets {tuple(tgt.shape)}, approx "
          f"{tuple(approx.shape)}, sources_t {tuple(srct.shape)}, tiles "
          f"{tuple(tiles.shape)}; approx lanes max {int(lens[0].max())}, "
          f"direct tiles max {int(lens[1].max())}", flush=True)
    got = list_eval.list_eval_runs(*args, **kw)
    want = list_eval.list_eval_runs_plain(*args, **kw)
    torch.cuda.synchronize()
    err["k2_2d"] = compare("K2 2D N=65536", got, want)

    # -- phase 3b: K2 (3D) and K3 on real 3D tables -----------------------
    n3 = 131072
    print(f"phase 3b: K2 (3D) and K3 (seg_pack 4) vs plain twins, 3D "
          f"grouped BH N={n3} at the resolved defaults", flush=True)
    p3, m3 = cloud(n3, seed=17, device=dev, dims=3)
    _, kw_auto, mean_len = capture_tables(p3, m3)
    gate_pick = "K3 (packed)" if kw_auto["seg_pack"] > 1 else "K2 (plain)"
    print(f"  mean merged run length {mean_len:.1f} lanes; the gate "
          f"(>= {bh_grouped.SEG_PACK_MIN_RUN_LANES:g}) picks {gate_pick}",
          flush=True)
    a3p, kw3p, _ = capture_tables(p3, m3, gate="packed")
    a3k, kw3k, _ = capture_tables(p3, m3, gate="plain")
    for name, (a, k) in (("packed", (a3p, kw3p)), ("plain", (a3k, kw3k))):
        print(f"  {name} tables: approx {tuple(a[1].shape)}, tiles "
              f"{tuple(a[3].shape)}, direct steps max {int(a[4][1].max())}, "
              f"seg_pack {k['seg_pack']}, k_tile {k['k_tile']}", flush=True)
    k3_out = list_eval.list_eval_runs(*a3p, **kw3p)
    err["k3_3d"] = compare(f"K3 3D N={n3}", k3_out,
                           list_eval.list_eval_runs_plain(*a3p, **kw3p))
    k2_out = list_eval.list_eval_runs(*a3k, **kw3k)
    err["k2_3d"] = compare(f"K2 3D N={n3}", k2_out,
                           list_eval.list_eval_runs_plain(*a3k, **kw3k))
    compare(f"K3 against K2 on the same runs, N={n3}", k3_out, k2_out)

    # -- phase 3c: K4 on real 1M tables, and in 2D -------------------------
    n1m = 1 << 20
    print(f"phase 3c: K4 (quarter-split runs evaluation) vs plain twin, 3D "
          f"grouped BH N={n1m} at the resolved defaults (dense collector, "
          "split on)", flush=True)
    p1m, m1m = cloud(n1m, seed=19, device=dev, dims=3)
    a4, kw4 = capture_split(p1m, m1m)
    print(f"  tables: targets {tuple(a4[0].shape)}, approx "
          f"{tuple(a4[1].shape)}, ext {tuple(a4[2].shape)}, tiles "
          f"{tuple(a4[4].shape)}; per quarter max approx / ext lanes / "
          f"direct tiles {a4[5].max(1).values.tolist()}, k_tile "
          f"{kw4['k_tile']}", flush=True)
    err["k4_3d"] = compare(
        f"K4 3D N={n1m}, all {a4[2].shape[0]} quarters",
        list_eval.list_eval_runs_split(*a4, **kw4),
        list_eval.list_eval_runs_split_plain(*a4, **kw4))
    p2s, m2s = cloud(65536, seed=23, device=dev)
    a42, kw42 = capture_split(p2s, m2s, group_size=2048, split_eval=True)
    err["k4_2d"] = compare(
        "K4 2D N=65536 group_size 2048 split_eval=True",
        list_eval.list_eval_runs_split(*a42, **kw42),
        list_eval.list_eval_runs_split_plain(*a42, **kw42))

    # -- phase 4: the 2D main path ------------------------------------------
    print("phase 4: 2D main path through nbody_tpu_torch.cli.main",
          flush=True)
    launches = {}
    runs2 = (("barnes_hut", 40960), ("allpairs", 65536))
    finals = {}
    for engine, n in runs2:
        finals[engine], launches[(2, engine, n)] = main_path_run(
            engine, n, 2, 10)
    if launches[(2, "barnes_hut", 40960)]["k2"] <= 0 or (
            launches[(2, "allpairs", 65536)]["k1"] <= 0):
        fail("a kernel of the 2D main path was never launched")
    for engine, n in runs2:
        lockstep(engine, n, 2, 10, 10, finals[engine], dev)

    # -- phase 4b: the 3D main path -----------------------------------------
    print("phase 4b: 3D main path through nbody_tpu_torch.cli.main; the "
          "smallest N whose initial state the gate sends to K3:", flush=True)
    nk3 = first_packed_n(dev)
    runs3 = tuple(dict.fromkeys((
        ("barnes_hut", n3), ("barnes_hut", nk3), ("barnes_hut", 65536),
        ("allpairs", 65536))))
    finals3 = {}
    for engine, n in runs3:
        finals3[(engine, n)], launches[(3, engine, n)] = main_path_run(
            engine, n, 3, 10)
    if launches[(3, "barnes_hut", nk3)]["k3"] <= 0:
        fail(f"K3 was never launched in the 3D barnes_hut run at N={nk3}")
    if launches[(3, "barnes_hut", 65536)]["k2"] <= 0:
        fail("K2 (3D) was never launched in the 3D barnes_hut run at "
             "N=65536")
    if launches[(3, "allpairs", 65536)]["k1"] <= 0:
        fail("K1 (3D) was never launched in the 3D allpairs run")
    for engine, n in runs3:
        lockstep(engine, n, 3, 10, 3, finals3[(engine, n)], dev)

    # -- phase 4c: the 3D default route at scale --------------------------
    print("phase 4c: 3D main path at scale: the dense collector at "
          "N=262144 (K2 or K3) and N=1048576 (K4)", flush=True)
    runs4c = ((262144, 10), (n1m, 10))
    for n, steps in runs4c:
        finals3[("barnes_hut", n)], launches[(3, "barnes_hut", n)] = (
            main_path_run("barnes_hut", n, 3, steps))
    c256, c1m = (launches[(3, "barnes_hut", n)] for n, _ in runs4c)
    if c1m["k4"] <= 0:
        fail(f"K4 was never launched in the 3D barnes_hut run at N={n1m}")
    if c256["k4"] != 0:
        fail("K4 was launched in the 3D barnes_hut run at N=262144 (the "
             "split gate is off there)")
    if c256["dense"] <= 0 or c1m["dense"] <= 0:
        fail("the dense collector was not reached in a 3D run at scale")
    if c256["k2"] + c256["k3"] <= 0:
        fail("neither K2 nor K3 ran in the 3D barnes_hut run at N=262144")
    for n, steps in runs4c:
        lockstep("barnes_hut", n, 3, steps, 2, finals3[("barnes_hut", n)],
                 dev)

    # -- phase 5: times on the card -------------------------------------------
    print(f"phase 5: times on {card} (CUDA events, mean of reps after a "
          "warm-up)", flush=True)
    ms = {}
    for dims in (2, 3):
        n = 65536
        p, m = cloud(n, seed=11 + dims, device=dev, dims=dims)
        tb, sb = resolve_tiles(n)
        k = cuda_ms(lambda: allpairs.allpairs_accelerations_vs(
            p, p, m, g=G, target_block=tb, source_block=sb), reps=10)
        plain = cuda_ms(lambda: allpairs.allpairs_accelerations_plain(
            p, p, m, g=G, source_block=sb), reps=2)
        ms[f"k1_{dims}d"] = (k, plain)
        print(f"  K1 {dims}D N={n}: kernel {k:.3f} ms = "
              f"{n * n / k / 1e6:.1f} Gpairs/s; plain twin {plain:.3f} ms = "
              f"{n * n / plain / 1e6:.1f} Gpairs/s  [{card}]", flush=True)

    for n in (40960, 65536):
        cfg = SimConfig(n_bodies=n, engine="barnes_hut", seed=13)
        st = random_state(cfg, device=dev)
        accel = make_accel_fn(cfg, return_diagnostics=True)

        def step():
            acc, ovf = accel(st.positions, st.masses)
            return integrate(st, acc, cfg.dt, overflow=ovf.sum())

        a, kw, _ = capture_tables(st.positions, st.masses)
        step_ms = cuda_ms(step, reps=10)
        kern = cuda_ms(lambda: list_eval.list_eval_runs(*a, **kw), reps=10)
        plain = cuda_ms(lambda: list_eval.list_eval_runs_plain(*a, **kw),
                        reps=3)
        with plain_twins():
            step_plain = cuda_ms(step, reps=3)
        print(f"  grouped BH 2D N={n}: {step_ms:.3f} ms/step (tree build "
              f"included) with K2, of which K2 {kern:.3f} ms "
              f"({100 * kern / step_ms:.1f}%); through the twin "
              f"{step_plain:.3f} ms/step, twin evaluation {plain:.3f} ms  "
              f"[{card}]", flush=True)
        if n == 40960:
            ms["k2_2d"] = (kern, plain)

    # -- phase 5b: 3D times ----------------------------------------------------
    for n in dict.fromkeys((n3, nk3)):
        cfg3 = SimConfig(n_bodies=n, n_dim=3, engine="barnes_hut")
        st3 = random_state(cfg3, device=dev)
        accel3 = make_accel_fn(cfg3, return_diagnostics=True)

        def step3():
            acc, ovf = accel3(st3.positions, st3.masses)
            return integrate(st3, acc, cfg3.dt, overflow=ovf.sum())

        step3_ms = cuda_ms(step3, reps=5)
        a_auto, kw_auto, mean_n = capture_tables(st3.positions, st3.masses)
        pick = "K3" if kw_auto["seg_pack"] > 1 else "K2"
        pick_ms = cuda_ms(
            lambda: list_eval.list_eval_runs(*a_auto, **kw_auto), reps=10)
        print(f"  grouped BH 3D N={n}: {step3_ms:.3f} ms/step (tree build "
              f"included); mean merged run {mean_n:.1f} lanes, the gate "
              f"picks {pick}: {pick_ms:.3f} ms "
              f"({100 * pick_ms / step3_ms:.1f}% of the step)  [{card}]",
              flush=True)
        if n == n3:
            pk, kk = (a3p, kw3p), (a3k, kw3k)
        else:
            pk = capture_tables(st3.positions, st3.masses, gate="packed")[:2]
            kk = capture_tables(st3.positions, st3.masses, gate="plain")[:2]
        t = {}
        for key, (a, kw) in (("k3", pk), ("k2", kk)):
            t[key] = (cuda_ms(lambda: list_eval.list_eval_runs(*a, **kw),
                              reps=10),
                      cuda_ms(lambda: list_eval.list_eval_runs_plain(*a,
                                                                     **kw),
                              reps=2))
        print(f"  on the same merged runs (N={n}): K3 {t['k3'][0]:.3f} ms "
              f"(twin {t['k3'][1]:.3f} ms), K2 {t['k2'][0]:.3f} ms (twin "
              f"{t['k2'][1]:.3f} ms): K3/K2 = {t['k3'][0] / t['k2'][0]:.3f}"
              f"  [{card}]", flush=True)
        if n == n3:
            ms["k3_3d"], ms["k2_3d"] = t["k3"], t["k2"]
    # -- phase 5c: K4, the 3D step at scale, the gates, the profile --------
    print(f"phase 5c: K4 and the 3D default route at scale on {card}",
          flush=True)
    k4_ms = cuda_ms(lambda: list_eval.list_eval_runs_split(*a4, **kw4),
                    reps=5)
    twin_ms = cuda_ms(
        lambda: list_eval.list_eval_runs_split_plain(*a4, **kw4), reps=1)
    ms["k4_3d"] = (k4_ms, twin_ms)
    # the same force pass unsplit: K2/K3 on the group-wide direct sets
    a2u, kw2u, _ = capture_tables(p1m, m1m, split_eval=False)
    k2u_ms = cuda_ms(lambda: list_eval.list_eval_runs(*a2u, **kw2u), reps=3)
    pairs4 = lanes_visited(a4, kw4["k_tile"], split=True)
    pairs2 = lanes_visited(a2u, kw2u["k_tile"], split=False)
    name2u = "K3" if kw2u["seg_pack"] > 1 else "K2"
    print(f"  K4 N={n1m}: {k4_ms:.3f} ms for {pairs4 / 1e9:.2f} G pairs = "
          f"{pairs4 / k4_ms / 1e6:.1f} Gpairs/s; twin {twin_ms:.3f} ms  "
          f"[{card}]", flush=True)
    print(f"  the same pass unsplit: {name2u} {k2u_ms:.3f} ms for "
          f"{pairs2 / 1e9:.2f} G pairs = {pairs2 / k2u_ms / 1e6:.1f} "
          f"Gpairs/s; split keeps {100 * pairs4 / pairs2:.1f}% of the pairs"
          f"  [{card}]", flush=True)
    for name, a in (("K4", a4), (name2u, a2u)):
        n_t, fill = direct_fill(a)
        print(f"  {name} direct tiles: {n_t}, {fill:.1f} live lanes per "
              f"tile of {kw4['k_tile']}", flush=True)

    def step_fn(n, **over):
        cfg = SimConfig(n_bodies=n, n_dim=3, engine="barnes_hut", **over)
        st = random_state(SimConfig(n_bodies=n, n_dim=3), device=dev)
        accel = make_accel_fn(cfg, return_diagnostics=True)

        def step():
            acc, ovf = accel(st.positions, st.masses)
            return integrate(st, acc, cfg.dt, overflow=ovf.sum())

        return step

    ab = (("dense vs gather collector", 262144, dict(collect3="gather")),
          ("dense vs gather collector", n1m, dict(collect3="gather")),
          ("split on vs off", n1m, dict(split_eval=False)))
    for what, n, alt in ab:
        base, other = step_fn(n), step_fn(n, **alt)
        t = [cuda_ms(f, reps=2) for f in (base, other, other, base)]
        print(f"  A/B {what}, N={n}: default {t[0]:.2f} / {t[3]:.2f} "
              f"ms/step, {alt} {t[1]:.2f} / {t[2]:.2f} ms/step (default "
              f"first and last, tree build included)  [{card}]", flush=True)
        ms[f"step_{n}"] = (t[0] + t[3]) / 2

    # where the 1M step's time goes: components by CUDA events, the
    # whole step by the profiler
    from nbody_tpu_torch.ops import bh3d, collect_dense3, tree3d

    step1m = step_fn(n1m)
    c_args = []
    e_args = []
    with spying(collect_dense3, "collect_lists_3d_dense", c_args), \
            spying(bh_grouped, "_evaluate_runs_split", e_args):
        step1m()
    parts = {
        "octree + spatial pyramid": lambda: collect_dense3.
        build_spatial_pyramid(tree3d.build_octree(
            p1m, m1m, max_depth=tree3d.default_max_depth3(n1m))),
        "dense collector": lambda: collect_dense3.collect_lists_3d_dense(
            *c_args[0][0], **c_args[0][1]),
        "split tables + K4": lambda: bh_grouped._evaluate_runs_split(
            *e_args[0][0], **e_args[0][1]),
        "K4 alone": lambda: list_eval.list_eval_runs_split(*a4, **kw4),
    }
    step_ms = cuda_ms(step1m, reps=2)
    print(f"  3D step N={n1m}: {step_ms:.2f} ms (tree build included)",
          flush=True)
    for name, fn in parts.items():
        t = cuda_ms(fn, reps=2)
        print(f"    {name}: {t:.2f} ms ({100 * t / step_ms:.1f}% of the "
              "step)", flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for _ in range(2):
            step1m()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) / 2 * 1e3
    kern = {}  # device kernels only: ops carry their kernels' time too
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kern[e.key] = e.self_device_time_total / 2e3  # ms per step
    busy = sum(kern.values())
    if busy > 0:
        sorts = sum(t for k, t in kern.items() if "sort" in k.lower())
        k4p = sum(t for k, t in kern.items() if "runs_split_kernel" in k)
        print(f"  profiler, N={n1m}, 2 steps: wall {wall:.2f} ms/step, "
              f"device busy {busy:.2f} ms/step, idle share "
              f"{100 * (1 - busy / wall):.1f}%; K4 {k4p:.2f} ms "
              f"({100 * k4p / busy:.1f}% of busy), sorts {sorts:.2f} ms "
              f"({100 * sorts / busy:.1f}%)  [{card}]", flush=True)
        for k, t in sorted(kern.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {t:8.3f} ms/step  {k[:100]}", flush=True)
    else:
        print("  profiler: no device time recorded; the CUDA-event split "
              "above stands alone", flush=True)
    print(f"  chip_smoke total {time.perf_counter() - t_start:.1f} s",
          flush=True)

    def entry(name, source, replaces, key, n_launch, dims):
        return {"name": name, "route": "cuda",
                "source": f"nbody_tpu_torch/csrc/{source}",
                "replaces": replaces, "dims": dims, "launches": n_launch,
                "max_abs_err": err[key], "ms": ms[key][0],
                "plain_ms": ms[key][1]}

    ap, le = "nbody_tpu/ops/allpairs.py:49", "nbody_tpu/ops/list_eval.py:333"
    k4 = entry("runs_eval_k4_3d", "runs_eval.cu",
               "nbody_tpu/ops/list_eval.py:663", "k4_3d",
               launches[(3, "barnes_hut", n1m)]["k4"], 3)
    k4["max_abs_err_2d"] = err["k4_2d"]
    summary = {"kernels": [
        entry("allpairs_k1", "allpairs.cu", ap, "k1_2d",
              launches[(2, "allpairs", 65536)]["k1"], 2),
        entry("allpairs_k1_3d", "allpairs.cu", ap, "k1_3d",
              launches[(3, "allpairs", 65536)]["k1"], 3),
        entry("runs_eval_k2", "runs_eval.cu", le, "k2_2d",
              launches[(2, "barnes_hut", 40960)]["k2"], 2),
        entry("runs_eval_k2_3d", "runs_eval.cu", le, "k2_3d",
              sum(c["k2"] for (d_, e_, _), c in launches.items()
                  if d_ == 3 and e_ == "barnes_hut"), 3),
        entry("runs_eval_k3_3d", "runs_eval.cu", le, "k3_3d",
              sum(c["k3"] for (d_, e_, _), c in launches.items()
                  if d_ == 3 and e_ == "barnes_hut"), 3),
        k4,
    ]}
    print(f"card: {card}")
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
