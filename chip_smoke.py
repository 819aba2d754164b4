#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (nbody_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing what it found; the first failure exits non-zero:

0. the card: ``nvidia-smi`` name and power limit, torch's device name;
1. build the CUDA kernels from nbody_tpu_torch/csrc (nvcc, sm_90a);
2. kernel K1 (all-pairs) against its plain PyTorch twin on the card;
3. kernel K2 (grouped Barnes-Hut runs evaluation) against its twin on
   the tables of a real 2D grouped-BH state;
4. the main path: ``nbody_tpu_torch.cli.main(["run", ...])`` for
   barnes_hut at N=40,960 and allpairs at N=65,536, 10 steps each, with
   the kernels' launch counters reset just before and read just after;
   the same runs through the plain twins must end at the same positions;
5. times on the card (CUDA events, after a warm-up), kernel beside twin.

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
# the kernels.  Instead every state of the kernel run goes through both
# force passes: the accelerations must agree within KERNEL_TOL x max|a|,
# and the final positions within KERNEL_TOL x max|a| x dt^2 plus 4 ulp of
# the largest coordinate (the rounding of p + v dt).


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cloud(n: int, seed: int, device):
    """Bodies of the reference's distribution (project.cu:30-35)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    lo, hi = math.log10(0.1), math.log10(0.5)
    m = 10 ** (lo + (hi - lo) * torch.rand(n, generator=gen))
    p = -0.1 + 0.2 * torch.rand((n, 2), generator=gen)
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


def capture_tables(positions, masses):
    """The (args, kwargs) that one grouped-BH force pass hands K2."""
    from nbody_tpu_torch.ops import bh_grouped, list_eval

    seen = {}
    orig = list_eval.list_eval_runs

    def spy(*a, **kw):
        seen["args"], seen["kw"] = a, kw
        return orig(*a, **kw)

    list_eval.list_eval_runs = spy
    try:
        bh_grouped.bh_accelerations_grouped(positions, masses, g=G,
                                            group_size=2048)
    finally:
        list_eval.list_eval_runs = orig
    return seen["args"], seen["kw"]


@contextlib.contextmanager
def plain_twins():
    """Route the main path's two kernel wrappers to their plain twins."""
    from nbody_tpu_torch.ops import allpairs, list_eval

    orig_vs, orig_runs = (allpairs.allpairs_accelerations_vs,
                          list_eval.list_eval_runs)
    allpairs.allpairs_accelerations_vs = (
        lambda t, s, m, *, target_block, **kw:
        allpairs.allpairs_accelerations_plain(t, s, m, **kw))
    list_eval.list_eval_runs = (
        lambda *a, seg_pack=1, **kw: list_eval.list_eval_runs_plain(*a, **kw))
    try:
        yield
    finally:
        allpairs.allpairs_accelerations_vs = orig_vs
        list_eval.list_eval_runs = orig_runs


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
    from nbody_tpu_torch import cli
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.engines import make_accel_fn
    from nbody_tpu_torch.physics import integrate
    from nbody_tpu_torch.rng import random_state
    from nbody_tpu_torch.ops import _cuda, allpairs, list_eval
    from nbody_tpu_torch.utils.occupancy import resolve_tiles

    dev = torch.device("cuda", 0)

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
          f" s (nvcc {_cuda.build_seconds:.1f} s)", flush=True)
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    # -- phase 2: K1 against its twin ------------------------------------
    print("phase 2: K1 (all-pairs) vs plain twin", flush=True)
    k1_err = None
    for n, soft, comp in ((65536, 0.0, False), (40000, 0.0, False),
                          (40000, 1e-3, False), (65536, 0.0, True)):
        p, m = cloud(n, seed=n + int(comp), device=dev)
        tb, sb = resolve_tiles(n)
        kw = dict(g=G, softening=soft, source_block=sb, compensated=comp)
        got = allpairs.allpairs_accelerations_vs(p, p, m, target_block=tb,
                                                 **kw)
        want = allpairs.allpairs_accelerations_plain(p, p, m, **kw)
        torch.cuda.synchronize()
        err = compare(f"N={n} eps={soft:g} compensated={comp}", got, want)
        if k1_err is None:
            k1_err = err  # the main path's shape: N=65,536, eps=0

    # -- phase 3: K2 against its twin on real tables ---------------------
    print("phase 3: K2 (runs evaluation) vs plain twin, 2D grouped BH "
          "N=65536 group_size 2048 k_tile 256", flush=True)

    args65, kw65 = capture_tables(*cloud(65536, seed=7, device=dev))
    tgt, approx, srct, tiles, lens = args65
    print(f"  tables: targets {tuple(tgt.shape)}, approx "
          f"{tuple(approx.shape)}, sources_t {tuple(srct.shape)}, tiles "
          f"{tuple(tiles.shape)}; approx lanes max {int(lens[0].max())}, "
          f"direct tiles max {int(lens[1].max())}", flush=True)
    got = list_eval.list_eval_runs(*args65, **kw65)
    want = list_eval.list_eval_runs_plain(*args65, **kw65)
    torch.cuda.synchronize()
    k2_err = compare("K2 N=65536", got, want)

    # -- phase 4: the main path ------------------------------------------
    print("phase 4: main path through nbody_tpu_torch.cli.main", flush=True)
    runs = (("barnes_hut", 40960), ("allpairs", 65536))
    allpairs.KERNEL_LAUNCHES = 0
    list_eval.KERNEL_LAUNCHES = 0
    finals = {}
    for engine, n in runs:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["run", "--device", "cuda", "--engine", engine,
                           "--n-bodies", str(n), "--steps", "10"])
        text = out.getvalue()
        print(text.strip())
        sim = cli.last_simulation
        state = sim.state
        if rc != 0:
            fail(f"run {engine} exited {rc}")
        if "GPU total computation took" not in text or (
                "GPU parallel computation took" not in text):
            fail(f"run {engine} did not print both timing lines")
        if int(state.overflow) != 0:
            fail(f"run {engine}: {int(state.overflow)} bodies overflowed")
        if not bool(torch.isfinite(state.positions).all()):
            fail(f"run {engine}: non-finite positions")
        finals[engine] = state.positions.clone()
        print(f"  {engine} N={n}: 10 steps, overflow 0, positions finite",
              flush=True)
    launches = {"k1": allpairs.KERNEL_LAUNCHES,
                "k2": list_eval.KERNEL_LAUNCHES}
    print(f"  kernel launches in the main-path runs: K1 {launches['k1']}, "
          f"K2 {launches['k2']}", flush=True)
    if launches["k1"] <= 0 or launches["k2"] <= 0:
        fail("a kernel of the main path was never launched")

    # the same runs in lockstep through the plain twins on the card
    for engine, n in runs:
        cfg = SimConfig(n_bodies=n, n_steps=10, engine=engine)
        accel = make_accel_fn(cfg, return_diagnostics=True)
        state = random_state(cfg, device=dev)
        worst = 0.0
        for _ in range(cfg.n_steps):
            prev = state
            acc, ovf = accel(state.positions, state.masses)
            with plain_twins():
                acc_t, _ = accel(state.positions, state.masses)
            err = float((acc - acc_t).abs().max())
            scale = float(acc_t.abs().max())
            worst = max(worst, err / scale)
            if not err <= KERNEL_TOL * scale:
                fail(f"{engine}: force pass through the kernels differs from "
                     f"the twins by {err:.3e} (max|a| {scale:.3e})")
            state = integrate(state, acc, cfg.dt, overflow=ovf.sum())
        if not torch.equal(state.positions, finals[engine]):
            fail(f"{engine}: replaying the run did not reproduce the CLI "
                 "run's final positions bit for bit")
        last_t = integrate(prev, acc_t, cfg.dt).positions
        d = float((state.positions - last_t).abs().max())
        pmax = float(state.positions.abs().max())
        bound = KERNEL_TOL * scale * cfg.dt ** 2 + 4 * pmax * 2.0 ** -23
        ok = d <= bound
        print(f"  {engine} N={n}: lockstep force passes within "
              f"{worst:.3e} x max|a| (bound {KERNEL_TOL:g}); final positions "
              f"kernels vs twins {d:.3e} (bound {bound:.3e}); the replay "
              f"reproduces the CLI run bit for bit -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{engine}: final positions differ from the twins' step")

    # -- phase 5: times on the card ----------------------------------------
    print(f"phase 5: times on {card} (CUDA events, mean of reps after a "
          "warm-up)", flush=True)
    n = 65536
    p, m = cloud(n, seed=11, device=dev)
    tb, sb = resolve_tiles(n)
    k1_ms = cuda_ms(lambda: allpairs.allpairs_accelerations_vs(
        p, p, m, g=G, target_block=tb, source_block=sb), reps=10)
    k1_plain = cuda_ms(lambda: allpairs.allpairs_accelerations_plain(
        p, p, m, g=G, source_block=sb), reps=2)
    print(f"  K1 N={n}: kernel {k1_ms:.3f} ms = {n * n / k1_ms / 1e6:.1f} "
          f"Gpairs/s; plain twin {k1_plain:.3f} ms = "
          f"{n * n / k1_plain / 1e6:.1f} Gpairs/s  [{card}]", flush=True)

    k2_ms = k2_plain = None
    for n in (40960, 65536):
        cfg = SimConfig(n_bodies=n, engine="barnes_hut", seed=13)
        st = random_state(cfg, device=dev)
        accel = make_accel_fn(cfg, return_diagnostics=True)

        def step():
            acc, ovf = accel(st.positions, st.masses)
            return integrate(st, acc, cfg.dt, overflow=ovf.sum())

        a, kw = capture_tables(st.positions, st.masses)
        step_ms = cuda_ms(step, reps=10)
        kern = cuda_ms(lambda: list_eval.list_eval_runs(*a, **kw), reps=10)
        plain = cuda_ms(lambda: list_eval.list_eval_runs_plain(*a, **kw),
                        reps=3)
        with plain_twins():
            step_plain = cuda_ms(step, reps=3)
        print(f"  grouped BH N={n}: {step_ms:.3f} ms/step (tree build "
              f"included) with K2, of which K2 {kern:.3f} ms "
              f"({100 * kern / step_ms:.1f}%); through the twin "
              f"{step_plain:.3f} ms/step, twin evaluation {plain:.3f} ms  "
              f"[{card}]", flush=True)
        if n == 40960:
            k2_ms, k2_plain = kern, plain

    summary = {"kernels": [
        {"name": "allpairs_k1", "route": "cuda",
         "source": "nbody_tpu_torch/csrc/allpairs.cu",
         "replaces": "nbody_tpu/ops/allpairs.py:49",
         "launches": launches["k1"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "runs_eval_k2", "route": "cuda",
         "source": "nbody_tpu_torch/csrc/runs_eval.cu",
         "replaces": "nbody_tpu/ops/list_eval.py:333",
         "launches": launches["k2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
    ]}
    print(f"card: {card}")
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
