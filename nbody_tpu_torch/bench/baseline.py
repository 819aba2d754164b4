"""BASELINE.json benchmark configs as runnable scenarios on the port
(counterpart of ``nbody_tpu.bench.baseline``).

Run: ``python -m nbody_tpu_torch.bench.baseline [--configs 1,2,3,4,5]
[--out FILE] [--device cuda|cpu]``

1. All-pairs N=1,024 from the reference's golden init triplet, 100 steps,
   dt=1: the f32 trajectory (``physics.pair_accelerations_dense`` on the
   device) and an f64 one (the same function in float64 on the CPU)
   against the f64 NumPy oracle (``models/oracle.py``, main_approach_1.cpp
   semantics).  The triplet is read from ``$NBODY_REFERENCE_DIR``; without
   it the record is an error that says so.
2. Kernel K1 at N=16,384: pairs/s (CUDA events) and the largest error
   against ``pair_accelerations_dense``.
3. Grouped Barnes-Hut, theta=0.5, N=65,536: tree-build and force-pass
   seconds, overflowed bodies, and the quadtree dump of the initial state
   (``utils/native.py``, byte-equal to the reference's own dump).
4. Strong scaling, Barnes-Hut N=262,144, and
5. weak scaling, 131,072 bodies a card: the ranks of ``run --devices D``
   (``dp_barnes_hut_grouped``, NCCL, one card a rank; one untimed
   warm-up step, then 10 timed, as the sweep's points) at every D in
   1, 2, 4, 8 that the visible cards allow;
   each point labelled with its cards, the counts out of reach listed as
   not run, and nothing projected.  Each point carries the modelled
   ``comm_bytes_per_step_per_chip`` (``parallel/memory.py``).  The JAX
   package's ``projection_real_hardware`` is not ported: its link rate
   is a TPU interconnect assumption, not a number of this card.

The results file (default ``baseline_results_torch.json``) is written
atomically (tmp + ``os.replace``) after every config.  A rerun of some
configs keeps the records of the others, and a config that fails on a
rerun keeps its previous good record with the error beside it as
``last_error``; it never replaces a good record with an error stub.
It exits 1 when a config of this run failed, and without a card and
without ``--device cpu`` it exits 1 and writes nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

G = 6.67e-11
TRIPLET = ("masses_init.txt", "positions_init.txt", "velocities_init.txt")
REF_STEP_SECONDS_40K = 0.0065  # project_report.pdf p.24, an NVIDIA T600


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _seconds(fn, device, reps: int = 5) -> float:
    """Median seconds of ``fn()`` over ``reps`` calls after one warm-up;
    CUDA events on the card, a synchronised clock on the CPU."""
    import torch

    fn()
    _sync(device)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _cloud(n: int, device, seed: int = 0):
    """Masses and positions of the reference's distribution."""
    import torch

    rng = np.random.default_rng(seed)
    m = torch.tensor(10 ** rng.uniform(-1, np.log10(0.5), n),
                     dtype=torch.float32, device=device)
    p = torch.tensor(rng.uniform(-0.1, 0.1, (n, 2)), dtype=torch.float32,
                     device=device)
    return m, p


def config1(device, ref_dir=None, n: int = 1024, steps: int = 100):
    """Golden-fixture all-pairs, ``steps`` steps, against the f64 oracle."""
    import torch

    from ..models import oracle
    from ..physics import pair_accelerations_dense
    from ..utils.textio import load_init_triplet

    ref_dir = ref_dir or os.environ.get("NBODY_REFERENCE_DIR")
    if not ref_dir:
        raise FileNotFoundError(
            "NBODY_REFERENCE_DIR is not set: config 1 needs the reference's "
            f"golden triplet ({', '.join(TRIPLET)})")
    missing = [f for f in TRIPLET
               if not os.path.exists(os.path.join(ref_dir, f))]
    if missing:
        raise FileNotFoundError(
            f"the reference's golden triplet is not in {ref_dir}: missing "
            f"{', '.join(missing)}")
    m, p, v = load_init_triplet(*(os.path.join(ref_dir, f) for f in TRIPLET),
                                n)
    traj = oracle.simulate(p, v, m, steps, dt=1.0, g=G, engine="naive")
    marks = [s for s in (25, 45, 100) if s <= steps]

    def run(dtype, dev):
        """q995 / rms errors against the oracle at the marks, and the
        seconds of the loop."""
        pt, vt, mt = (torch.tensor(a, dtype=dtype, device=dev)
                      for a in (p, v, m))
        errs = {}
        _sync(dev)
        t0 = time.perf_counter()
        for step_i in range(1, steps + 1):
            vt = vt + pair_accelerations_dense(pt, mt, g=G)
            pt = pt + vt
            if step_i in marks:
                want = traj[step_i]
                scale = np.abs(want).max()
                e = np.abs(pt.cpu().double().numpy() - want)
                errs[step_i] = {
                    "rms_rel": float(np.sqrt((e**2).mean()) / scale),
                    "q995_rel": float(np.quantile(e, 0.995) / scale),
                }
        _sync(dev)
        return errs, time.perf_counter() - t0

    errs, elapsed = run(torch.float32, device)
    # the binding parity criterion in f64 on the CPU (the reference is
    # all f64): an independent implementation of the same sums against
    # the oracle, the reference's checkEqual method (project.cu:1027-1047)
    f64, _ = run(torch.float64, torch.device("cpu"))
    rec = {
        "config": 1,
        "n": n,
        "steps": steps,
        "seconds": elapsed,
        "f32_err_by_step": errs,
        "f64_q995_rel_by_step": {k: e["q995_rel"] for k, e in f64.items()},
    }
    # chaos bounds any cross-implementation comparison: the reference's
    # own f64 CPU and GPU runs part "around 45th iteration"
    # (observations.txt:43), so parity binds at step 45 (f64) and 25 (f32)
    if 45 in f64:
        rec["pass_1e-3_at_step45_f64"] = bool(f64[45]["q995_rel"] < 1e-3)
    if 25 in errs:
        rec["pass_1e-3_at_step25_f32"] = bool(errs[25]["q995_rel"] < 1e-3)
    return rec


def config2(device, n: int = 16384):
    """Kernel K1 at N: pairs/s and the error against the dense form."""
    import torch

    from ..ops.allpairs import allpairs_accelerations
    from ..physics import pair_accelerations_dense

    m, p = _cloud(n, device)
    acc = allpairs_accelerations(p, m, g=G)
    want = pair_accelerations_dense(p, m, g=G)
    rel = float((acc - want).abs().max() / want.abs().max())
    del want
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sec = _seconds(lambda: allpairs_accelerations(p, m, g=G), device)
    return {
        "config": 2,
        "n": n,
        "pairs_per_sec": n * n / sec,
        "kernel_seconds": sec,
        "max_rel_err_vs_dense": rel,
    }


def config3(device, out_dir=".", n: int = 65536):
    """Grouped Barnes-Hut theta=0.5 at N, and the initial quadtree dump."""
    from ..config import SimConfig
    from ..models.engines import make_accel_fn
    from ..ops.tree import build_quadtree

    m, p = _cloud(n, device)
    accel = make_accel_fn(SimConfig(n_bodies=n, engine="barnes_hut"),
                          return_diagnostics=True)
    build_sec = _seconds(lambda: build_quadtree(p, m, max_depth=9), device)
    force_sec = _seconds(lambda: accel(p, m), device)
    _, ovf = accel(p, m)

    from ..utils import native

    path = os.path.join(out_dir, "quadtree_init_baseline.txt")
    os.makedirs(out_dir, exist_ok=True)
    text = native.tree_dump(p.double().cpu().numpy(),
                            m.double().cpu().numpy())
    with open(path, "w") as f:
        f.write(text)
    return {
        "config": 3,
        "n": n,
        "tree_build_seconds": build_sec,
        "step_seconds_incl_build": force_sec,
        "steps_per_sec": 1.0 / force_sec,
        "overflowed_bodies": int(ovf.sum()),
        "dump_written": os.path.getsize(path) > 0,
        "dump": path,
        "ref_best_step_seconds_40k": REF_STEP_SECONDS_40K,
        "ref_hardware": "NVIDIA T600 (the reference's GPU-kernel time, "
                        "project_report.pdf p.24)",
    }


def _run_point(n: int, n_dev: int, device, steps: int, out_dir: str):
    """One scaling point on ``n_dev`` processes, timed as the sweep's
    D > 1 points are (``sweeps.run_point``: ``run --devices D``'s ranks,
    one untimed warm-up step, then the contract loop): (seconds a step,
    retried steps)."""
    from ..cli import _add_common
    from .sweeps import run_point

    ap = argparse.ArgumentParser()
    _add_common(ap)
    args = ap.parse_args([
        "--engine", "barnes_hut", "--n-bodies", str(n), "--steps",
        str(steps), "--devices", str(n_dev), "--device", device.type,
        "--output-dir", out_dir])
    rec = run_point(args, "dp_barnes_hut_grouped")
    return rec["step_seconds"], rec["retried_steps"]


def config45(device, weak: bool, n: int | None = None, steps: int = 10,
             out_dir="."):
    """Strong (fixed N, default 262,144) or weak (N a card, default
    131,072) scaling of grouped Barnes-Hut over the visible cards."""
    import torch

    from ..config import SimConfig
    from ..parallel.memory import comm_bytes_per_step
    from . import card_info

    n = n or (131072 if weak else 262144)
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    counts = [d for d in (1, 2, 4, 8) if d <= visible]
    mode = "dp_barnes_hut_grouped"
    points = []
    for n_dev in counts:
        n_pt = n * n_dev if weak else n
        sec, retried = _run_point(n_pt, n_dev, device, steps, out_dir)
        points.append({
            "devices": n_dev,
            "label": (f"{n_dev} card{'s' if n_dev > 1 else ''}"
                      if device.type == "cuda" else "cpu"),
            "n": n_pt,
            "steps": steps,
            "step_seconds": sec,
            "retried_steps": retried,
            "comm_bytes_per_step_per_chip": comm_bytes_per_step(
                SimConfig(n_bodies=n_pt), n_dev, mode),
        })
    base = points[0]["step_seconds"]
    for pt in points:
        pt["speedup"] = None if weak else base / pt["step_seconds"]
        pt["efficiency"] = base / pt["step_seconds"] / (
            1 if weak else pt["devices"])
    card, limit = card_info(device)
    return {
        "config": 5 if weak else 4,
        "backend": device.type,
        "card": card,
        "power_limit": limit,
        "mode": mode,
        "points": points,
        "not_run": [{"devices": d, "reason": f"{visible} card(s) visible"
                     if device.type == "cuda" else "one CPU device"}
                    for d in (1, 2, 4, 8) if d > visible],
        "timing": "run --devices D's ranks: one untimed warm-up step, "
                  "then the contract loop's parallel time over the steps "
                  "(4x-caps retries included)",
    }


def merge(prior: list, fresh: list) -> list:
    """Records of ``prior`` and ``fresh`` by config: a fresh good record
    replaces the old one; a fresh error beside an old good record is kept
    as its ``last_error``; configs not rerun keep their records."""
    by_config = {r.get("config"): r for r in prior}
    for rec in fresh:
        old = by_config.get(rec["config"])
        if "error" in rec and old is not None and "error" not in old:
            by_config[rec["config"]] = {**old, "last_error": rec["error"]}
        else:
            by_config[rec["config"]] = rec
    return [by_config[c] for c in sorted(by_config, key=lambda c: c or 99)]


def write_atomic(path: str, report: list) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2)
    os.replace(tmp, path)


def _read(path: str) -> list:
    if not os.path.exists(path):
        return []
    try:
        with open(path) as f:
            prior = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"baseline: {path} unreadable ({e}); writing fresh records",
              file=sys.stderr)
        return []
    return prior if isinstance(prior, list) else []


def run_configs(wanted, device, out: str, out_dir: str = ".",
                **sizes) -> list:
    """Run the configs in ``wanted`` on ``device``, merging each record
    into ``out`` as it completes; returns the merged report.  ``sizes``
    cuts the configs' N (``n1``..``n5``) for tests."""
    runners = {
        1: lambda: config1(device, n=sizes.get("n1", 1024)),
        2: lambda: config2(device, n=sizes.get("n2", 16384)),
        3: lambda: config3(device, out_dir, n=sizes.get("n3", 65536)),
        4: lambda: config45(device, False, n=sizes.get("n4"),
                            out_dir=out_dir),
        5: lambda: config45(device, True, n=sizes.get("n5"),
                            out_dir=out_dir),
    }
    report = _read(out)
    for c in sorted(wanted):
        print(f"running config {c}...", file=sys.stderr)
        try:
            rec = runners[c]()
        except Exception as e:  # record the failure, keep going
            rec = {"config": c, "error": f"{type(e).__name__}: {e}"[:500]}
        rec["device"] = str(device)
        print(json.dumps(rec), file=sys.stderr)
        report = merge(report, [rec])
        write_atomic(out, report)
    return report


def main(argv=None) -> int:
    from . import DeviceUnavailable, measurement_device

    ap = argparse.ArgumentParser(prog="nbody_tpu_torch.bench.baseline")
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--out", default="baseline_results_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the kernels) or cpu (their "
                         "plain twins)")
    args = ap.parse_args(argv)
    wanted = {int(c) for c in args.configs.split(",")}
    if not wanted <= {1, 2, 3, 4, 5}:
        ap.error(f"--configs takes 1-5, got {args.configs}")
    try:
        device = measurement_device(args.device)
    except DeviceUnavailable as e:
        print(f"baseline: {e}", file=sys.stderr)
        return 1
    out_dir = os.path.dirname(os.path.abspath(args.out))
    report = run_configs(wanted, device, args.out, out_dir)
    print(json.dumps(report))
    # a config of this run that failed left "error" (or, beside an older
    # good record, "last_error"); a good record replaces both
    failed = [r["config"] for r in report if r["config"] in wanted
              and ("error" in r or "last_error" in r)]
    if failed:
        print(f"baseline: configs {failed} failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
