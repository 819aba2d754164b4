"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted`` (steps), ``failed`` (steps that
ended with caps overflowed), ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; last, ``check``: each number the check compared with its
limit (also the last lines of standard error).  Without the cards the
cell asks for it prints no result and exits 3; having loaded JAX or the
JAX package, 4.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()
T_START_EPOCH = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from . import cells, check, harness  # noqa: E402

# kernel caches of the libraries the program may use, at fixed paths in
# the checkout (the program builds its own kernels into build/ there)
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_environment() -> None:
    """Kernel caches at fixed paths in the checkout; one host thread for
    PyTorch's CPU work in every process (the load comes from one process
    a card, and host stalls are the noise of the host-bound cells)."""
    base = cells.ROOT / "build" / "benchmark_cache"
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(base / sub)
    os.environ["OMP_NUM_THREADS"] = "1"


def children() -> list:
    """The process ids of this process's living children."""
    pids = []
    for task in os.listdir(f"/proc/{os.getpid()}/task"):
        try:
            with open(f"/proc/{os.getpid()}/task/{task}/children") as f:
                pids += [int(p) for p in f.read().split()]
        except OSError:  # the thread has ended
            pass
    return pids


def stop_children(grace_s: float = 10.0) -> None:
    """Stop every process this one started and wait until each has
    ended: the resource tracker that ``multiprocessing``'s spawn starts
    for the ranks (which would outlive the run until it saw this process
    exit), and any other child still running (SIGTERM, then SIGKILL)."""
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._stop()
    pids = children()
    for pid in pids:
        os.kill(pid, signal.SIGTERM)
    deadline = time.monotonic() + grace_s
    while pids:
        pids = [p for p in pids if os.waitpid(p, os.WNOHANG) == (0, 0)]
        if pids and time.monotonic() > deadline:
            for pid in pids:
                os.kill(pid, signal.SIGKILL)
            for pid in pids:
                os.waitpid(pid, 0)
            return
        time.sleep(0.05)


def run_mesh(cell, device_type: str, entry, *args) -> list:
    """What ``entry(rank, cell, *args, out_dir, device_type)`` wrote to
    ``out_dir/rank<r>.json`` on each of ``cell.devices`` ranks (rank r on
    card r, in processes that ``parallel.mesh.spawn`` joins in one
    process group), in rank order."""
    from nbody_tpu_torch.parallel.mesh import spawn

    if device_type == "cuda":
        from nbody_tpu_torch.ops import _cuda

        _cuda.library()  # built once here, loaded by every rank
    out_dir = tempfile.mkdtemp(prefix="benchmark_ranks_")
    try:
        spawn(entry, cell.devices, (cell, *args, out_dir, device_type),
              device_type=device_type, init_dir=out_dir)
        parts = []
        for r in range(cell.devices):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                parts.append(json.load(f))
    finally:
        stop_children()
        shutil.rmtree(out_dir, ignore_errors=True)
    return parts


def run_ranks(cell, args, device_type: str, entry=None) -> list:
    """Every rank's part of the result of a mesh cell, each rank running
    ``entry`` (default ``harness.rank_entry``)."""
    parts = run_mesh(cell, device_type, entry or harness.rank_entry,
                     args.seed, args.seconds, bool(args.trace),
                     T_START_EPOCH)
    # rank 0's set-up ends where its window starts
    parts[0]["setup_s"] = parts[0]["window_epoch"] - T_START_EPOCH
    return parts


def result(cell, parts: list, traced: bool) -> dict:
    """The result line of a run from its ranks' parts."""
    head = parts[0]
    steps = head["steps"]
    numbers = {
        "final_mismatches": sum(p["check"]["final_mismatches"]
                                for p in parts),
        "update_mismatches": sum(p["check"]["update_mismatches"]
                                 for p in parts),
        "force_gap": max(p["check"]["force_gap"] for p in parts),
        "steps_compared": min(p["check"]["steps_compared"] for p in parts),
    }
    limits = check.limits(cell.config)
    if traced:
        metrics = cells.merge_metrics(cell, [p["per_layer"] for p in parts])
    else:
        values = {cell.traffic["metric"]: head["run_s"] * 1e3 / steps,
                  "setup_s": head["setup_s"]}
        metrics = {m.name: {"value": values[m.name], "unit": m.unit}
                   for m in cell.end_to_end if m.name in values}
    device = {"platform": "gpu", "kind": head["kind"],
              "count": cell.devices,
              "memory_peak_bytes": max(p["memory_peak_bytes"]
                                       for p in parts)}
    out = {"correct": check.verdict(numbers, cell.config),
           "attempted": steps, "failed": head["failed"],
           "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = sum(p["busy_s"] for p in parts) / len(parts)
        device["window_s"] = sum(p["window_s"] for p in parts) / len(parts)
        out["breakdown"] = head["breakdown"]
    out["check"] = {k: {"value": numbers[k], "limit": v}
                    for k, v in limits.items()}
    out["check"]["steps_compared"] = {"value": numbers["steps_compared"],
                                      "limit": "at least 1"}
    return out


def main(argv=None) -> int:
    try:
        return measure(parse(argv))
    finally:
        stop_children()


def measure(args) -> int:
    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"ERROR: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()})", file=sys.stderr)
        return 3
    set_environment()
    torch.set_num_threads(1)
    if cell.devices > 1:
        parts = run_ranks(cell, args, "cuda")
    else:
        parts = [harness.run_rank(cell, args.seed, args.seconds,
                                  bool(args.trace), torch.device("cuda", 0),
                                  T_START)]
    return report(cell, parts, bool(args.trace))


def report(cell, parts: list, traced: bool) -> int:
    """Print the result line (and the check's numbers on standard error)
    unless a forbidden module was loaded here or in a rank."""
    found = set(harness.forbidden_modules())
    for p in parts:
        found.update(p.get("modules", ()))
    if found:
        print(f"ERROR: loaded {sorted(found)}: the benchmark runs the "
              "PyTorch port alone", file=sys.stderr)
        return 4
    out = result(cell, parts, traced)
    for r, p in enumerate(parts):
        ms = sorted(p["run_ms"])
        slow = sorted(range(len(ms)), key=lambda i: -p["run_ms"][i])[:5]
        print(f"rank {r}: {p['runs']} runs, ms a run: first "
              f"{p['run_ms'][0]:.1f}, min {ms[0]:.1f}, median "
              f"{ms[len(ms) // 2]:.1f}, max {ms[-1]:.1f}; slowest (run: ms, "
              "capture ms, replay ms): " + ", ".join(
                  f"({i}: {p['run_ms'][i]:.1f}, {p['capture_ms'][i]:.1f}, "
                  f"{p['scan_ms'][i]:.1f})" for i in slow)
              + f"; the check took {p['check_s']:.1f} s", file=sys.stderr)
    for name, v in out["check"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
