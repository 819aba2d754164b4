"""Phase split of the grouped Barnes-Hut force pass (2D and 3D); the port
of ``scripts/phase_split.py``.

Times the stages of the engine's own pass with CUDA events (a
synchronised clock on the CPU), over ``reps`` rounds after a warm-up
round, each round running every measurement once in turn:

  tree   — the tree build, the Morton sort, the groups and their
           sub-bboxes (3D dense route: the spatial pyramid too);
  collect — the interaction lists (the gather walk, or the dense
           window collector with its spill);
  tables — the evaluator tables (merged runs, direct tiles, approx and
           source tables, the run-length gate) up to the kernel launch;
  evaluate — the runs wrapper (K2 / K3, or K4 per quarter), host work
           and kernel, timed by events around its call(s) in the pass.

The host-bound stages are differences of nested prefixes in one round:
a prefix is the real pass stopped where the next stage's function would
be entered, so the stages are the engine's, not a copy of them.  The
evaluate stage is timed directly, since it is a fraction of a ms beside
tens of ms of host-bound prefixes.  Each stage is printed as its median
over the rounds with its min and max; what the pass spends after the
kernel (the un-sort) is the remainder, and a round's stages sum to its
tables prefix plus its evaluate stage.  The engine's force pass is timed
on its own besides (the pass a step runs, with its overflow flags), and
the runs wrapper once more on the pass's own inputs, back to back (the
kernel's time by events, as ``chip_smoke.py`` phase 5 takes it).

Stages of the JAX script with no counterpart here: the superblock
expansion (``_expand_ranges_superblocks``) and the 3D superblock pack
(``_superblock_pack_3d``) serve the padded-list evaluators (K6 / K7),
which the runs route (the default, timed here) does not run; the JAX
script's slope method is replaced by events.

Usage: python -m nbody_tpu_torch.scripts.phase_split [--device cpu]
           n=262144,dims=3 [spec...]
Keys: n, dims, collect (gather|dense, 3D), split (on|off), reps.
"""

from __future__ import annotations

import contextlib
import statistics
import sys
import time

import numpy as np
import torch

G = 6.67e-11
STAGES = ("tree", "collect", "tables", "evaluate")


class _Stop(Exception):
    """Raised where a prefix ends."""


@contextlib.contextmanager
def _patched(module, name: str, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _stop_before(orig):
    def stop(*a, **kw):
        raise _Stop
    return stop


def _stop_after(orig):
    def stop(*a, **kw):
        orig(*a, **kw)
        raise _Stop
    return stop


def _mark(device):
    """A point in time: a recorded CUDA event on the card, the clock on
    the CPU."""
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _between(a, b) -> float:
    """ms from mark ``a`` to mark ``b`` (the device has passed both)."""
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


def _call_ms(fn, device) -> float:
    """ms of one ``fn()`` (a ``_Stop`` ends it), the device idle when it
    starts and ends."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = _mark(device)
    try:
        fn()
    except _Stop:
        pass
    end = _mark(device)
    if device.type == "cuda":
        end.synchronize()
    return _between(start, end)


def _repeat_ms(fn, device, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls back to back, after one."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = _mark(device)
    for _ in range(reps):
        fn()
    end = _mark(device)
    if device.type == "cuda":
        end.synchronize()
    return _between(start, end) / reps


def _spread(values) -> dict:
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values)}


def split(n, dims, collect=None, split_eval=None, reps=9,
          device="cuda") -> dict:
    """Print and return the stages of the grouped pass at N bodies:
    ``stages`` ({stage: median ms}), ``spread`` (median, min and max of
    every stage, the remainder ``rest``, the stages' ``sum`` a round, the
    whole pass ``full`` and the engine's pass timed alone, ``pass``), ``pass_ms`` and ``kernel_ms``
    (the runs wrapper alone on the pass's inputs, back to back)."""
    from ..config import SimConfig
    from ..models.engines import make_accel_fn
    from ..ops import bh3d, bh_grouped, collect_dense3, list_eval

    device = torch.device(device)
    rng = np.random.default_rng(0)
    m = torch.tensor(10 ** rng.uniform(-1, np.log10(0.5), n),
                     dtype=torch.float32, device=device)
    p = torch.tensor(rng.uniform(-0.1, 0.1, (n, dims)), dtype=torch.float32,
                     device=device)
    if dims == 3:
        route = bh3d.resolve_route_3d(n, n, collect=collect,
                                      split_eval=split_eval)
        walk = ((collect_dense3, "collect_lists_3d_dense") if route.dense
                else (bh3d, "_collect_lists_3d"))
        split_on = route.split_eval

        def full():
            return bh3d.bh3_accelerations_grouped(
                p, m, g=G, collect=collect, split_eval=split_eval)
    else:
        walk = (bh_grouped, "_collect_lists")
        split_on = bool(split_eval)

        def full():
            return bh_grouped.bh_accelerations_grouped(
                p, m, g=G, split_eval=split_eval)
    kernel = "list_eval_runs_split" if split_on else "list_eval_runs"

    cfg = SimConfig(n_bodies=n, n_dim=dims, engine="barnes_hut",
                    collect3=collect, split_eval=split_eval)
    accel = make_accel_fn(cfg, return_diagnostics=True)

    def stopped(module, name, make):
        def run():
            with _patched(module, name, make):
                full()
        return run

    calls = []  # (start, end) markers of the kernel's calls this pass

    def marked(orig):
        def call(*a, **kw):
            calls.append(_mark(device))
            out = orig(*a, **kw)
            calls[-1] = (calls[-1], _mark(device))
            inputs[:] = [a, kw]
            return out
        return call

    inputs = []
    prefixes = {"tree": stopped(*walk, _stop_before),
                "collect": stopped(*walk, _stop_after),
                "tables": stopped(list_eval, kernel, _stop_before),
                "full": stopped(list_eval, kernel, marked),
                "pass": lambda: accel(p, m)}
    rounds = {k: [] for k in (*STAGES, "rest", "sum", "full", "pass")}
    for r in range(reps + 1):
        ms = {}
        for k, fn in prefixes.items():
            calls.clear()
            ms[k] = _call_ms(fn, device)
            if k == "full":
                eval_ms = sum(_between(a, b) for a, b in calls)
        if not r:
            continue
        for i, st in enumerate(STAGES[:-1]):
            rounds[st].append(ms[st] - (ms[STAGES[i - 1]] if i else 0.0))
        rounds["evaluate"].append(eval_ms)
        rounds["rest"].append(ms["full"] - ms["tables"] - eval_ms)
        rounds["sum"].append(ms["tables"] + eval_ms)
        rounds["full"].append(ms["full"])
        rounds["pass"].append(ms["pass"])
    spread = {k: _spread(v) for k, v in rounds.items()}
    stages = {st: spread[st]["median"] for st in STAGES}
    a, kw = inputs
    alone_ms = _repeat_ms(lambda: getattr(list_eval, kernel)(*a, **kw),
                          device, max(reps, 5))
    where = (f"{walk[1]}, {kernel}" + ("" if dims == 2 else
                                       f", group {route.group_size}"))
    print(f"N={n} dims={dims} ({where}) on {device}, median [min, max] "
          f"of {reps} rounds: " + " | ".join(
              f"{st} {spread[st]['median']:.3f} [{spread[st]['min']:.3f}, "
              f"{spread[st]['max']:.3f}]" for st in (*STAGES, "rest"))
          + f" | full {spread['full']['median']:.3f} ms/pass; the "
          f"engine's pass alone {spread['pass']['median']:.3f} ms; "
          f"{kernel} alone on the pass's inputs {alone_ms:.3f} ms",
          flush=True)
    return dict(stages=stages, spread=spread,
                pass_ms=spread["pass"]["median"], kernel_ms=alone_ms,
                collector=walk[1], kernel=kernel)


def main(argv=None) -> int:
    from ._cli import parse

    device, specs = parse(argv, "nbody_tpu_torch.scripts.phase_split",
                          __doc__)
    for parts in specs:
        split(int(parts.get("n", 65536)), int(parts.get("dims", 2)),
              collect=parts.get("collect"),
              split_eval={"on": True, "off": False, None: None}[
                  parts.get("split")],
              reps=int(parts.get("reps", 9)), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
