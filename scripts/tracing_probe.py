#!/usr/bin/env python3
"""One traced window of a one-card benchmark cell through the
benchmark's own harness (``benchmark.harness.run_rank`` with
``--trace 1``'s profiler), then the program's spans
(``nbody_tpu_torch.utils.profiling``) held to what they must show:

    PYTHONPATH=. python3 scripts/tracing_probe.py CELL SEED SECONDS

One JSON line: the spans counted by name, the per-layer metrics, the
traced and the untraced runs' ms a step (the window's first
``trace_runs`` runs run under the profiler, the rest not), the idle gaps
and ``benchmark.run``'s share of them; for a fused cell each traced
capture's ``nbody.capture`` span against ``last_capture_ms`` and its four
parts' share of it; for a loop cell the stages' stream and host ms a
step (retries apart), the sum of the four ``*_ms.loop`` metrics and
``nbody.integrate`` against the kernels' device ms and the traced wall,
and the ``nbody.retry`` spans against ``last_retried_steps`` and the
printed retry lines.  Needs the card.
"""
import collections
import json
import sys
import time

T0 = time.perf_counter()

import torch  # noqa: E402

from benchmark import cells, harness  # noqa: E402
from nbody_tpu_torch.models import simulation  # noqa: E402
from nbody_tpu_torch.utils import profiling  # noqa: E402

PARTS = ("nbody.capture.warm", "nbody.capture.enter", "nbody.capture.trace",
         "nbody.capture.end")

name, seed, seconds = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
cell = cells.load_cell(name)
infos, retried = [], []
orig_run = harness.Program.run


def run(self, state, steps):
    final, info = orig_run(self, state, steps)
    infos.append(dict(info))
    return final, info


orig_contract = simulation.Simulation.run_contract


def contract(self):
    out = orig_contract(self)
    retried.append(self.last_retried_steps)
    return out


harness.Program.run = run
simulation.Simulation.run_contract = contract
torch.set_num_threads(1)
part = harness.run_rank(cell, seed, seconds, True, torch.device("cuda", 0),
                        T0)
recs = profiling.spans()
by_id = {r.id: r for r in recs}
tr = int(cell.traffic.get("trace_runs", 1))
warm = int(cell.config.get("warm_runs", 1))
steps = int(cell.traffic["steps_per_run"])
traced_steps = tr * steps
run_ms = part["run_ms"]
out = dict(cell=name, seed=seed, card=torch.cuda.get_device_name(0),
           runs=part["runs"], spans=dict(collections.Counter(
               r.name for r in recs)),
           per_layer=part["per_layer"],
           traced_ms_per_step=sum(run_ms[:tr]) / traced_steps,
           untraced_ms_per_step=(sum(run_ms[tr:]) / (len(run_ms[tr:]) * steps)
                                 if run_ms[tr:] else None),
           idle_gaps=part["breakdown"]["idle_gaps"],
           device_ops=part["breakdown"]["device_ops"],
           busy_s=part["busy_s"], window_s=part["window_s"],
           correct=part["check"])
gaps = part["breakdown"]["idle_gaps"]
total = sum(v for _, v in gaps)
out["benchmark_run_gap_share"] = sum(
    v for n, v in gaps if n == "benchmark.run") / total if total else None


def under(r, name):
    p = r.parent
    while p is not None:
        if by_id[p].name == name:
            return True
        p = by_id[p].parent
    return False


if cell.traffic["entry"] == "run_scan":
    caps = [r for r in recs if r.name == "nbody.capture"]
    rows = []
    for c, last in zip(caps, part["capture_ms"][:tr]):
        kids = [r for r in recs if r.parent == c.id]
        split = {p: sum(r.host_ms for r in kids if r.name == p)
                 for p in PARTS}
        rows.append(dict(capture_span_ms=c.host_ms, last_capture_ms=last,
                         parts=split, parts_share=sum(split.values())
                         / c.host_ms, span_vs_last=c.host_ms / last - 1))
    out["captures"] = rows
    reps = [r for r in recs if r.name == "nbody.replay"]
    out["replay_host_ms"] = [r.host_ms for r in reps]
    out["replay_stream_ms"] = [r.stream_ms for r in reps]
else:
    stage = {}
    for s in ("nbody.tree", "nbody.collect", "nbody.eval",
              "nbody.integrate", "nbody.sync"):
        xs = [r for r in recs if r.name == s and not under(r, "nbody.retry")]
        stage[s] = dict(
            stream_ms_per_step=sum(r.stream_ms or 0 for r in xs)
            / traced_steps,
            host_ms_per_step=sum(r.host_ms for r in xs) / traced_steps)
    rt = [r for r in recs if r.name == "nbody.retry"]
    stage["nbody.retry"] = dict(
        stream_ms_per_step=sum(r.stream_ms for r in rt) / traced_steps,
        host_ms_per_step=sum(r.host_ms for r in rt) / traced_steps,
        count=len(rt))
    out["stages"] = stage
    pl = part["per_layer"]
    four = sum(pl.get(k, 0) for k in ("tree_ms.loop", "collect_ms.loop",
                                      "eval_ms.loop", "retry_ms.loop"))
    tiled = four + stage["nbody.integrate"]["stream_ms_per_step"]
    kernels = pl.get("hand_kernel_ms.loop", 0) + pl.get(
        "torch_kernel_ms.loop", 0)
    out["tiling"] = dict(sum_ms=tiled, kernels_ms=kernels,
                         sum_over_kernels=tiled / kernels if kernels else None,
                         traced_wall_ms=out["traced_ms_per_step"])
    out["retries"] = dict(
        spans=len(rt), last_retried_steps=sum(retried[warm:warm + tr]),
        printed=sum(i["retried"] for i in infos[warm:warm + tr]))
print(json.dumps(out), flush=True)
