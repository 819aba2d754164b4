"""The port's spans and counters (nbody_tpu_torch.utils.profiling) and
the benchmark's readers of them, on the CPU.

A span records only while torch's profiler does; off, it is one shared
no-op.  The counters (host reads, collectives) are always on.  The
card-only checks (the capture's spans, stream times, collectives counted
once per replay) are in ``test_torch_cuda.py`` and
``test_torch_cuda_mesh.py``.
"""

import collections
import contextlib
import dataclasses
import io
import json
import sys
import threading

import pytest
import torch

import nbody_tpu_torch
from benchmark import cells, harness
from nbody_tpu_torch import cli
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import _graph
from nbody_tpu_torch.utils import profiling
from nbody_tpu_torch.utils.profiling import Span, counter, span


@pytest.fixture
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_span_off_is_one_shared_noop(fresh, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: calls.append("record_function"))
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: calls.append("Event"))
    assert not profiling.enabled()
    assert span("a") is span("b", counted=True)
    cfg = nbody_tpu_torch.SimConfig(n_bodies=1024, n_steps=1,
                                    engine="barnes_hut", seed=3)
    sim = Simulation(cfg, device="cpu")
    sim.run_contract()
    sim.run_scan(1)
    assert calls == [] and profiling.spans() == []


def test_unknown_counter_raises():
    before = profiling.counter_values()
    with pytest.raises(KeyError, match="HOST_READ"):
        profiling.count("ops._graph.HOST_READ")
    with pytest.raises(KeyError):
        counter("ops.allpairs.LAUNCHES")
    assert profiling.counter_values() == before


def test_threads_counting_together_lose_nothing():
    """Eight threads adding 10,000 each (thread ranks count together),
    switching as often as the interpreter allows."""
    name = "ops.list_eval.GRID_LAUNCHES"
    before = counter(name)
    start = threading.Barrier(8)

    def add():
        start.wait(timeout=60)
        for _ in range(10_000):
            profiling.count(name)

    threads = [threading.Thread(target=add) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counter(name) == before + 80_000
    profiling.count(name, -80_000)


def test_benchmark_suffixes_select_only_their_counters():
    """The benchmark selects counters by name suffix
    (``benchmark/program_spans.counter_per_step``): each suffix picks
    exactly the counters it read before the registry."""
    picked = {suffix: {n for n in profiling.COUNTERS if n.endswith(suffix)}
              for suffix in ("HOST_READS", "REFINED_CELLS", "_BYTES")}
    assert picked["HOST_READS"] == {"ops._graph.HOST_READS"}
    assert picked["REFINED_CELLS"] == {"ops.tree3d.REFINED_CELLS"}
    assert picked["_BYTES"] == {
        f"parallel.collectives.{op}_BYTES"
        for op in ("ALL_GATHER", "PSUM", "PMIN", "PMAX", "PPERMUTE")}
    assert len(set(profiling.COUNTERS)) == len(profiling.COUNTERS) == 26


def test_count_under_capture_goes_to_the_recorder(monkeypatch):
    """Under a (here pretended) capture a count is not made: it goes to
    the innermost frame of the thread's recorder, a tensor to a device
    slot; with no recorder it raises."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    before = profiling.counter_values()
    with pytest.raises(RuntimeError, match="counting"):
        profiling.count("ops.allpairs.KERNEL_LAUNCHES")
    counts = _graph.CaptureCounts(torch.device("cpu"))
    with _graph.counting(counts):
        profiling.count("ops.allpairs.KERNEL_LAUNCHES")
        profiling.count("ops.allpairs.KERNEL_LAUNCHES", 2)
        profiling.count("ops.collect_dense3.ESCAPED_GROUPS",
                        torch.tensor(4))
    assert profiling.recorder() is None
    assert counts.per_replay == {"ops.allpairs.KERNEL_LAUNCHES": 3}
    assert counts.slots == [{"ops.collect_dense3.ESCAPED_GROUPS": 1}]
    assert profiling.counter_values() == before
    monkeypatch.undo()
    assert counts.settle() == {"collect_dense3.ESCAPED_GROUPS": 4}
    assert counter("ops.collect_dense3.ESCAPED_GROUPS") == (
        before["ops.collect_dense3.ESCAPED_GROUPS"] + 4)
    profiling.count("ops.collect_dense3.ESCAPED_GROUPS", -4)


def test_span_records_parent_run_and_trace(fresh, tmp_path):
    with _cpu_profile() as prof:
        with span("outer", counted=True) as outer:
            with span("inner") as inner:
                _graph.host_read(torch.tensor(3))
            with span("inner"):
                pass
        with span("second"):
            pass
    recs = profiling.spans()
    assert [r.name for r in recs] == ["outer", "inner", "inner", "second"]
    assert recs[0] is outer and recs[1] is inner
    assert outer.parent is None and outer.run == outer.id
    assert all(r.parent == outer.id and r.run == outer.id
               for r in recs[1:3])
    assert recs[3].parent is None and recs[3].run == recs[3].id
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert outer.counters["ops._graph.HOST_READS"] == 1
    assert set(outer.counters) == set(profiling.COUNTERS)
    assert inner.counters is None
    assert all(r.stream_ms is None for r in recs)  # no CUDA stream here
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    named = collections.Counter(e["name"] for e in events
                                if e.get("cat") == "user_annotation")
    assert named["outer"] == 1 and named["inner"] == 2
    assert named["second"] == 1
    profiling.clear()
    assert profiling.spans() == []


def test_retries_and_host_reads_are_counted(fresh, monkeypatch):
    """3D through the dense collector (one spill gate a step) with list
    caps that overflow: every step retries at 4x caps."""
    gates = []
    orig = _graph._host_value

    def spy(pred):
        gates.append(1)
        return orig(pred)

    monkeypatch.setattr(_graph, "_host_value", spy)
    cfg = nbody_tpu_torch.SimConfig(
        n_bodies=8192, n_dim=3, n_steps=2, engine="barnes_hut",
        collect3="dense", list_cap=8, seed=3)
    sim = Simulation(cfg, device="cpu")
    err = io.StringIO()
    reads = counter("ops._graph.HOST_READS")
    with _cpu_profile(), contextlib.redirect_stderr(err):
        sim.run_contract()
    reads = counter("ops._graph.HOST_READS") - reads
    recs = profiling.spans()
    names = collections.Counter(r.name for r in recs)
    retried = err.getvalue().count("retrying with 4x caps")
    assert sim.last_retried_steps == retried == names["nbody.retry"] == 2
    assert sim.last_overflowed_steps == 2  # 4x list caps still overflow
    # a gate read a first pass, then one overflow read a pass
    assert len(gates) == cfg.n_steps
    assert reads == len(gates) + cfg.n_steps + retried
    (run,) = [r for r in recs if r.name == "nbody.run"]
    assert run.counters["ops._graph.HOST_READS"] == reads
    assert names["nbody.step"] == names["nbody.sync"] - retried == 2
    for stage in ("nbody.tree", "nbody.collect", "nbody.eval",
                  "nbody.integrate"):
        assert names[stage] == cfg.n_steps + retried
    by_id = {r.id: r for r in recs}
    assert {by_id[r.parent].name for r in recs if r.name == "nbody.tree"
            } == {"nbody.step", "nbody.retry"}


def test_fused_run_counts_overflowed_steps():
    cfg = nbody_tpu_torch.SimConfig(
        n_bodies=1024, n_steps=2, engine="barnes_hut", group_size=256,
        list_cap=1, seed=3)
    sim = Simulation(cfg, device="cpu")
    with contextlib.redirect_stderr(io.StringIO()):
        sim.run_scan()
    assert sim.last_overflowed_steps == 2 and sim.last_retried_steps == 0


@pytest.mark.parametrize("n_dev", [2, 4])
def test_thread_mesh_counts_collectives(n_dev):
    """dp_allpairs: two all-gathers a step a rank, of the slab's positions
    (N/D x 2 x 4 B) and masses (N/D x 4 B); thread ranks add together."""
    from nbody_tpu_torch.parallel import make_sharded_step
    from nbody_tpu_torch.parallel.mesh import (run_ranks, shard_state,
                                               thread_meshes)

    n, steps = 512, 3
    cfg = nbody_tpu_torch.SimConfig(n_bodies=n, n_steps=steps,
                                    engine="allpairs", seed=5)
    state = nbody_tpu_torch.random_state(cfg, device="cpu")

    def rank(mesh):
        slab = shard_state(state, mesh)
        step = make_sharded_step(cfg, mesh, "dp_allpairs")
        for _ in range(steps):
            slab = step(slab)
        return slab

    before = profiling.counter_values()
    run_ranks(rank, thread_meshes(n_dev, "cpu"))
    after = profiling.counter_values()
    moved = {k: after[k] - v for k, v in before.items() if after[k] != v}
    key = "parallel.collectives.ALL_GATHER"
    assert moved == {f"{key}_CALLS": 2 * steps * n_dev,
                     f"{key}_BYTES": steps * n_dev * (
                         n // n_dev * 2 * 4 + n // n_dev * 4)}
    assert counter(f"{key}_CALLS") == after[f"{key}_CALLS"]


def test_cli_profile_writes_a_trace_with_spans(tmp_path, fresh):
    rc = cli.main(["run", "--device", "cpu", "--engine", "barnes_hut",
                   "--n-bodies", "1024", "--steps", "2", "--output-dir",
                   str(tmp_path), "--profile", str(tmp_path / "prof")])
    assert rc == 0
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    named = collections.Counter(e["name"] for e in events
                                if e.get("cat") == "user_annotation")
    assert named["nbody.run"] == 1 and named["nbody.step"] == 2
    assert named["nbody.tree"] == named["nbody.integrate"] == 2


# ---- the benchmark's readers, on hand-made spans -------------------------

class _Spans:
    """Hand-made spans, as the program records them (ms; stream ms)."""

    def __init__(self):
        self.recs = []

    def add(self, name, parent=None, ms=0.0, stream=None, counters=None):
        sid = len(self.recs)
        run = self.recs[parent].run if parent is not None else sid
        self.recs.append(Span(name, sid, parent, run, 0, int(ms * 1e6),
                              stream, counters))
        return sid


def _fused():
    """Two fused runs: a capture each, its warm step and two captures."""
    s = _Spans()
    for warm, enter, trace, end in ((30.0, (10.0, 6.0), (20.0, 24.0),
                                     (3.0, 1.0)),
                                    (34.0, (12.0, 4.0), (22.0, 26.0),
                                     (1.0, 3.0))):
        cap = s.add("nbody.capture", s.add("nbody.run"), ms=150.0)
        s.add("nbody.capture.warm", cap, ms=warm)
        for i in range(2):
            s.add("nbody.capture.enter", cap, ms=enter[i])
            s.add("nbody.capture.trace", cap, ms=trace[i])
            s.add("nbody.capture.end", cap, ms=end[i])
    return s.recs


def _loop(retried=(False, True)):
    """A contract run of two steps, the second retried."""
    s = _Spans()
    run = s.add("nbody.run", counters={"ops._graph.HOST_READS": 7})
    for again in retried:
        step = s.add("nbody.step", run, stream=7.0)
        s.add("nbody.tree", step, stream=1.0)
        s.add("nbody.collect", step, stream=2.0)
        s.add("nbody.eval", step, stream=3.0)
        s.add("nbody.integrate", step, stream=0.5)
        s.add("nbody.sync", run)
        if again:
            retry = s.add("nbody.retry", run, stream=61.0)
            s.add("nbody.tree", retry, stream=10.0)
            s.add("nbody.collect", retry, stream=20.0)
            s.add("nbody.eval", retry, stream=30.0)
            s.add("nbody.sync", run)
    return s.recs


def _mesh():
    """A rank's fused run of 100 steps: the warm step's two all-gathers
    in the run, outside its replays."""
    s = _Spans()
    per_step = {"ALL_GATHER_CALLS": 2, "ALL_GATHER_BYTES": 786432,
                "PSUM_BYTES": 0}
    run = s.add("nbody.run", counters={
        f"parallel.collectives.{k}": v * 101 for k, v in per_step.items()})
    s.add("nbody.replay", run, counters={
        f"parallel.collectives.{k}": v * 100 for k, v in per_step.items()})
    return s.recs


READS = {
    # metric: (spans, traced steps, value)
    "capture_warm_ms.fused": (_fused, 20, (30.0 + 34.0) / 2),
    "capture_enter_ms.fused": (_fused, 20, (10.0 + 6.0 + 12.0 + 4.0) / 2),
    "capture_trace_ms.fused": (_fused, 20, (20.0 + 24.0 + 22.0 + 26.0) / 2),
    "capture_end_ms.fused": (_fused, 20, (3.0 + 1.0 + 1.0 + 3.0) / 2),
    "tree_ms.loop": (_loop, 2, 1.0),
    "collect_ms.loop": (_loop, 2, 2.0),
    "eval_ms.loop": (_loop, 2, 3.0),
    "retry_ms.loop": (_loop, 2, 30.5),
    "host_reads.loop": (_loop, 2, 3.5),
    "collective_mb.mesh": (_mesh, 100, 0.786432),
}


def _readings(steps):
    return harness.Readings(config={}, runs=1, steps=steps, retried_steps=0,
                            capture_ms=[], traced_steps=steps)


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_on_hand_made_spans(metric, monkeypatch):
    recs, steps, want = READS[metric]
    monkeypatch.setattr(profiling, "spans", recs)
    got = cells.metric_module(metric).read(_readings(steps))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_finds_nothing_to_read(metric, monkeypatch):
    """A program without ``profiling.spans`` (the parent's), or with no
    span recorded, reads None; so do stream times a CPU run lacks."""
    recs, steps, _ = READS[metric]
    read = cells.metric_module(metric).read
    monkeypatch.delattr(profiling, "spans")
    assert read(_readings(steps)) is None
    monkeypatch.setattr(profiling, "spans", list, raising=False)
    assert read(_readings(steps)) is None
    cpu = [dataclasses.replace(r, stream_ms=None) for r in recs()]
    monkeypatch.setattr(profiling, "spans", lambda: cpu)
    if metric.endswith("_ms.loop"):
        assert read(_readings(steps)) is None
    else:
        assert read(_readings(steps)) is not None


def test_retry_ms_reads_zero_without_retries(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: _loop((False, False)))
    assert cells.metric_module("retry_ms.loop").read(_readings(2)) == 0.0
    assert cells.metric_module("tree_ms.loop").read(_readings(2)) == 1.0


def test_hand_kernel_names_find_every_source_and_the_dense_collector():
    """The benchmark's kernel reader finds each built source's kernels by
    name, the dense 3D collector's among them, with no edit of its own."""
    from benchmark import trace
    from nbody_tpu_torch.ops import _cuda

    names = trace.hand_kernel_names()
    assert "dense_collect3_kernel" in names
    assert {"allpairs_kernel", "runs_split_kernel", "leaf_sums_kernel",
            "set_if_kernel"} <= names
    assert {p.name for p in trace.CSRC.glob("*.cu")} == set(_cuda.SOURCES)
