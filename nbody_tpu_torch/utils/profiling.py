"""Profiling hooks (counterpart of ``nbody_tpu.utils.profiling``): the
program's spans and counters, and a ``torch.profiler`` trace around a
run.

The reference's profiling is chrono bracketing plus static ptxas
register counts (project.cu:71-73).  Here the two-tier Stopwatch /
RunTiming (``utils.timing``) is the chrono analogue, and this module adds
``torch.profiler`` (host ops and, on the card, CUDA kernels) as the
deep-inspection tier.

Spans.  The program marks its layer boundaries with :func:`span` (the
names: README, "Tracing").  The switch is torch's own: a span records
only while ``torch.profiler`` is recording on this thread.  Off, ``span``
returns one shared no-op context (no ``record_function``, no CUDA event,
no allocation).  On, it enters ``torch.profiler.record_function`` (the
span is a ``user_annotation`` in the profiler's trace, on the clock of
the device's kernels) and keeps a :class:`Span` record in memory: its
parent, its run (the outermost span around it, for the program's spans
the ``nbody.run`` of one ``Simulation`` run), host start and end, and the
stream time between two timing events on the current CUDA stream (None
on the CPU, and where the stream was capturing a CUDA graph).  A
``counted`` span also keeps the change of every counter of
:func:`counter_values` over it.  :func:`spans` returns the records (one
device synchronise resolves their events), :func:`clear` drops them.

Counters are plain module integers, always on: the host reads of a step
(``ops._graph.HOST_READS``), the cells the adaptive engine builds below
its pyramid and the groups that walk them (``ops.tree3d.REFINED_CELLS``,
``ops.bh3d.REFINE_GROUPS``), and the collectives' calls and operand
bytes (``parallel.collectives``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

# (module of nbody_tpu_torch, attribute) of every counter a counted span
# reads
COUNTERS = (
    ("ops._graph", "HOST_READS"),
    ("ops.tree3d", "REFINED_CELLS"),
    ("ops.bh3d", "REFINE_GROUPS"),
    *(("parallel.collectives", f"{op}_{what}")
      for op in ("ALL_GATHER", "PSUM", "PMIN", "PMAX", "PPERMUTE")
      for what in ("CALLS", "BYTES")),
)

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_records: List["Span"] = []
_ids = itertools.count()
_local = threading.local()


@dataclasses.dataclass
class Span:
    """One span: ``parent`` and ``run`` are span ids (None: no parent);
    host times from ``time.perf_counter_ns``; ``stream_ms`` the current
    CUDA stream's time across it; ``counters`` {name: change} of a
    counted span."""

    name: str
    id: int
    parent: Optional[int]
    run: int
    start_ns: int
    end_ns: int = 0
    stream_ms: Optional[float] = None
    counters: Optional[Dict[str, int]] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


def enabled() -> bool:
    """Whether ``torch.profiler`` is recording on this thread."""
    return torch._C._autograd._profiler_enabled()


def counter_values() -> Dict[str, int]:
    """{"module.attribute": value} of every counter in ``COUNTERS``."""
    return {f"{mod}.{name}": getattr(importlib.import_module(
        f"nbody_tpu_torch.{mod}"), name) for mod, name in COUNTERS}


def _stream():
    """The current CUDA stream where CUDA is in use and that stream is
    not capturing a graph, else None."""
    if not torch.cuda.is_initialized() or (
            torch.cuda.is_current_stream_capturing()):
        return None
    return torch.cuda.current_stream()


class _Live:
    """A span while the profiler records."""

    def __init__(self, name: str, counted: bool):
        self.name = name
        self.counted = counted

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        span_id = next(_ids)
        parent = stack[-1] if stack else None
        self.rec = Span(self.name, span_id,
                        parent.id if parent else None,
                        parent.run if parent else span_id,
                        time.perf_counter_ns())
        self.before = counter_values() if self.counted else None
        self.stream = _stream()
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        stack.append(self.rec)
        return self.rec

    def __exit__(self, *exc):
        _local.stack.pop()
        rec = self.rec
        stream = _stream()
        if self.stream is not None and stream == self.stream:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            rec.events = (self.start, end)
        if self.counted:
            after = counter_values()
            rec.counters = {k: after[k] - v for k, v in self.before.items()}
        rec.end_ns = time.perf_counter_ns()
        self.fn.__exit__(*exc)
        with _lock:
            _records.append(rec)
        return False


def span(name: str, counted: bool = False):
    """A named span of the program (module docstring): a no-op unless
    the profiler records."""
    if not enabled():
        return _OFF
    return _Live(name, counted)


def spans() -> List[Span]:
    """The spans recorded so far, in the order they started, their
    stream times resolved."""
    with _lock:
        recs = sorted(_records, key=lambda r: r.id)
    for rec in recs:
        if rec.events is not None:
            start, end = rec.events
            end.synchronize()
            rec.stream_ms = start.elapsed_time(end)
            rec.events = None
    return recs


def clear() -> None:
    """Drop the recorded spans."""
    with _lock:
        _records.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace around a code block, written to
    ``log_dir`` for TensorBoard or Perfetto when the block ends:

        with profiling.trace("traces/run"):
            sim.run_scan(10)

    The CUDA activity is traced where the card is available; the
    program's spans are in it.  Yields the profiler (``key_averages()``
    sums its events by name)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
