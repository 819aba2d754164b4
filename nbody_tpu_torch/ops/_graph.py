"""Device conditionals for the port's data-dependent gates (the JAX
package's ``lax.cond``), and the counts they keep under CUDA graph capture.

A gate whose decision is a 0-d tensor runs its branch through
:func:`device_if` (or :func:`device_cond` for an if/else pair):

* outside capture (the contract loop, and every CPU run) the decision is
  read on the host once and the branch runs or not;
* while a CUDA graph is being captured the branch is recorded into a
  conditional IF node on the decision (CUDA 12.4 or later, runtime and
  driver): the graph holds the branch, and each replay runs it or not
  with no host read.  An if/else is two IF nodes, on the decision and on
  its negation (an IF/ELSE node needs CUDA 12.8), as torch's own
  ``torch/_higher_order_ops/cudagraph_conditional_nodes.py`` does.

The IF node is made by the kernel library (``csrc/graph_if.cu``), as
torch before 2.13 has no Python call for one: the node goes into the
graph being captured, and the branch is captured on a stream of the
library's own into the node's body graph, its allocations taken from a
memory pool of the capture's own.  A branch writes its results in place
into tensors made before it: the graph after the node reads fixed
addresses.

Counting.  The kernel wrappers count a launch when they launch, which
under capture means once, when it is recorded.  A graph's owner (the
fused run's ``StepGraph``) turns that into counts per replay, and needs
to know which launches sit in a branch: those run only on the replays
that take it.  While a :class:`CaptureCounts` is active (:func:`counting`),
every :func:`device_if` under capture adds one to a device counter of
its branch whenever a replay takes it, and records the launches and the
fixed tallies (:func:`tally` of an int) made inside it;
:func:`tally` of a tensor adds its value on the device.  The owner reads
the device counters once after its replays (:meth:`CaptureCounts.settle`).
A counter is named as in ``_cuda.LAUNCH_COUNTERS``: (module of
``nbody_tpu_torch.ops``, attribute), or for a module outside ``ops/``
its dotted name under ``nbody_tpu_torch`` (``"parallel.collectives"``).
:data:`HOST_READS` counts the host reads of a step (:func:`host_read`).
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib
import sys
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from ..utils.profiling import span
from . import _cuda

Key = Tuple[str, str]

# host reads of a tensor value made by the steps: the gates'
# (``_host_value``) and the contract loop's overflow count
HOST_READS = 0

_state = threading.local()


# the capture mode of a branch's stream (cudaStreamCaptureModeGlobal,
# torch's default for the graph around it)
_CAPTURE_MODE_GLOBAL = 0


def _capturing_now() -> bool:
    return torch.cuda.is_available() and (
        torch.cuda.is_current_stream_capturing())


def capturing(t: torch.Tensor) -> bool:
    """Whether the current stream of ``t``'s CUDA device is capturing a
    graph (False for a CPU tensor)."""
    return t.is_cuda and _capturing_now()


def add_counts(amounts: Dict[Key, int], times: int = 1) -> None:
    """Add ``times`` x each amount to its counter (under the counter
    lock: thread ranks count together)."""
    with _cuda.counter_lock:
        for (mod, name), k in amounts.items():
            m = importlib.import_module(
                f"nbody_tpu_torch.{mod}" if "." in mod
                else f"{__package__}.{mod}")
            setattr(m, name, getattr(m, name) + k * times)


class CaptureCounts:
    """What one capture's replays add to the counters.

    ``per_replay``: the fixed tallies made outside any branch (the
    graph's owner adds the launches outside branches itself).
    ``slots``: for each device counter (a row of ``values``), the amount
    of each counter one unit of it stands for: a branch's launches and
    fixed tallies per replay that took it, or 1 for a tallied value.
    ``branch_launches``: the launches recorded inside top-level branches,
    which the owner takes out of its per-replay launches."""

    SLOTS = 64

    def __init__(self, device: torch.device, warm: bool = False):
        self.device = device
        self.warm = warm
        # made before the capture: a counter allocated inside it would be
        # zeroed by every replay
        self.values = torch.zeros(self.SLOTS, dtype=torch.int64,
                                  device=device)
        self.keep: list = []
        self._pool = None
        self._streams: list = []
        self.per_replay: Dict[Key, int] = {}
        self.slots: list = []
        self.names: list = []
        self.branch_launches: Dict[Key, int] = {}
        self._frames = [self.per_replay]
        self._nested = [self.branch_launches]

    @property
    def pool(self):
        """The branches' memory pool: its blocks live as long as these
        counts (the graph's owner keeps both)."""
        if self._pool is None:
            self._pool = torch.cuda.MemPool()
        return self._pool

    def child_stream(self, depth: int) -> torch.cuda.ExternalStream:
        """The stream a branch at nesting ``depth`` is captured on: one
        of the kernel library's own, so never the capturing stream."""
        while len(self._streams) <= depth:
            ptr = ctypes.c_void_p()
            _cuda.check(_cuda.library().nbody_graph_stream_create(
                ctypes.byref(ptr)), "stream create")
            self._streams.append(torch.cuda.ExternalStream(
                ptr.value, device=self.device))
        return self._streams[depth]

    def _slot(self, amounts: Dict[Key, int], name: str) -> int:
        if len(self.slots) == self.SLOTS:
            raise RuntimeError(
                f"more than {self.SLOTS} counted branches or tallies in one "
                "capture")
        self.slots.append(amounts)
        self.names.append(name)
        return len(self.slots) - 1

    def _add_device(self, slot: int, value) -> None:
        row = self.values.narrow(0, slot, 1)
        if isinstance(value, torch.Tensor):
            row.add_(value.reshape(1).to(torch.int64))
        else:
            row.add_(value)

    def settle(self) -> Dict[str, int]:
        """Add what the replays since the last settle counted on the
        device to the counters (one host read) and zero the device
        counts; returns {slot name: its count} of those replays."""
        vals = self.values.tolist()
        self.values.zero_()
        seen = {}
        for amounts, name, v in zip(self.slots, self.names, vals):
            add_counts(amounts, v)
            seen[name] = seen.get(name, 0) + v
        return seen


def _active() -> Optional[CaptureCounts]:
    return getattr(_state, "counts", None)


@contextlib.contextmanager
def counting(counts: CaptureCounts):
    """Count the branches and tallies of the captures made in this block
    (on this thread) into ``counts``."""
    prev = _active()
    _state.counts = counts
    try:
        yield counts
    finally:
        _state.counts = prev


def capture(graph: torch.cuda.CUDAGraph, fn: Callable[[], None],
            device: torch.device, **kw) -> None:
    """Capture ``fn()`` into ``graph`` (``torch.cuda.graph(graph, **kw)``)
    from a memory pool of its own.  A capture that fails raises, after
    releasing the allocator's entry for the failed capture's pool, which
    torch 2.11 leaves behind: with it left, the next teardown of any
    memory pool (a :class:`CaptureCounts`' branch pool) aborts the
    process (``captures_underway.empty()`` INTERNAL ASSERT in
    ``synchronize_and_free_events``).

    Spans: ``nbody.capture.enter`` (the context's entry: a synchronise,
    the allocator's cache emptied, the capture begun),
    ``nbody.capture.trace`` (``fn()``) and ``nbody.capture.end`` (the
    capture ended and the graph instantiated)."""
    pool = torch.cuda.graph_pool_handle()
    try:
        ctx = torch.cuda.graph(graph, pool=pool, **kw)
        with span("nbody.capture.enter"):
            ctx.__enter__()
        try:
            with span("nbody.capture.trace"):
                fn()
        except BaseException:
            ctx.__exit__(*sys.exc_info())
            raise
        with span("nbody.capture.end"):
            ctx.__exit__(None, None, None)
    except BaseException:
        index = torch.cuda.current_device() if device.index is None else (
            device.index)
        torch._C._cuda_endAllocateToPool(index, pool)
        torch._C._cuda_releasePool(index, pool)
        raise


def host_read(t: torch.Tensor) -> int:
    """``int(t)``, counted in :data:`HOST_READS`."""
    global HOST_READS
    with _cuda.counter_lock:
        HOST_READS += 1
    return int(t)


def host_values(t: torch.Tensor) -> list:
    """``t.tolist()`` of a 1-d integer tensor, one read counted in
    :data:`HOST_READS`."""
    global HOST_READS
    with _cuda.counter_lock:
        HOST_READS += 1
    return t.tolist()


def _host_value(pred: torch.Tensor) -> int:
    """The one host read of a gate outside capture."""
    return host_read(pred)


def device_if(pred: torch.Tensor, fn: Callable[[], None],
              name: str = "branch") -> Optional[int]:
    """Run ``fn()`` iff ``pred`` (a 0-d tensor, bool or integer: nonzero
    is true).  Outside capture ``pred`` is read on the host once, and
    that value is returned (so a caller can count what decided); under
    capture ``fn`` is recorded into a conditional IF node and None is
    returned.  ``fn`` returns nothing: it writes in place.  ``name``
    labels the branch's device counter (:meth:`CaptureCounts.settle`).

    Under capture a :class:`CaptureCounts` must be active
    (:func:`counting`): it holds the branch's stream and memory pool.  In
    its ``warm`` mode (a throwaway capture) ``fn`` is recorded straight,
    so that every branch meets its first use before the real capture."""
    if not capturing(pred):
        v = _host_value(pred)
        if v:
            fn()
        return v
    counts = _active()
    if counts is None:
        raise RuntimeError(
            "device_if under a CUDA graph capture needs an active "
            "_graph.counting(CaptureCounts(device)) (the fused run's "
            "StepGraph makes one)")
    if counts.warm:
        fn()
        return None
    cond = pred if pred.dtype == torch.bool else pred != 0
    cond = cond.contiguous()
    counts.keep.append(cond)  # the graph reads it at every launch
    dev = cond.device
    lib = _cuda.library()
    parent = torch.cuda.current_stream(dev)
    child = counts.child_stream(len(counts._frames) - 1)
    before = _cuda.launch_counts()
    amounts: Dict[Key, int] = {}
    nested: Dict[Key, int] = {}
    counts._frames.append(amounts)
    counts._nested.append(nested)
    try:
        _cuda.check(lib.nbody_graph_if_begin(
            parent.cuda_stream, cond.data_ptr(), child.cuda_stream,
            _CAPTURE_MODE_GLOBAL),
            "conditional node (needs CUDA 12.4 or later)")
        try:
            with torch.cuda.stream(child), torch.cuda.use_mem_pool(
                    counts.pool, dev):
                fn()
                slot = counts._slot(amounts, name)
                counts._add_device(slot, 1)
        finally:
            _cuda.check(lib.nbody_graph_if_end(child.cuda_stream),
                        "conditional node")
    finally:
        counts._frames.pop()
        counts._nested.pop()
    after = _cuda.launch_counts()
    for key in after:
        d = after[key] - before[key]
        if d:
            # the branch's own launches: those of branches nested in it
            # are counted by their own slots
            own = d - nested.get(key, 0)
            if own:
                amounts[key] = amounts.get(key, 0) + own
            parent_nested = counts._nested[-1]
            parent_nested[key] = parent_nested.get(key, 0) + d
    return None


def device_cond(pred: torch.Tensor, if_true: Callable[[], None],
                if_false: Callable[[], None],
                names: Tuple[str, str] = ("true", "false")) -> Optional[bool]:
    """``if_true()`` if ``pred`` else ``if_false()``: one host read
    outside capture (returned), two IF nodes under it (on ``pred`` and
    on its negation; None returned)."""
    if not capturing(pred):
        v = bool(_host_value(pred))
        (if_true if v else if_false)()
        return v
    cond = pred if pred.dtype == torch.bool else pred != 0
    device_if(cond, if_true, names[0])
    device_if(~cond, if_false, names[1])
    return None


def tally(key: Key, value, name: Optional[str] = None) -> None:
    """Add ``value`` (an int, or a 0-d integer tensor) to counter ``key``.
    Outside capture it is added now (a tensor is read on the host).
    Under capture with :func:`counting` active: an int is counted per
    replay (or per replay that takes the branch it sits in); a tensor's
    value is added on the device by every replay that reaches it.  Under
    capture with no active counts nothing is counted."""
    if not _capturing_now():
        add_counts({key: int(value)})
        return
    counts = _active()
    if counts is None:
        return
    if isinstance(value, torch.Tensor):
        slot = counts._slot({key: 1}, name or ".".join(key))
        counts._add_device(slot, value)
    else:
        frame = counts._frames[-1]
        frame[key] = frame.get(key, 0) + int(value)
