"""The collectives of the multi-device steps: the port's counterpart of
the ``jax.lax`` collectives inside ``nbody_tpu.parallel.steps``'
shard_map bodies (``all_gather(tiled=True)``, ``psum``, ``pmin``,
``pmax``, ``ppermute``, ``axis_index``).

An axis is one rank's view of one mesh axis, with two implementations
behind one interface:

* :class:`ProcessAxis` — one process per rank over ``torch.distributed``
  (NCCL for CUDA tensors, gloo for CPU tensors): ``all_gather`` into a
  list, ``all_reduce`` with SUM / MIN / MAX, ``batch_isend_irecv`` for
  ``ppermute``.  On NCCL its collectives can be captured into a rank's
  CUDA graph (the fused run's ``StepGraph``) once an eager step has made
  every communicator they use: NCCL makes one lazily, at a group's first
  collective (a sub-group's, a send/recv pair's), which a capture
  cannot hold.  Captured collectives are not tracked by
  ProcessGroupNCCL's watchdog: a rank that stops replaying leaves its
  peers waiting until the launcher (``mesh.spawn``) ends them.
* :class:`ThreadAxis` — D ranks in one process, each a Python thread, on
  one device: a collective meets at a barrier of its
  :class:`ThreadGroup` and combines the ranks' tensors on the device;
  ``psum`` adds in rank order, so its bits are fixed.  The counterpart of
  the JAX package's fake host mesh (its ``tests/conftest.py``): it runs D
  ranks through the real kernels on one card, where they share one
  stream and run one after another.  Its Python barrier cannot be
  captured into a CUDA graph.

:class:`RecordingAxis` wraps either and logs every collective as
``(op, payload bytes)``, the per-rank operand size
``parallel.memory.collective_inventory`` models.

Counters: both axes count each collective they run and its operand's
bytes (the same per-rank size) in this module's ``<OP>_CALLS`` /
``<OP>_BYTES``, summed over the process's ranks, through
``ops._graph.tally``: a collective captured in a rank's CUDA graph counts
once per replay, as a kernel launch does.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, List, Sequence, Tuple

import torch

Perm = Sequence[Tuple[int, int]]  # (source rank, destination rank) pairs

# collectives run and their operands' bytes, by op (module docstring)
ALL_GATHER_CALLS = ALL_GATHER_BYTES = 0
PSUM_CALLS = PSUM_BYTES = 0
PMIN_CALLS = PMIN_BYTES = 0
PMAX_CALLS = PMAX_BYTES = 0
PPERMUTE_CALLS = PPERMUTE_BYTES = 0


def _count(op: str, t: torch.Tensor) -> None:
    from ..ops import _graph

    _graph.tally(("parallel.collectives", f"{op}_CALLS"), 1)
    _graph.tally(("parallel.collectives", f"{op}_BYTES"),
                 t.numel() * t.element_size())


class ThreadGroup:
    """The meeting point of ``size`` thread ranks.  A rank that fails calls
    :meth:`abort`, which breaks every wait of the others (they raise)
    instead of leaving them blocked."""

    def __init__(self, size: int, timeout: float = 1800.0):
        self.size = size
        self._barrier = threading.Barrier(size, timeout=timeout)
        self._slots: List = [None] * size

    def exchange(self, rank: int, value) -> list:
        """Every rank's ``value``, in rank order."""
        self._slots[rank] = value
        self._wait()
        out = list(self._slots)
        self._wait()  # no rank overwrites a slot before all have read it
        return out

    def _wait(self) -> None:
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise RuntimeError(
                "a collective of the thread group was abandoned: another "
                "rank failed") from None

    def abort(self) -> None:
        self._barrier.abort()


class ThreadAxis:
    """Rank ``rank`` of a :class:`ThreadGroup`.  Tensors of all ranks live
    on one device (and, on the card, on its one current stream), so a rank
    may read another's tensor once both have met."""

    capturable = False  # its collectives meet at a Python barrier

    def __init__(self, group: ThreadGroup, rank: int):
        self.group = group
        self.rank = rank
        self.size = group.size

    def axis_index(self) -> int:
        return self.rank

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors concatenated along dim 0, in rank order."""
        _count("ALL_GATHER", t)
        return torch.cat(self.group.exchange(self.rank, t), dim=0)

    def _reduce(self, t: torch.Tensor, op: Callable) -> torch.Tensor:
        return functools.reduce(op, self.group.exchange(self.rank, t))

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        _count("PSUM", t)
        return self._reduce(t, torch.add)  # ((t0 + t1) + t2) + ...

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        _count("PMIN", t)
        return self._reduce(t, torch.minimum)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        _count("PMAX", t)
        return self._reduce(t, torch.maximum)

    def ppermute(self, t: torch.Tensor, perm: Perm) -> torch.Tensor:
        """The tensor of the rank that sends to this one under ``perm``
        (zeros where none does, as ``jax.lax.ppermute``)."""
        _count("PPERMUTE", t)
        parts = self.group.exchange(self.rank, t)
        src = {d: s for s, d in perm}.get(self.rank)
        return torch.zeros_like(t) if src is None else parts[src].clone()


class ProcessAxis:
    """This process's rank in a ``torch.distributed`` process group
    (``None``: the default, world group).  Every rank of the group must
    issue the same collectives in the same order."""

    capturable = True  # on NCCL, into a CUDA graph (module docstring)

    def __init__(self, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def axis_index(self) -> int:
        return self.rank

    def _global(self, group_rank: int) -> int:
        if self.group is None:
            return group_rank
        return self._dist.get_global_rank(self.group, group_rank)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        _count("ALL_GATHER", t)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        self._dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=0)

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        out = t.clone()
        self._dist.all_reduce(out, op=op, group=self.group)
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        _count("PSUM", t)
        return self._all_reduce(t, self._dist.ReduceOp.SUM)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        _count("PMIN", t)
        return self._all_reduce(t, self._dist.ReduceOp.MIN)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        _count("PMAX", t)
        return self._all_reduce(t, self._dist.ReduceOp.MAX)

    def ppermute(self, t: torch.Tensor, perm: Perm) -> torch.Tensor:
        _count("PPERMUTE", t)
        dist = self._dist
        t = t.contiguous()
        dst = {s: d for s, d in perm}.get(self.rank)
        src = {d: s for s, d in perm}.get(self.rank)
        out = torch.zeros_like(t)
        if src == self.rank:
            out.copy_(t)
            src = None
        if dst == self.rank:
            dst = None
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, t, self._global(dst),
                                  self.group))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, out, self._global(src),
                                  self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out


class RecordingAxis:
    """An axis that logs each collective it issues as ``(op, payload
    bytes)`` into ``log`` (a list), then runs it on ``inner``."""

    def __init__(self, inner, log: list):
        self.inner = inner
        self.log = log
        self.group = inner.group
        self.rank = inner.rank
        self.size = inner.size
        self.capturable = inner.capturable

    def axis_index(self) -> int:
        return self.inner.axis_index()

    def _record(self, op: str, t: torch.Tensor) -> None:
        self.log.append((op, t.numel() * t.element_size()))

    def all_gather(self, t):
        self._record("all_gather", t)
        return self.inner.all_gather(t)

    def psum(self, t):
        self._record("psum", t)
        return self.inner.psum(t)

    def pmin(self, t):
        self._record("pmin", t)
        return self.inner.pmin(t)

    def pmax(self, t):
        self._record("pmax", t)
        return self.inner.pmax(t)

    def ppermute(self, t, perm: Perm):
        self._record("ppermute", t)
        return self.inner.ppermute(t, perm)
