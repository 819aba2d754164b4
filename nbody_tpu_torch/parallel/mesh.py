"""Device meshes, state sharding and the rank launcher (counterpart of
``nbody_tpu.parallel.mesh``).

In the JAX package a mesh is one global object and ``shard_map`` runs
the step on every device.  Here each rank runs its own step on its own
slab, so a :class:`Mesh` is one rank's view: its axes (``name ->``
axis of ``collectives``) in mesh order and its device.  Bodies shard
over a 1-D ``"dp"`` axis (the reference's strong and weak scaling,
BASELINE configs 4-5); a 2-D ``("dp", "sp")`` mesh shards the O(N^2)
interaction matrix, targets over dp and sources over sp.

Ranks are processes over ``torch.distributed`` (:func:`make_mesh`,
:func:`make_mesh_2d`, started by :func:`spawn`) or threads of one process
on one device (:func:`thread_meshes`, :func:`thread_meshes_2d`, run by
:func:`run_ranks`).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import uuid
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..state import SimState
from .collectives import ProcessAxis, ThreadAxis, ThreadGroup


@dataclasses.dataclass
class Mesh:
    """One rank's view of a device mesh."""

    axes: Dict[str, object]  # axis name -> this rank's axis, mesh order
    device: torch.device

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.axes)

    @property
    def size(self) -> int:
        n = 1
        for ax in self.axes.values():
            n *= ax.size
        return n

    @property
    def is_root(self) -> bool:
        """Rank 0 of every axis: the rank that writes host outputs."""
        return all(ax.axis_index() == 0 for ax in self.axes.values())


def _process_device() -> torch.device:
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _require_world(n: int) -> None:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group (see spawn); "
            "thread ranks take thread_meshes")
    if dist.get_world_size() != n:
        raise ValueError(
            f"a mesh of {n} devices needs a world of {n} ranks, this one "
            f"has {dist.get_world_size()}")


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "dp") -> Mesh:
    """1-D body-sharding mesh over the process group's world (every rank
    of it; ``n_devices`` must be the world size when given)."""
    import torch.distributed as dist

    _require_world(n_devices if n_devices is not None
                   else dist.get_world_size())
    return Mesh({axis_name: ProcessAxis()}, _process_device())


def make_mesh_2d(dp: int, sp: int,
                 axis_names: Tuple[str, str] = ("dp", "sp")) -> Mesh:
    """2-D interaction-sharding mesh over a world of dp x sp ranks, laid
    out row-major as the JAX package's ``reshape(dp, sp)``: rank
    r = i * sp + j has dp index i and sp index j.  Every rank creates
    every sub-group, in one order, as ``dist.new_group`` requires."""
    import torch.distributed as dist

    _require_world(dp * sp)
    me = dist.get_rank()
    dp_axis = sp_axis = None
    for j in range(sp):  # the dp axis of column j: ranks i * sp + j
        grp = dist.new_group([i * sp + j for i in range(dp)])
        if me % sp == j:
            dp_axis = ProcessAxis(grp)
    for i in range(dp):  # the sp axis of row i: ranks i * sp + j
        grp = dist.new_group([i * sp + j for j in range(sp)])
        if me // sp == i:
            sp_axis = ProcessAxis(grp)
    return Mesh({axis_names[0]: dp_axis, axis_names[1]: sp_axis},
                _process_device())


def thread_meshes(n_devices: int, device, axis_name: str = "dp") -> List[Mesh]:
    """The meshes of ``n_devices`` thread ranks on one ``device``, one per
    rank in rank order (run them with :func:`run_ranks`)."""
    group = ThreadGroup(n_devices)
    return [Mesh({axis_name: ThreadAxis(group, r)}, torch.device(device))
            for r in range(n_devices)]


def thread_meshes_2d(dp: int, sp: int, device,
                     axis_names: Tuple[str, str] = ("dp", "sp")
                     ) -> List[Mesh]:
    """The meshes of dp x sp thread ranks (row-major, as
    :func:`make_mesh_2d`), one per rank in rank order."""
    cols = [ThreadGroup(dp) for _ in range(sp)]
    rows = [ThreadGroup(sp) for _ in range(dp)]
    return [Mesh({axis_names[0]: ThreadAxis(cols[r % sp], r // sp),
                  axis_names[1]: ThreadAxis(rows[r // sp], r % sp)},
                 torch.device(device))
            for r in range(dp * sp)]


def run_ranks(fn: Callable, meshes: List[Mesh], *args) -> list:
    """Run ``fn(mesh, *args)`` for every thread rank, each in its own
    thread; returns the results in rank order.  When a rank raises, the
    others' collectives are broken so they stop, and the first failure is
    raised here."""
    results: list = [None] * len(meshes)
    errors: list = []  # in the order the ranks failed
    lock = threading.Lock()
    groups = {id(ax.group): ax.group for m in meshes
              for ax in m.axes.values()}

    def body(r: int) -> None:
        try:
            results[r] = fn(meshes[r], *args)
        except BaseException as e:  # raised below, in the caller
            with lock:
                errors.append(e)
            for g in groups.values():
                g.abort()

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(len(meshes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]  # the first failure; the others followed from it
    return results


def shard_state(state: SimState, mesh: Mesh,
                axis_name: str = "dp") -> SimState:
    """This rank's contiguous slab of the bodies (time, step and overflow
    replicated), on the mesh's device.  N must divide evenly by the axis
    size."""
    n = state.n_bodies
    ax = mesh.axes[axis_name]
    dp = ax.size
    if n % dp != 0:
        raise ValueError(
            f"n_bodies={n} not divisible by mesh axis {axis_name}={dp}; "
            "choose a body count the device count divides"
        )
    s = n // dp
    sl = slice(ax.axis_index() * s, (ax.axis_index() + 1) * s)

    def take(t):
        return t[sl].contiguous().to(mesh.device)

    return SimState(
        masses=take(state.masses),
        positions=take(state.positions),
        velocities=take(state.velocities),
        time=state.time.clone().to(mesh.device),
        step=state.step.clone().to(mesh.device),
        overflow=state.overflow.clone().to(mesh.device),
    )


def gather_state(state: SimState, mesh: Mesh,
                 axis_name: str = "dp") -> SimState:
    """The global state assembled from every rank's slab (a collective:
    every rank calls it and every rank gets the whole state; rank 0 writes
    the host outputs from it)."""
    ax = mesh.axes[axis_name]
    return SimState(
        masses=ax.all_gather(state.masses),
        positions=ax.all_gather(state.positions),
        velocities=ax.all_gather(state.velocities),
        time=state.time, step=state.step, overflow=state.overflow,
    )


def _rank_main(rank: int, fn: Callable, world: int, init_file: str,
               device_type: str, args: tuple) -> None:
    import torch.distributed as dist

    if device_type == "cuda":
        # before the first launch: a ctypes launch goes to the calling
        # thread's current device
        torch.cuda.set_device(rank)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (),
          device_type: str = "cpu", init_dir: str = ".") -> None:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes, joined in one
    process group (NCCL on ``device_type="cuda"``, rank r on card r; gloo
    on the CPU), rendezvousing through a file in ``init_dir`` (no port).
    ``fn`` must be importable by name.  A rank's exception is raised
    here."""
    import torch.multiprocessing as mp

    os.makedirs(init_dir, exist_ok=True)
    init_file = os.path.join(os.path.abspath(init_dir),
                             f".nbody_pg_{os.getpid()}_{uuid.uuid4().hex}")
    try:
        mp.spawn(_rank_main,
                 args=(fn, world, init_file, device_type, tuple(args)),
                 nprocs=world, join=True)
    finally:
        if os.path.exists(init_file):
            os.remove(init_file)
