"""Per-device memory model of the multi-device Barnes-Hut modes, the auto
gate, and the communication model (counterpart of
``nbody_tpu.parallel.memory``: the same arithmetic, kept here so the port
imports nothing of the JAX package).

The reference stages its tree into fast memory only when an analytic
byte count says it fits (``sharedMemSize = treeBytes <= 48KB ? bytes :
0``, project.cu:971-974).  This module is that decision at device-memory
scale: an analytic per-device byte model of what each Barnes-Hut
distribution mode materializes, driving ``make_sharded_step(mode="auto")``
and ``run --mode auto``:

* ``dp_barnes_hut_grouped`` (2D) / ``..._grouped3`` (3D) all_gather the
  whole cloud on every device: source bytes O(N), fastest when it fits;
* ``dp_barnes_hut_sharded`` / ``..._sharded3`` hold a 3-slab ppermute
  window: source bytes O(N/devices).

Both replicate the pyramid, so the gate decides on the source term
against a quarter of the device's memory.  The budget resolves from
``hbm_bytes``, else ``config.hbm_bytes`` (``--hbm-gb``), else the card's
own memory (``torch.cuda.get_device_properties(dev).total_memory``) on a
CUDA device and the JAX package's 16 GiB default elsewhere, so CPU
decisions equal the JAX package's.  The card default is the port's own:
at 80 GB, ``auto`` keeps 2D ``grouped`` up to ~1.3 billion bodies.
"""

from __future__ import annotations

import sys

import torch

from ..config import SimConfig

# The JAX package's default budget (the conservative end of a TPU's
# 16-32 GiB), kept for devices whose memory this module does not read.
HBM_BYTES_DEFAULT = 16 * 1024**3
SOURCE_BUDGET_FRACTION = 0.25  # sources may take this slice of HBM

_F32 = 4

# f32 fields materialized per tree cell per level:
# 2D: packed raw rows [4^l, 8] + finished TreeLevel (mass/comx/comy/count)
# 3D: packed raw rows [8^l, 16] (no separate finished level)
_TREE_FIELDS = {2: 8 + 4, 3: 16}
# f32 per body a mode's source window carries (coords + g*mass; the 2D
# sharded window also rides the Morton code alongside)
_ROW_FIELDS = {2: 4, 3: 5}


def tree_bytes(config: SimConfig) -> int:
    """Replicated implicit-pyramid bytes per device (all levels, root..depth)."""
    dim = config.n_dim
    branch = 2**dim
    depth = config.resolved_max_depth
    cells = (branch ** (depth + 1) - 1) // (branch - 1)
    return cells * _TREE_FIELDS[dim] * _F32


def source_bytes(config: SimConfig, n_devices: int, mode: str) -> int:
    """Per-device *source-body* bytes a mode materializes (excl. tree).

    grouped: the all_gathered cloud, N rows.
    sharded: the 3-slab window [left | own | right] plus its sorted copy
    (the sort cannot alias its input), i.e. 2 * 3 * N/devices rows —
    still O(N/devices) by construction.
    """
    dim = config.n_dim
    rows = _ROW_FIELDS[dim] * _F32
    n = config.n_bodies
    if "sharded" in mode:
        slab = -(-n // n_devices)  # ceil
        window = slab if n_devices == 1 else (2 if n_devices == 2 else 3) * slab
        return 2 * window * rows
    return n * rows


def per_chip_bytes(config: SimConfig, n_devices: int, mode: str) -> int:
    """Total modeled per-device bytes for a Barnes-Hut mode: tree + sources."""
    return tree_bytes(config) + source_bytes(config, n_devices, mode)


def device_memory_bytes(device=None) -> int:
    """The memory of ``device`` the gate budgets: a CUDA card's total
    memory, else ``HBM_BYTES_DEFAULT``."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.get_device_properties(
            torch.device(device)).total_memory
    return HBM_BYTES_DEFAULT


def choose_bh_mode(
    config: SimConfig,
    n_devices: int,
    hbm_bytes: int | None = None,
    verbose: bool = False,
    device=None,
) -> str:
    """Pick grouped vs sharded Barnes-Hut from the memory-fit model:
    grouped whenever the replicated cloud fits the source budget (a
    quarter of the device's memory), sharded otherwise.  ``hbm_bytes=None``
    resolves from ``config.hbm_bytes``, else from ``device``
    (:func:`device_memory_bytes`)."""
    if hbm_bytes is None:
        hbm_bytes = config.hbm_bytes or device_memory_bytes(device)
    suffix = "3" if config.n_dim == 3 else ""
    budget = int(hbm_bytes * SOURCE_BUDGET_FRACTION)
    grouped = per_chip_bytes(config, n_devices, "grouped")
    mode = (
        f"dp_barnes_hut_grouped{suffix}"
        if grouped <= budget
        else f"dp_barnes_hut_sharded{suffix}"
    )
    if verbose:
        sharded = per_chip_bytes(config, n_devices, "sharded")
        print(
            f"memory gate: grouped {grouped/1e6:.1f} MB vs sharded "
            f"{sharded/1e6:.1f} MB per device (budget {budget/1e6:.0f} MB, "
            f"{n_devices} devices) -> {mode}",
            file=sys.stderr,
        )
    return mode


# ---------------------------------------------------------------------------
# Communication model (bytes/step/device per mode)
#
# The reference's per-step staging traffic is the tree H2D every step
# (project.cu:968) and positions D2H every step (project.cu:1010).  Here
# it is the steps' collectives: `collective_inventory` lists every
# collective one step issues with its per-device operand payload (the
# tests and chip_smoke.py hold it to the collectives a step records
# through collectives.RecordingAxis), and `comm_bytes_per_step` turns
# payloads into wire bytes sent per device under ring algorithms.
# ---------------------------------------------------------------------------

_I32 = 4

# packed raw leaf-table fields that ride the pyramid psum
# (ops/tree.leaf_raw -> [4^d, 8] f32; ops/tree3d.leaf_raw_3d -> [8^d, 16])
_RAW_FIELDS = {2: 8, 3: 16}


def _leaf_psum_bytes(config: SimConfig) -> int:
    """Payload of the ONE leaf-table psum that replicates the pyramid."""
    dim = config.n_dim
    depth = config.resolved_max_depth
    return (2**dim) ** depth * _RAW_FIELDS[dim] * _F32


def _slab(config: SimConfig, n_devices: int) -> int:
    """Per-device body-slab length (bodies shard evenly over dp)."""
    return -(-config.n_bodies // n_devices)  # ceil


def collective_inventory(
    config: SimConfig, n_devices: int, mode: str, sp: int = 1
) -> list:
    """Every collective one sharded step issues, as ``(op, payload)``
    pairs where ``payload`` is the per-device operand bytes, one to one
    with the collectives a step issues (``collectives.RecordingAxis``).
    For ``dp2d_allpairs`` ``n_devices`` is the dp axis size and ``sp`` the
    source axis (targets shard over dp; sources stripe over sp).

    Scalar control-plane reductions (root bounds pmin/pmax, the psum'd
    overflow count) are included so the inventory is complete, but they
    are 4-byte payloads — the story is the array terms.
    """
    dim = config.n_dim
    s = _slab(config, n_devices)
    pos = s * dim * _F32
    mass = s * _F32
    inv: list = []
    if mode == "dp_allpairs":
        inv += [("all_gather", pos), ("all_gather", mass)]
    elif mode == "ring_allpairs":
        inv += [("ppermute", pos), ("ppermute", mass)] * (n_devices - 1)
    elif mode == "dp2d_allpairs":
        # bodies shard over dp only; the gather runs once per sp replica
        # (counted once per device); the partial-acc psum rides sp
        inv += [("all_gather", pos), ("all_gather", mass)]
        inv += [("psum", s * dim * _F32)]
    elif mode == "dp_barnes_hut":
        inv += [("pmin", _F32), ("pmax", _F32)] * dim
        inv += [("psum", _leaf_psum_bytes(config))]
        inv += [("psum", _I32)]  # overflow count
    elif mode in ("dp_barnes_hut_grouped", "dp_barnes_hut_grouped3"):
        inv += [("all_gather", pos), ("all_gather", mass)]
        inv += [("psum", _I32)]
    elif mode in ("dp_barnes_hut_sharded", "dp_barnes_hut_sharded3"):
        inv += [("pmin", _F32), ("pmax", _F32)] * dim
        inv += [("psum", _leaf_psum_bytes(config))]
        # halo slabs: own rows [slab, dim+1] f32 + codes [slab] i32,
        # once per neighbour (two for n_dev > 2, one for n_dev == 2)
        halos = 0 if n_devices == 1 else (1 if n_devices == 2 else 2)
        inv += [
            ("ppermute", s * (dim + 1) * _F32),
            ("ppermute", s * _I32),
        ] * halos
        inv += [("psum", _I32)]
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return inv


def comm_bytes_per_step(
    config: SimConfig, n_devices: int, mode: str, sp: int = 1
) -> int:
    """Wire bytes SENT per device per step under ring algorithms:
    all_gather of slab ``s`` over D sends ``(D-1)*s``; psum of payload
    ``p`` sends ``2*p*(D-1)/D`` (reduce-scatter + all-gather); ppermute
    sends its payload once; pmin/pmax modeled as scalar psums.

    This is the number the sharded design's O(N/devices + tree) claim
    is about: grouped's all_gather term grows with N while sharded's
    ppermute term is N/devices and its psum term is the (N-independent)
    leaf table."""
    d = max(n_devices, 1)
    if mode == "dp2d_allpairs":
        sp = max(sp, 1)
        total = 0.0
        for op, p in collective_inventory(config, n_devices, mode, sp):
            if op == "all_gather":
                total += (d - 1) * p
            elif op == "psum":
                total += 2 * p * (sp - 1) / sp
        return int(total)
    total = 0.0
    for op, p in collective_inventory(config, n_devices, mode):
        if op == "all_gather":
            total += (d - 1) * p
        elif op == "ppermute":
            total += p
        else:  # psum / pmin / pmax
            total += 2 * p * (d - 1) / d
    return int(total)
