"""All-pairs gravity and potential: the CUDA kernels K1 and K5
(``csrc/allpairs.cu``) and their plain PyTorch twins.

Counterpart of ``nbody_tpu.ops.allpairs`` (the Pallas
``_allpairs_kernel`` and ``_potential_kernel``).  Semantics: softening 0
gives the naive factoring g*m_j/d^3 (main_approach_1.cpp:53-75),
softening eps the Barnes-Hut factoring g*m_j/(d2*(d+eps))
(project.cu:651-658); d2 > 0 excludes self-pairs and coincident bodies
(their force is defined as 0).  The potential is unsoftened,
-g*m_j/d_ij under (d2 > 0) & (gm > 0).  The kernels K1 and K5 take
d2 >= 2^-126 for d2 > 0, as the TPU does (it flushes subnormals), so
bodies closer than 1.1e-19 count as coincident there.

:func:`allpairs_accelerations_vs` (K1) and :func:`allpairs_potential`
(K5) launch their kernels for CUDA tensors and take the twins only for
CPU tensors; a CUDA tensor a kernel cannot take raises.
``KERNEL_LAUNCHES`` counts K1 launches, ``POTENTIAL_LAUNCHES`` K5
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda

KERNEL_LAUNCHES = 0  # K1
POTENTIAL_LAUNCHES = 0  # K5
# the H100's SMs and thread slots per SM: the slices a target gets fill them
SMS = 132
SM_THREADS = 2048
# K1: threads per block, the targets each thread holds, and the sources of
# one Kahan-chained partial when compensated (allpairs.cu's kApThreads,
# kApTargets, kCompUnit)
ALLPAIRS_THREADS = 256
ALLPAIRS_TARGETS_PER_THREAD = 2
COMP_UNIT = 128
# the share of the card's thread slots K1's sums in flight (Nt x slices)
# must fill, unsoftened / compensated: the fastest slice counts measured at
# N=16,384, 65,536 and 1,048,576 (scripts/allpairs_variants.py, PERF.md)
ALLPAIRS_FILL = 0.475
ALLPAIRS_FILL_COMPENSATED = 0.95
# K5: threads per block, the sources of one tile, whose partial sum enters
# the running sum whole (the TPU kernel's order), and the targets each
# thread holds (allpairs.cu's kPotThreads, kPotTile, kPotTargets)
POTENTIAL_THREADS = 256
POTENTIAL_SOURCE_BLOCK = 1024
POTENTIAL_TARGETS_PER_THREAD = 2
# the thread slices a target may get (K1 and K5), and the blocks one SM is
# counted to hold (__launch_bounds__(256, 4))
ALLPAIRS_SLICES = POTENTIAL_SLICES = (1, 2, 4, 8)
POTENTIAL_WAVE_BLOCKS = 4


def allpairs_accelerations_plain(
    target_positions: torch.Tensor,  # [Nt, D]
    source_positions: torch.Tensor,  # [Ns, D]
    source_masses: torch.Tensor,  # [Ns]
    *,
    g: float,
    softening: float = 0.0,
    source_block: int = 1024,
    compensated: bool = False,
) -> torch.Tensor:
    """The kernel's plain twin: per source tile of ``source_block``, a
    tile sum of w * disp per target, added to the running sum — or, when
    ``compensated``, 128-source partial sums chained with Kahan
    compensation, as the kernel does."""
    from ..physics import _pair_weights

    gm = g * source_masses
    acc = torch.zeros_like(target_positions)
    comp = torch.zeros_like(target_positions)
    for s0 in range(0, source_positions.shape[0], source_block):
        src = source_positions[s0:s0 + source_block]
        disp = src[None, :, :] - target_positions[:, None, :]  # [Nt, SB, D]
        w = _pair_weights((disp * disp).sum(-1), gm[None, s0:s0 + source_block],
                          softening)
        prod = w[:, :, None] * disp
        if not compensated:
            acc = acc + prod.sum(1)
            continue
        for c0 in range(0, prod.shape[1], 128):
            y = prod[:, c0:c0 + 128].sum(1) - comp
            t = acc + y
            comp = (t - acc) - y
            acc = t
    return acc - comp if compensated else acc


def allpairs_units(ns: int, source_block: int, compensated: bool) -> int:
    """The units K1 sums whole on ``ns`` sources: tiles of
    ``source_block``, or with ``compensated`` the ``COMP_UNIT``-source
    chunks of each tile (the last of a tile, and of the array, may be
    shorter)."""
    if not compensated:
        return -(-ns // source_block)
    ulen = min(COMP_UNIT, source_block)
    per_tile = -(-source_block // COMP_UNIT)
    return ns // source_block * per_tile + -(-(ns % source_block) // ulen)


def allpairs_launch_shape(nt: int, ns: int, source_block: int,
                          compensated: bool) -> tuple:
    """K1's launch on ``nt`` targets and ``ns`` sources: (targets per
    thread, slices per target, blocks).  The fewest slices r of
    ``ALLPAIRS_SLICES`` whose Nt x r sums in flight fill the share
    ``ALLPAIRS_FILL`` (``ALLPAIRS_FILL_COMPENSATED``) of the card's thread
    slots (``SMS`` x ``SM_THREADS``), else the most, and never more than
    there are units (:func:`allpairs_units`); a block of
    ``ALLPAIRS_THREADS`` threads holds ALLPAIRS_THREADS / r x
    ``ALLPAIRS_TARGETS_PER_THREAD`` targets.  Every shape sums in the same
    order, so the choice moves time, never bits."""
    units = allpairs_units(ns, source_block, compensated)
    fits = [r for r in ALLPAIRS_SLICES if r <= max(units, 1)]
    fill = ALLPAIRS_FILL_COMPENSATED if compensated else ALLPAIRS_FILL
    r = next((r for r in fits if nt * r >= fill * SMS * SM_THREADS),
             fits[-1])
    tpt = ALLPAIRS_TARGETS_PER_THREAD
    return tpt, r, -(-nt // (ALLPAIRS_THREADS // r * tpt))


def allpairs_target_blocks() -> dict:
    """{targets a block holds: slices per target} of K1's shapes."""
    tpt = ALLPAIRS_TARGETS_PER_THREAD
    return {ALLPAIRS_THREADS // r * tpt: r for r in ALLPAIRS_SLICES}


def allpairs_slices(target_block: int) -> int:
    """The slices per target of a block holding ``target_block`` targets;
    raises for a value no shape has."""
    shapes = allpairs_target_blocks()
    if target_block not in shapes:
        raise ValueError(
            f"target_block={target_block}: K1's blocks hold "
            f"{', '.join(map(str, sorted(shapes)))} targets "
            f"({ALLPAIRS_THREADS} threads, {ALLPAIRS_TARGETS_PER_THREAD} "
            "targets a thread, 1-8 slices a target)")
    return shapes[target_block]


def allpairs_occupancy(dims: int, softening: float = 0.0,
                       compensated: bool = False) -> int:
    """Blocks of K1 (``dims``, softened or not, compensated or not) that
    one SM of the current card holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    n = ctypes.c_int(0)
    _cuda.check(_cuda.library().nbody_allpairs_occupancy(
        dims, int(softening != 0), int(compensated), ALLPAIRS_THREADS,
        ctypes.byref(n)), "allpairs occupancy")
    return n.value


def allpairs_accelerations_vs(
    target_positions: torch.Tensor,  # [Nt, D]
    source_positions: torch.Tensor,  # [Ns, D]
    source_masses: torch.Tensor,  # [Ns]
    *,
    g: float,
    softening: float = 0.0,
    target_block: Optional[int] = None,
    source_block: int = 1024,
    compensated: bool = False,
) -> torch.Tensor:
    """Accelerations [Nt, D] of targets due to sources (the clouds may
    differ; a target present among the sources at bit-equal coordinates
    is self-excluded by the d2 guard).

    On CUDA: kernel K1, whose tile partials of ``source_block`` sources
    enter the sum whole (they fix the bits), with blocks of
    ``target_block`` targets (which fixes the slices per target; default
    :func:`allpairs_launch_shape`'s pick); f32, 2D or 3D, contiguous inputs
    only.  On the CPU: the plain twin."""
    if source_block < 1:
        raise ValueError(f"source_block={source_block}: must be at least 1")
    slices = None if target_block is None else allpairs_slices(target_block)
    if not target_positions.is_cuda:
        return allpairs_accelerations_plain(
            target_positions, source_positions, source_masses, g=g,
            softening=softening, source_block=source_block,
            compensated=compensated,
        )
    global KERNEL_LAUNCHES
    dev = target_positions.device
    nt, dims = target_positions.shape
    ns = source_positions.shape[0]
    if dims not in (2, 3):
        raise ValueError(f"targets have {dims} coordinates; K1 takes 2 or 3")
    _cuda.require(target_positions, "target_positions", torch.float32,
                  (nt, dims), dev)
    _cuda.require(source_positions, "source_positions", torch.float32,
                  (ns, dims), dev)
    _cuda.require(source_masses, "source_masses", torch.float32, (ns,), dev)
    if dims * nt >= 2**31 or (dims + 1) * ns >= 2**31:
        raise ValueError("body counts must fit 32-bit indices")
    if slices is None:
        slices = allpairs_launch_shape(nt, ns, source_block, compensated)[1]
    src = torch.cat([source_positions.t(), g * source_masses[None]])
    # [D + 1, Ns]: x, y, (z,) g*m
    out = torch.empty((nt, dims), dtype=torch.float32, device=dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        code = lib.nbody_allpairs_accel(
            target_positions.data_ptr(), nt, src.data_ptr(), ns,
            out.data_ptr(), float(softening), int(compensated),
            ALLPAIRS_THREADS, slices, source_block, dims,
            _cuda.stream_of(out),
        )
    _cuda.check(code, "allpairs (K1)")
    with _cuda.counter_lock:
        KERNEL_LAUNCHES += 1
    return out


def allpairs_potential_plain(
    positions: torch.Tensor,  # [N, D]
    masses: torch.Tensor,  # [N]
    *,
    g: float,
) -> torch.Tensor:
    """K5's plain twin: ``physics.potential_per_body_chunked`` in f32."""
    from ..physics import potential_per_body_chunked

    return potential_per_body_chunked(positions.float(), masses.float(), g)


def potential_launch_shape(n: int) -> tuple:
    """K5's launch on N bodies: (targets per thread, slices per target,
    blocks).  The fewest slices r of ``POTENTIAL_SLICES`` whose N x r
    sums in flight fill 95% of the card's thread slots (``SMS`` x
    ``SM_THREADS``), else the most; a block of ``POTENTIAL_THREADS``
    threads holds POTENTIAL_THREADS / r x ``POTENTIAL_TARGETS_PER_THREAD``
    targets.  Every shape sums in the same order, so the choice moves
    time, never bits; it depends on N alone."""
    slots = 0.95 * SMS * SM_THREADS
    r = next((r for r in POTENTIAL_SLICES if n * r >= slots),
             POTENTIAL_SLICES[-1])
    tpt = POTENTIAL_TARGETS_PER_THREAD
    return tpt, r, -(-n // (POTENTIAL_THREADS // r * tpt))


def potential_occupancy(dims: int) -> int:
    """Blocks of K5 (``dims``) that one SM of the current card holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    n = ctypes.c_int(0)
    _cuda.check(_cuda.library().nbody_potential_occupancy(
        dims, POTENTIAL_THREADS, ctypes.byref(n)), "potential occupancy")
    return n.value


def allpairs_potential(
    positions: torch.Tensor,  # [N, D]
    masses: torch.Tensor,  # [N]
    *,
    g: float,
) -> torch.Tensor:
    """Per-body gravitational potential phi_i = sum_j -g*m_j/d_ij [N]
    (PE = 0.5 * sum_i m_i * phi_i), unsoftened, guard (d2 > 0) & (gm > 0).

    On CUDA: kernel K5 at the shape :func:`potential_launch_shape` picks
    (per-tile partial sums of ``POTENTIAL_SOURCE_BLOCK`` sources, added in
    tile order); f32 only, 2D or 3D.  On the CPU: the plain twin."""
    if not positions.is_cuda:
        return allpairs_potential_plain(positions, masses, g=g)
    global POTENTIAL_LAUNCHES
    dev = positions.device
    n, dims = positions.shape
    if dims not in (2, 3):
        raise ValueError(f"positions have {dims} coordinates; K5 takes 2 or 3")
    if positions.dtype != torch.float32:
        raise ValueError(
            "allpairs_potential (K5) is f32-only; "
            "physics.potential_energy_scalable keeps float64 on its "
            "chunked precision path")
    _cuda.require(positions, "positions", torch.float32, (n, dims), dev)
    _cuda.require(masses, "masses", torch.float32, (n,), dev)
    if (dims + 1) * n >= 2**31:
        raise ValueError("body counts must fit 32-bit indices")
    slices = potential_launch_shape(n)[1]
    src = torch.cat([positions.t(), g * masses[None]])  # [D + 1, N]
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        code = lib.nbody_allpairs_potential(
            positions.data_ptr(), n, src.data_ptr(), n, out.data_ptr(),
            POTENTIAL_THREADS, slices, dims, _cuda.stream_of(out),
        )
    _cuda.check(code, "allpairs potential (K5)")
    with _cuda.counter_lock:
        POTENTIAL_LAUNCHES += 1
    return out


def allpairs_accelerations(
    positions: torch.Tensor,  # [N, D]
    masses: torch.Tensor,  # [N]
    *,
    g: float,
    softening: float = 0.0,
    target_block: Optional[int] = None,
    source_block: int = 1024,
    compensated: bool = False,
) -> torch.Tensor:
    """Single-cloud O(N^2) accelerations (targets == sources)."""
    return allpairs_accelerations_vs(
        positions, positions, masses, g=g, softening=softening,
        target_block=target_block, source_block=source_block,
        compensated=compensated,
    )
