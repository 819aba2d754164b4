"""Launch shape of the all-pairs kernel K1 on an H100 — the port's
analogue of the reference's occupancy model (getOptimalBlockSize,
project.cu:163-217).

The JAX package sizes VMEM tiles for the TPU (nbody_tpu.utils.occupancy);
none of that carries over.  K1 runs fixed 256-thread blocks, each thread
holding two targets and each target getting 1, 2, 4 or 8 thread slices,
and streams its sources through a fixed 8 KiB shared-memory buffer.  Its
two knobs:

* ``source_block`` — the sources of one tile, whose partial sum enters
  the running sum whole, so it fixes the bits: 1024, or N rounded up to
  128 when smaller;
* ``target_block`` — the targets a block holds, 256 / slices x 2 (512,
  256, 128 or 64), so it picks the slices per target and never moves
  bits.  By default ``ops.allpairs.allpairs_launch_shape`` picks the
  fewest slices whose sums in flight fill a share of the card's thread
  slots, the share under which the fastest slice counts were measured at
  N=16,384 to 1,048,576 (PERF.md).
"""

from __future__ import annotations

import dataclasses
import sys

from ..ops import allpairs


@dataclasses.dataclass(frozen=True)
class TileConfig:
    target_block: int  # targets a block holds
    source_block: int  # sources of one tile partial
    targets_per_thread: int
    slices: int  # threads summing each target
    blocks: int  # blocks in the launch


def allpairs_tiles(n_bodies: int, target_block=None, source_block=None,
                   compensated: bool = False,
                   verbose: bool = False) -> TileConfig:
    """K1's launch at ``n_bodies`` (targets = sources), with explicit
    overrides (``None`` = choose); an explicit ``target_block`` must be one
    K1's blocks hold (``ops.allpairs.allpairs_slices`` raises otherwise)."""
    sb = source_block or min(1024, max(128, -(-n_bodies // 128) * 128))
    tpt = allpairs.ALLPAIRS_TARGETS_PER_THREAD
    if target_block:
        r = allpairs.allpairs_slices(target_block)
    else:
        r = allpairs.allpairs_launch_shape(n_bodies, n_bodies, sb,
                                           compensated)[1]
    tb = allpairs.ALLPAIRS_THREADS // r * tpt
    cfg = TileConfig(target_block=tb, source_block=sb,
                     targets_per_thread=tpt, slices=r,
                     blocks=-(-n_bodies // tb))
    if verbose:
        print(
            f"occupancy[allpairs]: n={n_bodies} -> target_block={tb} "
            f"source_block={sb} | {cfg.blocks} blocks of "
            f"{allpairs.ALLPAIRS_THREADS} threads, {tpt} targets a thread, "
            f"{r} slice(s) a target over "
            f"{allpairs.allpairs_units(n_bodies, sb, compensated)} units",
            file=sys.stderr,
        )
    return cfg


def resolve_tiles(n_bodies: int, target_block=None, source_block=None,
                  compensated: bool = False, verbose: bool = False):
    """(target_block, source_block) of :func:`allpairs_tiles`."""
    cfg = allpairs_tiles(n_bodies, target_block, source_block, compensated,
                         verbose)
    return cfg.target_block, cfg.source_block
