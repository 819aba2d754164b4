"""Launch shape of the all-pairs kernel K1 on an H100 — the port's
analogue of the reference's occupancy model (getOptimalBlockSize,
project.cu:163-217).

The JAX package sizes VMEM tiles for the TPU (nbody_tpu.utils.occupancy);
none of that carries over.  K1 runs one thread per target and stages a
tile of sources in shared memory (16 B each), so its two knobs are:

* ``target_block`` — threads per block.  256, halved to 128 when that
  leaves fewer than four blocks per SM (132 SMs), so small N still
  spreads over the card;
* ``source_block`` — sources staged per tile: 1024 (16 KiB of shared
  memory, well under the 48 KiB a block gets without opting in), or N
  rounded up to 128 when smaller.

These are first choices, not measured optima: the kernel's H100 tuning
is later work (ROADMAP Queue B, K1).
"""

from __future__ import annotations

import dataclasses
import sys

H100_SMS = 132
SMEM_BYTES_PER_SOURCE = 16  # one float4 (x, y, gm, 0)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    target_block: int  # threads per block, one target each
    source_block: int  # sources staged in shared memory per tile
    shared_bytes: int  # shared memory per block
    blocks: int  # blocks in the launch


def allpairs_tiles(n_bodies: int, verbose: bool = False) -> TileConfig:
    """Pick (threads per block, source tile) for K1 at ``n_bodies``."""
    tb = 256
    if -(-n_bodies // tb) < 4 * H100_SMS:
        tb = 128
    sb = min(1024, max(128, -(-n_bodies // 128) * 128))
    cfg = TileConfig(
        target_block=tb,
        source_block=sb,
        shared_bytes=sb * SMEM_BYTES_PER_SOURCE,
        blocks=-(-n_bodies // tb),
    )
    if verbose:
        print(
            f"occupancy[allpairs]: n={n_bodies} -> target_block="
            f"{cfg.target_block} source_block={cfg.source_block} | "
            f"{cfg.blocks} blocks of {cfg.target_block} threads, "
            f"{cfg.shared_bytes / 1024:.0f} KiB shared memory per block",
            file=sys.stderr,
        )
    return cfg


def resolve_tiles(n_bodies: int, target_block=None, source_block=None,
                  verbose: bool = False):
    """Launch shape with explicit override (``None`` = choose)."""
    cfg = allpairs_tiles(n_bodies, verbose=verbose)
    tb = target_block if target_block else cfg.target_block
    sb = source_block if source_block else cfg.source_block
    return tb, sb
