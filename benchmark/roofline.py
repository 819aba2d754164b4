"""Peaks of the card and the work of a kernel whose work depends only on
its sizes: the least time the card could take for it.

The all-pairs kernel (K1) evaluates every (target, source) pair: per
pair D subtractions, 2D - 1 operations for d2, 3 for g m / d^3 and 2D
for the sums in FP32, and one reciprocal square root on the special
function units (16 a clock on each of 132 SMs).  It reads each target's
and source's coordinates and each source's mass once and writes each
target's acceleration once.  (The counts of ``chip_smoke.py``'s
``PAIR_OPS`` / ``bound()``, kept here so that no later change to the
program moves the yardstick.)
"""

from __future__ import annotations

import subprocess

# NVIDIA's H100 SXM data sheet: FP32 outside the tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
SFU_PER_SM_CLOCK = 16 * 132


def allpairs_ops(dims: int) -> int:
    """FP32 operations a pair of K1 (softening 0)."""
    return 5 * dims + 2


def allpairs_bound_s(targets: int, sources: int, dims: int,
                     sm_clock_hz: float) -> float:
    """Least seconds for one K1 launch over ``targets`` x ``sources``
    float32 pairs: the larger of its FP32 work, its reciprocal square
    roots and its bytes."""
    pairs = targets * sources
    t_ops = max(pairs * allpairs_ops(dims) / PEAK_FP32,
                pairs / (SFU_PER_SM_CLOCK * sm_clock_hz))
    nbytes = 4 * (targets * dims * 2 + sources * (dims + 1))
    return max(t_ops, nbytes / PEAK_BYTES)


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock by ``nvidia-smi`` (0 when it gives
    none)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60).stdout
        return float(out.split()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return 0.0
