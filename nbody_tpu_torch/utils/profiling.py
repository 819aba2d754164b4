"""Profiling hooks (counterpart of ``nbody_tpu.utils.profiling``).

The reference's profiling is chrono bracketing plus static ptxas
register counts (project.cu:71-73).  Here the two-tier Stopwatch /
RunTiming (``utils.timing``) is the chrono analogue, and this module adds
``torch.profiler`` (host ops and, on the card, CUDA kernels) as the
deep-inspection tier.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace around a code block, written to
    ``log_dir`` for TensorBoard or Perfetto when the block ends:

        with profiling.trace("traces/run"):
            sim.run_scan(10)

    The CUDA activity is traced where the card is available.  Yields the
    profiler (``key_averages()`` sums its events by name)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """A named region, visible in profiler traces."""
    return torch.profiler.record_function(name)
