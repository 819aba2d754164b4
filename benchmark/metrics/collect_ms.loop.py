"""Stream ms a step in the groups and the collector (``nbody.collect``:
the dense collector, or the gather walk), the re-steps' spans left out
(``retry_ms.loop``): the device's wall time across the stage, its
kernels and its idle while the host dispatches."""

from benchmark.program_spans import stream_ms_per_step


def read(r):
    return stream_ms_per_step(r, "nbody.collect", outside="nbody.retry")
