"""Stream ms a step in the tables, the evaluator kernel and the un-sort
(``nbody.eval``), the re-steps' spans left out (``retry_ms.loop``): the
device's wall time across the stage, its kernels and its idle while the
host dispatches."""

from benchmark.program_spans import stream_ms_per_step


def read(r):
    return stream_ms_per_step(r, "nbody.eval", outside="nbody.retry")
