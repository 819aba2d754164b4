"""Of the fused run's CUDA graph capture, host ms a run in the step
traced under capture, both captures (``nbody.capture.trace``)."""

from benchmark.program_spans import host_ms_per_run


def read(r):
    return host_ms_per_run("nbody.capture.trace")
