"""Of the fused run's CUDA graph capture, host ms a run in the eager
warm step on its side stream and its synchronise
(``nbody.capture.warm``)."""

from benchmark.program_spans import host_ms_per_run


def read(r):
    return host_ms_per_run("nbody.capture.warm")
