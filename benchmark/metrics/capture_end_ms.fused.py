"""Of the fused run's CUDA graph capture, host ms a run in the capture's
end and the graph's instantiation, both captures
(``nbody.capture.end``)."""

from benchmark.program_spans import host_ms_per_run


def read(r):
    return host_ms_per_run("nbody.capture.end")
