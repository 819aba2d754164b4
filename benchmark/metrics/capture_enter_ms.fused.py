"""Of the fused run's CUDA graph capture, host ms a run in
``torch.cuda.graph``'s entry, both captures (``nbody.capture.enter``: a
synchronise, the allocator's cache emptied, the capture begun)."""

from benchmark.program_spans import host_ms_per_run


def read(r):
    return host_ms_per_run("nbody.capture.enter")
