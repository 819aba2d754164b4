"""Stream ms a step in the adaptive engine's refinement (``nbody.refine``,
inside ``nbody.tree``: the sparse levels below the pyramid, their sizes
read on the host and their sums), the re-steps' spans left out: the
device's wall time across the build, its kernels and its idle while the
host dispatches them.  None where the program has no such span."""

from benchmark.program_spans import stream_ms_per_step


def read(r):
    return stream_ms_per_step(r, "nbody.refine", outside="nbody.retry")
