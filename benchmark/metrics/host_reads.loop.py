"""Host reads of a tensor value a step (``ops._graph.HOST_READS``: the
gates' reads and the loop's overflow count), its change over the traced
runs' ``nbody.run`` spans."""

from benchmark.program_spans import counter_per_step


def read(r):
    return counter_per_step(r, "nbody.run", "HOST_READS")
