"""Collective operand bytes a rank a step, MB (1e6 B), as replayed: the
change of ``parallel.collectives``' byte counters over the traced runs'
``nbody.replay`` spans on rank 0 (a captured collective counts once a
replay; the eager warm step before the capture is left out)."""

from benchmark.program_spans import counter_per_step


def read(r):
    b = counter_per_step(r, "nbody.replay", "_BYTES")
    return None if b is None else b * 1e-6
