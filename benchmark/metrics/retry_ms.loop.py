"""Stream ms a step in the contract loop's 4x-cap re-steps
(``nbody.retry``), over all the traced steps: 0 where the traced runs
retried none."""

from benchmark.program_spans import stream_ms_per_step


def read(r):
    if stream_ms_per_step(r, "nbody.step") is None:
        return None
    return stream_ms_per_step(r, "nbody.retry") or 0.0
