"""What the readers of the program's own spans and counters share
(``nbody_tpu_torch.utils.profiling``: a span records only while the
profiler runs, so the spans are the traced runs'): sums over the spans
of one name, a traced run or a traced step.  A program without spans
(no ``profiling.spans``) has nothing to read: every reader gives None."""

from __future__ import annotations


def records():
    """The program's spans, in the order they started; None where the
    program records none."""
    try:
        from nbody_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return (read() or None) if read is not None else None


def _under(rec, name: str, by_id: dict) -> bool:
    """Whether a span named ``name`` encloses ``rec``."""
    parent = rec.parent
    while parent is not None:
        if by_id[parent].name == name:
            return True
        parent = by_id[parent].parent
    return False


def host_ms_per_run(name: str):
    """Host ms a traced run (``nbody.run`` span) in the spans ``name``;
    None without both."""
    recs = records()
    if recs is None:
        return None
    runs = sum(r.name == "nbody.run" for r in recs)
    picked = [r.host_ms for r in recs if r.name == name]
    return sum(picked) / runs if runs and picked else None


def stream_ms_per_step(r, name: str, outside: str = None):
    """Stream ms a traced step in the spans ``name`` (those not enclosed
    by a span ``outside``); None without such spans or where one has no
    stream time (the CPU)."""
    recs = records()
    if recs is None or not r.traced_steps:
        return None
    by_id = {x.id: x for x in recs}
    picked = [x.stream_ms for x in recs if x.name == name and not (
        outside and _under(x, outside, by_id))]
    if not picked or None in picked:
        return None
    return sum(picked) / r.traced_steps


def counter_per_step(r, name: str, suffix: str):
    """The change of the counters whose name ends in ``suffix`` over the
    counted spans ``name``, a traced step; None without such spans."""
    recs = records()
    if recs is None or not r.traced_steps:
        return None
    picked = [x.counters for x in recs
              if x.name == name and x.counters is not None]
    if not picked:
        return None
    return sum(v for c in picked for k, v in c.items()
               if k.endswith(suffix)) / r.traced_steps
