"""Cells the adaptive engine built below its pyramid a step (the counter
``ops.tree3d.REFINED_CELLS``), its change over the traced runs'
``nbody.run`` spans (a retried step's second build included).  None
where the program keeps no such counter."""

from benchmark.program_spans import counter_per_step, records

COUNTER = "REFINED_CELLS"


def read(r):
    recs = records()
    if recs is None or not any(
            x.name == "nbody.run" and x.counters is not None and any(
                k.endswith(COUNTER) for k in x.counters) for x in recs):
        return None
    return counter_per_step(r, "nbody.run", COUNTER)
