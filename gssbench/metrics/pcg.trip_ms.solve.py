"""``pcg.trip_ms.solve``: the ``solver.solve`` and ``solver.refine`` spans
over the trips of their flushes (the most iterations of any column), ms."""

from gssbench.readers import clean_batches, span_s, trips


def read(run):
    batches = clean_batches(run)
    n_trips = sum(trips(b) for b in batches)
    if run.kind != "closed_batch" or not run.spans or n_trips <= 0:
        return None
    spent = sum(span_s(run, b, ("solver.solve", "solver.refine"))
                for b in batches)
    return spent / n_trips * 1e3
