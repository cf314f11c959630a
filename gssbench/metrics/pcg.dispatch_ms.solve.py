"""``pcg.dispatch_ms.solve``: the ``pcg.loop`` spans less their
``pcg.wait`` spans (the host issuing the PCG's trips, not waiting at its
test of "all done"), over the trips of their flushes as
``pcg.trip_ms.solve`` counts them, in ms.  ``None`` where the program has
no such span."""

from gssbench.readers import clean_batches, span_s, trips


def read(run):
    batches = clean_batches(run)
    n_trips = sum(trips(b) for b in batches)
    if run.kind != "closed_batch" or n_trips <= 0 or \
            not any(e["name"] == "pcg.loop" for e in run.spans):
        return None
    spent = sum(span_s(run, b, ("pcg.loop",)) - span_s(run, b, ("pcg.wait",))
                for b in batches)
    return spent / n_trips * 1e3
