"""``pipeline.prepare_s.resparsify``: per cycle, the summed
``pipeline.prepare`` spans at every level (the tree, binary lifting,
scores and grouping; synced, so their device work is inside), in s.
``None`` where the program has no such span."""

from gssbench.readers import per_batch_span_s

SPAN = "pipeline.prepare"


def read(run):
    if run.kind != "resparsify" or \
            not any(e["name"] == SPAN for e in run.spans):
        return None
    return per_batch_span_s(run, (SPAN,))
