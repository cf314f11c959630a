"""``pipeline.sparsify_s.resparsify``: per cycle, the summed
``hierarchy.sparsify`` spans (the pdGRASS pipeline at every level), s."""

from gssbench.readers import per_batch_span_s


def read(run):
    if run.kind != "resparsify":
        return None
    return per_batch_span_s(run, ("hierarchy.sparsify",))
