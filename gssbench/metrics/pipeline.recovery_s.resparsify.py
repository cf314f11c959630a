"""``pipeline.recovery_s.resparsify``: per cycle, the summed
``pipeline.recovery`` spans at every level (off-tree edge recovery, the
paper's own runtime; synced, so its device work is inside), in s.
``None`` where the program has no such span."""

from gssbench.readers import per_batch_span_s

SPAN = "pipeline.recovery"


def read(run):
    if run.kind != "resparsify" or \
            not any(e["name"] == SPAN for e in run.spans):
        return None
    return per_batch_span_s(run, (SPAN,))
