"""``service.residual_ms.solve``: per flush, the summed ``solver.residual``
spans (the service's float64 residuals and their column norms, on the
host while the card idles), in ms.  ``None`` where the program has no
such span."""

from gssbench.readers import per_batch_span_s

SPAN = "solver.residual"


def read(run):
    if run.kind != "closed_batch" or \
            not any(e["name"] == SPAN for e in run.spans):
        return None
    spent = per_batch_span_s(run, (SPAN,))
    return None if spent is None else spent * 1e3
