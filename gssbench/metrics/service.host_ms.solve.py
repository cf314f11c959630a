"""``service.host_ms.solve``: per flush, the ``solver.flush`` span less its
``solver.solve`` and ``solver.refine`` spans (the service's host work:
grouping, staging, the float64 residuals), in ms."""

from gssbench.readers import per_batch_span_s


def read(run):
    flush = per_batch_span_s(run, ("solver.flush",))
    if flush is None:
        return None
    device = per_batch_span_s(run, ("solver.solve", "solver.refine"))
    return (flush - device) * 1e3
