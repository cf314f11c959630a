"""``hierarchy.contract_s.resparsify``: per cycle, the summed
``hierarchy.contract`` spans (heavy-edge contraction at every level), s."""

from gssbench.readers import per_batch_span_s


def read(run):
    if run.kind != "resparsify":
        return None
    return per_batch_span_s(run, ("hierarchy.contract",))
