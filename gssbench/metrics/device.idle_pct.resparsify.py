"""``device.idle_pct.resparsify``: the share of the traced window with no
kernel, copy or memset on the card (``torch.profiler``, CUPTI), in %."""

from gssbench.readers import idle_pct


def read(run):
    return idle_pct(run) if run.kind == "resparsify" else None
