"""``device.idle_pct.solve``: the share of the traced window with no
kernel, copy or memset on the card (``torch.profiler``, CUPTI), in %."""

from gssbench.readers import idle_pct


def read(run):
    return idle_pct(run) if run.kind == "closed_batch" else None
