"""``pcg.iters.resparsify``: mean PCG iterations a column on each cycle's
fresh hierarchy: the sparsifier's quality, the paper's second metric."""

from gssbench.readers import mean_iters


def read(run):
    return mean_iters(run) if run.kind == "resparsify" else None
