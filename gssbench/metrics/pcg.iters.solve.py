"""``pcg.iters.solve``: mean PCG iterations a column (``SolveResponse.iters``,
refinement passes included) in a solve cell."""

from gssbench.readers import mean_iters


def read(run):
    return mean_iters(run) if run.kind == "closed_batch" else None
