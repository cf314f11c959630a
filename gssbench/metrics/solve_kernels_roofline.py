"""``solve_kernels_roofline``: the least time of the traced flush's PCG
trips (bytes of the level-0 matvec, one V-cycle and the vector updates at
the hierarchy's shapes, over 3.35 TB/s) over the device time of the work
under its ``solver.solve`` and ``solver.refine`` ranges, in %."""

from gssbench.readers import solve_roofline


def read(run):
    return solve_roofline(run) if run.kind == "closed_batch" else None
