"""repro_torch.solver: the multilevel sparsifier-preconditioned solver.

  * :mod:`repro_torch.solver.hierarchy`  — recursive pdGRASS: sparsify,
    contract, re-sparsify into a multilevel preconditioner chain.
  * :mod:`repro_torch.solver.device_pcg` — batched-RHS PCG preconditioned
    by the Chebyshev-smoothed V-cycle, carried by the CUDA kernels K1-K3.

The cache, request plane and service of the reference are not ported yet.
"""
from repro_torch.solver.device_pcg import (BatchedPCGResult, batched_pcg,
                                           ell_laplacian, make_matvec,
                                           make_solver, make_vcycle)
from repro_torch.solver.hierarchy import (Hierarchy, Level, build_hierarchy,
                                          device_contract,
                                          hierarchy_from_arrays, subgraph)

__all__ = [
    "Hierarchy", "Level", "build_hierarchy", "hierarchy_from_arrays",
    "subgraph", "device_contract",
    "BatchedPCGResult", "batched_pcg", "ell_laplacian", "make_matvec",
    "make_solver", "make_vcycle",
]
