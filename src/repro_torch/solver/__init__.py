"""repro_torch.solver: the multilevel sparsifier-preconditioned solver
service of the port.

  * :mod:`repro_torch.solver.hierarchy`  — recursive pdGRASS: sparsify,
    contract, re-sparsify into a multilevel preconditioner chain.
  * :mod:`repro_torch.solver.device_pcg` — batched-RHS PCG preconditioned
    by the Chebyshev-smoothed V-cycle, carried by the CUDA kernels K1-K3
    (``matvec_impl="fused"``) or K5 (``"kernel"``).
  * :mod:`repro_torch.solver.cache`      — content-hash-keyed artifact
    cache (in-memory LRU + bounded on-disk tier).
  * :mod:`repro_torch.solver.requests`   — the request plane: GraphStore /
    GraphHandle, SolveRequest, SolveTicket futures.
  * :mod:`repro_torch.solver.service`    — the request/response engine: a
    mixed-config scheduler groups pending work by (graph fingerprint,
    config fingerprint) and slot-batches each group's right-hand sides.
  * :mod:`repro_torch.solver.sharded`    — the mesh-sharded solve plane:
    row-sharded batched PCG and V-cycle over a
    :class:`repro_torch.launch.Mesh` (``make_solver(mesh=...)``,
    ``SolverService(mesh=...)``).
"""
from repro_torch.solver.cache import (LRUCache, artifact_key,
                                      content_fingerprint, graph_fingerprint,
                                      pipeline_fingerprint)
from repro_torch.solver.device_pcg import (BatchedPCGResult, batched_pcg,
                                           ell_laplacian, make_matvec,
                                           make_solver, make_vcycle)
from repro_torch.solver.hierarchy import (Hierarchy, Level, build_hierarchy,
                                          device_contract,
                                          hierarchy_from_arrays,
                                          sharded_contract, subgraph)
from repro_torch.solver.requests import (AdmissionError,
                                         DeadlineExceededError, GraphHandle,
                                         GraphStore, SolveRequest,
                                         SolveResponse, SolveTicket)
from repro_torch.solver.service import SolverService
from repro_torch.solver.sharded import make_sharded_solver, shard_ell_slabs

__all__ = [
    "Hierarchy", "Level", "build_hierarchy", "hierarchy_from_arrays",
    "subgraph", "device_contract", "sharded_contract",
    "BatchedPCGResult", "batched_pcg", "ell_laplacian", "make_matvec",
    "make_solver", "make_vcycle",
    "LRUCache", "artifact_key", "content_fingerprint", "graph_fingerprint",
    "pipeline_fingerprint",
    "AdmissionError", "DeadlineExceededError", "GraphHandle", "GraphStore",
    "SolveRequest", "SolveResponse", "SolveTicket", "SolverService",
    "make_sharded_solver", "shard_ell_slabs",
]
