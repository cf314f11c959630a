"""K7: the float64 residual ``r = b - L x`` of a graph Laplacian over the
graph's own CSR, with each column's mean and norm of ``r`` and the norms of
``b``: the measurement of the service's mixed-precision refinement.

Port-only, as K6b: the reference measures this residual on the host.
:func:`laplacian_residual` launches the hand-written CUDA kernel
(``kernels/csrc/laplacian_residual.cu``, two launches: the rows, then the
fold of their column sums) when its tensors lie on a CUDA device and runs
the plain version (:func:`repro_torch.kernels.ref.laplacian_residual_ref`,
the host's NumPy) when they lie on the CPU.  Each launch adds one to its
count in :data:`repro_torch.kernels._launch.launches`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._launch import count, on_cuda, require, stream


def upload_csr(graph, *, device):
    """``(indptr, adj, adj_w)`` of a Graph's CSR on ``device``, as int32,
    int32 and float32 tensors: K7's operands."""
    if graph.indptr[-1] > np.iinfo(np.int32).max:
        raise ValueError(f"{int(graph.indptr[-1])} CSR entries do not fit "
                         f"K7's int32 offsets")
    return (torch.as_tensor(graph.indptr.astype(np.int32), device=device),
            torch.as_tensor(graph.adj.astype(np.int32), device=device),
            torch.as_tensor(graph.adj_w.astype(np.float32), device=device))


def laplacian_residual(indptr, adj, adj_w, b, x, *, with_b_norm=False):
    """``(r, mean, norm, b_norm)`` for ``b [n, k]`` float32 and ``x [n, k]``
    float64: ``r = b - L x`` in float64, each column's mean and norm of
    ``r``, and the norms of ``b`` when ``with_b_norm`` (else ``None``).  A
    column's outputs do not depend on the other columns, bit for bit."""
    if not on_cuda(indptr, adj, adj_w, b, x):
        return _ref.laplacian_residual_ref(indptr, adj, adj_w, b, x,
                                           with_b_norm)
    from repro_torch.kernels._build import check, library

    require(indptr, "indptr", torch.int32, 1)
    require(adj, "adj", torch.int32, 1)
    require(adj_w, "adj_w", torch.float32, 1)
    require(b, "b", torch.float32, 2)
    require(x, "x", torch.float64, 2)
    n, k = x.shape
    if indptr.shape[0] != n + 1 or adj.shape != adj_w.shape:
        raise ValueError(f"CSR of indptr {tuple(indptr.shape)}, adj "
                         f"{tuple(adj.shape)}, adj_w {tuple(adj_w.shape)} "
                         f"does not fit x {tuple(x.shape)}")
    if b.shape != x.shape:
        raise ValueError(f"b {tuple(b.shape)} != x {tuple(x.shape)}")
    if n == 0 or k == 0:
        raise ValueError(f"K7 takes at least one row and column, got "
                         f"{tuple(x.shape)}")
    lib = library()
    rows = lib.repro_laplacian_residual_rows()
    r = torch.empty_like(x)
    part = torch.empty((-(-n // rows), 3, k), dtype=torch.float64,
                       device=x.device)
    out = torch.empty((3, k), dtype=torch.float64, device=x.device)
    check(lib.repro_laplacian_residual(
        indptr.data_ptr(), adj.data_ptr(), adj_w.data_ptr(), b.data_ptr(),
        x.data_ptr(), r.data_ptr(), part.data_ptr(), n, k, int(with_b_norm),
        stream()), "laplacian_residual")
    count("laplacian_residual")
    check(lib.repro_laplacian_residual_fold(
        part.data_ptr(), out.data_ptr(), n, k, int(with_b_norm), stream()),
        "laplacian_residual_fold")
    count("laplacian_residual_fold")
    return r, out[0], out[1], out[2] if with_b_norm else None
