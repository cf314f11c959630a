"""ELL slab layout of a graph Laplacian, built on the host.

The port of ``repro.kernels.spmv_ell.to_ell``.  The single-column Pallas
kernel of that module (``spmv_ell``, K5) is not ported yet; the batched
kernel K1 in :mod:`repro_torch.kernels.vcycle_fused` covers the solve.
"""
from __future__ import annotations

import numpy as np
import torch


def to_ell(graph, dtype=torch.float32, *, device="cuda"):
    """Laplacian of a Graph in ELL [n, L] layout, as tensors on ``device``.

    Layout per row v: the -w neighbor entries, then the diagonal (weighted
    degree, summed in float64), then padding slots that gather the row's
    own x with val = 0.  Bit-equal to the reference's host ``to_ell``.
    """
    n = graph.n
    deg = np.diff(graph.indptr).astype(np.int64)
    L = int(deg.max()) + 1 if n else 1  # +1 for the diagonal
    rows = np.repeat(np.arange(n), deg)
    slot = np.arange(deg.sum()) - np.repeat(graph.indptr[:-1], deg)
    idx = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, L)).copy()
    val = np.zeros((n, L), dtype=np.float64)
    idx[rows, slot] = graph.adj
    val[rows, slot] = -graph.adj_w.astype(np.float64)
    wdeg = np.zeros(n, dtype=np.float64)
    np.add.at(wdeg, rows, graph.adj_w.astype(np.float64))
    val[np.arange(n), deg] = wdeg
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(val.astype(np.float32), device=device).to(dtype))
