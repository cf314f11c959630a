"""ELL spmv for Laplacian matvecs: the single-column kernel K5 and the host
ELL slab layout of a graph Laplacian.

The port of ``repro.kernels.spmv_ell``.  :func:`spmv_ell` launches the
hand-written CUDA kernel (``kernels/csrc/spmv_ell.cu``) when its tensors lie
on a CUDA device and runs the plain version
(:func:`repro_torch.kernels.ref.spmv_ell_ref`) when they lie on the CPU.
Each launch adds one to its count in
:data:`repro_torch.kernels._launch.launches`.  It backs
``matvec_impl="kernel"``, which runs it once per right-hand-side column;
the batched kernel K1 in :mod:`repro_torch.kernels.vcycle_fused` carries
the default solve.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._launch import (count, on_cuda, require, slabs,
                                         stream)


def spmv_ell(idx, val, x):
    """``y[i] = sum_l val[i, l] * x[idx[i, l]]`` for ``x [nx]``,
    ``nx >= n``; ``[n]`` out."""
    if not on_cuda(idx, val, x):
        return _ref.spmv_ell_ref(idx, val, x)
    from repro_torch.kernels._build import check, library

    n, L = slabs(idx, val)
    require(x, "x", torch.float32, 1)
    if x.shape[0] < n:
        raise ValueError(f"x has {x.shape[0]} rows, the slab {n}")
    y = torch.empty((n,), dtype=torch.float32, device=x.device)
    check(library().repro_spmv_ell(idx.data_ptr(), val.data_ptr(),
                                   x.data_ptr(), y.data_ptr(), n, L,
                                   stream()), "spmv_ell")
    count("spmv_ell")
    return y


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
