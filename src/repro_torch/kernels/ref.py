"""Plain PyTorch versions of the hand-written CUDA kernels.

Each function computes exactly what its kernel computes, in the same
operation order: the CPU tests run them, the wrappers in
:mod:`repro_torch.kernels.vcycle_fused` take them for CPU tensors, and
``chip_smoke.py`` holds each kernel against its plain version on the card.

The ELL sums run over ``l`` in order, one rounded multiply and one rounded
add per term; the kernels are built without FMA contraction, so K1 and its
plain version agree bit for bit on the card.
"""
from __future__ import annotations

import torch


def spmv_ell_batched_ref(idx, val, x):
    """``y[i, j] = sum_l val[i, l] * x[idx[i, l], j]``, summed in l order.

    ``x`` is ``[nx, k]`` with ``nx >= n``; the result is ``[n, k]``."""
    n, L = idx.shape
    idx_l = idx.long()
    acc = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    for l in range(L):
        acc = acc + val[:, l, None] * x[idx_l[:, l]]
    return acc


def cheby_step_ref(idx, val, inv_d, r, z_prev, p, *, first: bool,
                   theta: float, c1: float = 0.0, c2: float = 0.0):
    """One step of the Chebyshev recurrence; returns ``(p, z)``.

    ``theta`` divides as a 0-dim f32 tensor on ``r``'s device: a true
    division, as the kernel does (a CUDA division by a Python scalar
    multiplies by its reciprocal instead)."""
    theta = torch.full((), theta, dtype=r.dtype, device=r.device)
    res = r if z_prev is None else r - spmv_ell_batched_ref(idx, val, z_prev)
    dres = inv_d[:, None] * res
    p = dres / theta if first else c1 * p + c2 * dres
    z = p if z_prev is None else z_prev + p
    return p, z


def restrict_residual_ref(idx, val, perm, agg_ptr, agg_max: int, r, z):
    """``rc[c] = sum over the members i of aggregate c, ascending, of
    (r - A z)[i]`` — ``segment_sum(r - A z, agg)`` in its sequential order.

    ``perm``/``agg_ptr`` are the aggregate CSR; ``agg_max`` its largest
    aggregate (the loop bound, fixed at hierarchy build)."""
    resid = r - spmv_ell_batched_ref(idx, val, z)
    start = agg_ptr[:-1].long()
    counts = agg_ptr[1:].long() - start
    perm_l = perm.long()
    out = torch.zeros((counts.shape[0], r.shape[1]), dtype=r.dtype,
                      device=r.device)
    for t in range(agg_max):
        live = counts > t
        pos = torch.where(live, start + t, 0)
        out = torch.where(live[:, None], out + resid[perm_l[pos]], out)
    return out
