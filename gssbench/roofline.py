"""Bytes of the solve's device work, and the card's peak bandwidth.

:data:`HBM_BW`, :func:`spmv_batched_launch`, :func:`fused_smoother_bytes`,
:func:`fused_restrict_residual_bytes` and :func:`vcycle_bytes_fused` are
frozen copies of the functions of the same names in
``src/repro_torch/launch/roofline.py`` (as of the port's fourteenth
slice): HBM3 at 3.35 TB/s from NVIDIA's data sheet of the H100 SXM,
float32 data and int32 indices.  :func:`pcg_trip_bytes` is the benchmark's
own count of one PCG trip.

The counts come from shapes (the level-0 graph and the hierarchy's
levels), not from launches or kernel names, so they read the same work
whatever implements it.
"""
from __future__ import annotations

HBM_BW = 3.35e12           # bytes/s, H100 SXM HBM3

_F32 = 4
_I32 = 4


def spmv_batched_launch(n: int, L: int, k: int, nx: int = None):
    """``y[n, k] = A x`` with ``x [nx, k]``: the ELL slabs, ``x`` and ``y``
    once each; a multiply and an add a stored entry a column."""
    nx = n if nx is None else nx
    return n * L * (_I32 + _F32) + nx * k * _F32 + n * k * _F32, \
        2 * n * L * k


def fused_smoother_bytes(n: int, ell_width: int, k: int,
                         cheby_degree: int = 3, with_guess: bool = False,
                         dtype_bytes: int = 4, idx_bytes: int = 4) -> int:
    """One fused Chebyshev sweep: slab, diagonal and ``r`` (and the
    initial iterate on post-smooth sweeps) read once, ``z`` written once,
    whatever the degree."""
    del cheby_degree  # documents the degree independence
    slab = n * ell_width * (idx_bytes + dtype_bytes)
    vecs = (2 + (1 if with_guess else 0)) * n * k * dtype_bytes
    diag = n * dtype_bytes
    return slab + vecs + diag


def fused_restrict_residual_bytes(n: int, ell_width: int, k: int,
                                  n_coarse: int, dtype_bytes: int = 4,
                                  idx_bytes: int = 4) -> int:
    """One fused restrict + residual pass, ``rc = segment_sum(r - L z,
    agg)``: slab, agg, ``r`` and ``z`` read, ``[n_coarse, k]`` written."""
    slab = n * ell_width * (idx_bytes + dtype_bytes)
    vecs = 2 * n * k * dtype_bytes
    agg = n * idx_bytes
    out = n_coarse * k * dtype_bytes
    return slab + vecs + agg + out


def vcycle_bytes_fused(level_triples, k: int, cheby_degree: int = 3,
                       dtype_bytes: int = 4) -> int:
    """One fused V-cycle over ``level_triples = [(n, ell_width,
    n_coarse)]``: a pre-smooth, a restrict + residual, the prolongation
    gather-add and a post-smooth a level.  The coarsest dense solve is
    left out."""
    total = 0
    for n, width, nc in level_triples:
        total += fused_smoother_bytes(n, width, k, cheby_degree,
                                      with_guess=False,
                                      dtype_bytes=dtype_bytes)
        total += fused_restrict_residual_bytes(n, width, k, nc,
                                               dtype_bytes=dtype_bytes)
        total += (nc * k + 2 * n * k) * dtype_bytes    # prolong gather-add
        total += fused_smoother_bytes(n, width, k, cheby_degree,
                                      with_guess=True,
                                      dtype_bytes=dtype_bytes)
    return total


def pcg_trip_bytes(n: int, ell_width: int, k: int, level_triples) -> int:
    """Least bytes of one PCG trip on an ``[n, k]`` batch: the level-0
    matvec, one V-cycle, and the trip's vector updates (``x``, ``p``,
    ``r``, ``A p`` and ``z`` read once, ``x``, ``r`` and ``p`` written once,
    the three column reductions folded into those passes)."""
    spmv, _ = spmv_batched_launch(n, ell_width, k)
    updates = 8 * n * k * _F32
    return spmv + vcycle_bytes_fused(level_triples, k) + updates
