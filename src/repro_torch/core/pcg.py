"""Preconditioned conjugate gradient — the paper's downstream quality metric.

Sparsifier quality is measured by the PCG iteration count when using the
sparsifier Laplacian L_P as a preconditioner to solve L_G x = b to
``||L_G x - b|| <= tol * ||b||`` (paper: tol = 1e-3).

The port of ``repro.core.pcg``.  Two implementations:
  * :func:`pcg_host` — scipy CSR matvec + sparse LU of the grounded L_P
    (equivalent to MATLAB's ``pcg(..., M)`` direct preconditioner solve),
    as the reference has it.  Used by :func:`quality_iters`.
  * :func:`pcg_torch` — the reference's ``pcg_jax`` in PyTorch: dense PCG
    with a dense Cholesky preconditioner, for small graphs.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class PCGResult(NamedTuple):
    x: np.ndarray
    iters: int
    relres: float
    converged: bool


def _ground(mat, idx: int = 0):
    """Remove row/col ``idx`` (grounding a node makes the Laplacian SPD)."""
    keep = np.ones(mat.shape[0], dtype=bool)
    keep[idx] = False
    return mat[keep][:, keep]


def pcg_host(L_G, b: np.ndarray, L_P=None, tol: float = 1e-3,
             maxiter: int = 10_000) -> PCGResult:
    """Host PCG on the grounded system; L_P preconditioner via sparse LU."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    A = _ground(sp.csr_matrix(L_G)).tocsc()
    bg = np.asarray(b, dtype=np.float64)[1:]
    if L_P is not None:
        M = spla.splu(sp.csc_matrix(_ground(sp.csr_matrix(L_P))))
        msolve: Callable = M.solve
    else:
        msolve = lambda r: r  # noqa: E731

    x = np.zeros_like(bg)
    r = bg - A @ x
    z = msolve(r)
    p = z.copy()
    rz = float(r @ z)
    bnorm = float(np.linalg.norm(bg))
    if bnorm == 0:
        return PCGResult(x, 0, 0.0, True)
    for it in range(1, maxiter + 1):
        Ap = A @ p
        alpha = rz / float(p @ Ap)
        x += alpha * p
        r -= alpha * Ap
        relres = float(np.linalg.norm(r)) / bnorm
        if relres <= tol:
            full = np.concatenate([[0.0], x])
            return PCGResult(full, it, relres, True)
        z = msolve(r)
        rz_new = float(r @ z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    full = np.concatenate([[0.0], x])
    return PCGResult(full, maxiter, relres, False)


def pcg_torch(A, b, M_chol=None, tol: float = 1e-3, maxiter: int = 10_000):
    """Dense PyTorch PCG on a grounded SPD system.  Returns
    ``(x, iters, relres)``: ``x`` a tensor on ``b``'s device, ``iters`` an
    int, ``relres`` a 0-dim tensor.

    The port of the reference's ``pcg_jax``: the same recurrence and stop
    test, in ``b``'s dtype.  ``M_chol`` is the lower Cholesky factor of the
    (grounded) preconditioner; the solve is two triangular substitutions.
    The loop tests its condition on the host every trip (the reference's
    ``lax.while_loop``).
    """
    bnorm = torch.linalg.vector_norm(b)

    if M_chol is None:
        def msolve(r):
            return r
    else:
        def msolve(r):
            y = torch.linalg.solve_triangular(M_chol, r[:, None],
                                              upper=False)
            return torch.linalg.solve_triangular(M_chol.T, y,
                                                 upper=True)[:, 0]

    x = torch.zeros_like(b)
    r = b
    p = msolve(r)
    rz = r @ p
    it = 0
    while bool(torch.linalg.vector_norm(r) > tol * bnorm) and it < maxiter:
        Ap = A @ p
        alpha = rz / (p @ Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = msolve(r)
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return x, it, torch.linalg.vector_norm(r) / bnorm


def quality_iters(graph, sparsifier, tol: float = 1e-3, seed: int = 0,
                  maxiter: int = 10_000) -> int:
    """Paper's quality metric: PCG iterations with L_P as preconditioner."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(graph.n)
    b -= b.mean()  # keep b in range(L_G)
    res = pcg_host(graph.laplacian(), b, sparsifier.laplacian(),
                   tol=tol, maxiter=maxiter)
    return res.iters
