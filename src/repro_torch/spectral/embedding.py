"""Fiedler vectors and k-dimensional spectral embeddings on the solver.

The port of ``repro.spectral.embedding``.  SF-GRASS (arXiv 2008.07633)
motivates spectral embeddings as the quality-defining application of a
sparsifier: the smallest nontrivial Laplacian eigenpairs drive
partitioning, clustering, and drawing.  This module computes them as a
*thin consumer* of the solver service — block inverse power iteration
where every "apply ``L^+``" is one batched service solve against the
cached V-cycle-preconditioned PCG (on the service's device), so the
existing hierarchy is the only preconditioner involved.

The iteration (host-orchestrated, f64):

  1. start from a seeded random block, deflated against the all-ones
     nullspace vector and orthonormalized;
  2. solve ``L Y = X`` through the service (one ``[n, k]`` request — one
     flush group), re-deflate, re-orthonormalize;
  3. Rayleigh-Ritz: diagonalize the small projected operator
     ``Q^T L Q`` and rotate the block onto the Ritz vectors (this is the
     LOBPCG-style acceleration — clustered eigenvalues converge as a
     subspace, not one by one);
  4. stop when every column's residual ``||L v - θ v||`` (``v`` unit) is
     under ``tol``.

Deflation against ones is exact by construction: the service centers
every solution into ``range(L)``, and the host loop re-centers after each
orthonormalization, so the trivial eigenvector can never re-enter the
block through round-off.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.obs import get_tracer
from repro_torch.solver.requests import GraphHandle, SolveRequest
from repro_torch.spectral.resistance import _service_of


@dataclasses.dataclass(frozen=True)
class EmbeddingResult:
    """``k`` smallest nontrivial Laplacian eigenpairs (approximate).

    Attributes:
      vectors:     ``[n, k]`` orthonormal, mean-zero Ritz vectors
                   (ascending eigenvalue order; column 0 is the Fiedler
                   vector).
      values:      ``[k]`` Ritz values ``θ_j ≈ λ_{j+1}(L)``.
      residuals:   ``[k]`` final ``||L v_j - θ_j v_j||_2`` (unit ``v_j``).
      iterations:  outer inverse-iteration steps taken.
      solve_iters: total PCG iterations across all service solves.
      converged:   every residual ≤ the requested tolerance.
    """

    vectors: np.ndarray
    values: np.ndarray
    residuals: np.ndarray
    iterations: int
    solve_iters: int
    converged: bool


def spectral_embedding(svc, graph: Union[Graph, GraphHandle], k: int = 2, *,
                       tol: float = 1e-4, max_iterations: int = 100,
                       solve_tol: float = 1e-8, seed: int = 0,
                       oversample: int = 2, pipeline=None,
                       result_timeout: Optional[float] = None,
                       **submit_kw) -> EmbeddingResult:
    """The ``k``-dimensional spectral embedding of ``graph`` via the
    service's V-cycle-preconditioned solver.

    ``oversample`` extra block columns are iterated and discarded — the
    standard guard for clustered trailing eigenvalues (the block converges
    at the gap *past* the oversampled columns).  ``svc`` may be a
    :class:`~repro_torch.solver.service.SolverService` or a
    :class:`~repro_torch.serve.solver_daemon.SolverDaemon` (``submit_kw``
    forwards e.g. ``tenant=``); ``pipeline`` picks the sparsifier config
    backing the preconditioner per request.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    service, submit = _service_of(svc)
    handle = service.register(graph)
    g = handle.graph
    n = g.n
    kb = min(k + max(int(oversample), 0), n - 1)
    if k > n - 1:
        raise ValueError(
            f"k={k} nontrivial eigenpairs do not exist on {n} vertices")
    metrics = service.metrics
    tracer = get_tracer()

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, kb))
    X -= X.mean(axis=0)
    X, _ = np.linalg.qr(X)
    theta = np.zeros(kb)
    resid = np.full(kb, np.inf)
    solve_iters = 0
    it = 0

    with tracer.span("spectral.embedding", n=n, k=k, block=kb) as sp:
        for it in range(1, max_iterations + 1):
            ticket = submit(SolveRequest(graph=handle,
                                         b=X.astype(np.float32),
                                         tol=solve_tol, pipeline=pipeline),
                            **submit_kw)
            res = ticket.result(result_timeout) if result_timeout \
                is not None else ticket.result()
            solve_iters += int(np.sum(res.iters))
            Y = np.asarray(res.x, dtype=np.float64)
            Y -= Y.mean(axis=0)
            Q, _ = np.linalg.qr(Y)
            Q -= Q.mean(axis=0)
            LQ = g.laplacian_matvec(Q)
            A = Q.T @ LQ
            theta, S = np.linalg.eigh(0.5 * (A + A.T))
            X = Q @ S
            R = LQ @ S - X * theta[None, :]
            resid = np.linalg.norm(R, axis=0) / np.maximum(
                np.linalg.norm(X, axis=0), np.finfo(np.float64).tiny)
            if np.all(resid[:k] <= tol):
                break
        converged = bool(np.all(resid[:k] <= tol))
        sp.set(iterations=it, converged=converged,
               max_residual=float(resid[:k].max()))
    metrics.inc("spectral.embedding.runs")
    metrics.observe("spectral.embedding.iterations", it)
    metrics.observe("spectral.embedding.solve_iters", solve_iters)
    if not converged:
        metrics.inc("spectral.embedding.unconverged")
    return EmbeddingResult(
        vectors=X[:, :k], values=theta[:k].copy(),
        residuals=resid[:k].copy(), iterations=it,
        solve_iters=solve_iters, converged=converged)


def fiedler_vector(svc, graph: Union[Graph, GraphHandle], *,
                   tol: float = 1e-4, max_iterations: int = 100,
                   solve_tol: float = 1e-8, seed: int = 0, pipeline=None,
                   **kw) -> Tuple[float, np.ndarray]:
    """``(λ₂, v₂)`` — the algebraic connectivity and Fiedler vector.

    A ``k=1`` :func:`spectral_embedding` (with the default oversampling,
    so near-degenerate λ₂ ≈ λ₃ spectra still converge as a subspace).
    The vector is unit-norm and mean-zero; its sign is arbitrary.
    """
    out = spectral_embedding(svc, graph, k=1, tol=tol,
                             max_iterations=max_iterations,
                             solve_tol=solve_tol, seed=seed,
                             pipeline=pipeline, **kw)
    return float(out.values[0]), out.vectors[:, 0]
