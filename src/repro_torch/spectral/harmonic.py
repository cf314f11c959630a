"""Harmonic interpolation / label propagation on ``DeviceGraph``.

The port of ``repro.spectral.harmonic``.  Given boundary vertices ``B``
with fixed values ``x_B``, the harmonic extension solves the Dirichlet
problem ``L_II x_I = -L_IB x_B`` — the interior values are weighted
averages of their neighbors, the discrete analogue of a harmonic
function.  This is the classic semi-supervised label-propagation
primitive (Zhu-Ghahramani-Lafferty), and it exercises the solver stack on
a task where quality is a *prediction error*, not an iteration count.

Rather than materializing the interior submatrix, the split is expressed
as a masking projection over the *full* vertex set.  With ``m`` the 0/1
interior indicator and ``x0`` the boundary extension (``x_B`` on ``B``,
zero inside), write ``x = x0 + c`` where ``c`` is interior-supported.  The
correction solves

    A c = b,   A(y) = m · L(m · y) + (1-m) · y,   b = -m · L(x0).

``A`` agrees with ``L_II`` on interior-supported vectors and is the
identity on boundary-supported ones, so it is SPD whenever every connected
component touches the boundary — plain Jacobi PCG applies, with no
nullspace centering (the shared
:func:`~repro_torch.solver.device_pcg._pcg_loop` runs with an identity
``center``).  The boundary set is an ``[n]`` mask, so one closure serves
every split of a graph.

``L`` is applied through the graph's ELL slabs and the solver's batched
matvec: kernel K1 on a CUDA device, its plain version on the CPU.  Every
entry point takes ``device=`` (default ``"cuda"``) for a host ``Graph``;
a :class:`DeviceGraph` stays on its own device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import numpy as np
import torch

from repro_torch.core.device_graph import DeviceGraph
from repro_torch.core.graph import Graph
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.solver.device_pcg import (_pcg_loop, default_matvec_impl,
                                           make_matvec)


@dataclasses.dataclass(frozen=True)
class HarmonicResult:
    """Solution of one Dirichlet problem.

    Attributes:
      x:         ``[n, k]`` harmonic extension — equals the boundary values
                 on ``B`` exactly (enforced by construction, not by solve
                 accuracy), harmonic inside.
      iters:     ``[k]`` PCG iterations per column.
      relres:    ``[k]`` true relative residuals of the correction system.
      converged: ``[k]`` bool, per-column tolerance met.
    """

    x: np.ndarray
    iters: np.ndarray
    relres: np.ndarray
    converged: np.ndarray


def _laplacian(dg: DeviceGraph) -> Callable:
    """``L y`` for ``[n, k]`` float32 ``y`` on ``dg``'s device, through the
    ELL slabs."""
    idx, val = dg.to_ell()
    return make_matvec(idx, val, default_matvec_impl(dg.device))


def make_dirichlet_core(dg: DeviceGraph) -> Callable:
    """A closure ``(interior [n], b [n, k], tol, maxiter)`` running PCG on
    the projected operator ``A`` for an arbitrary interior-supported RHS
    — the refinement-friendly primitive under
    :func:`make_harmonic_solver`.  Tensors live on ``dg``'s device."""
    lap = _laplacian(dg)

    def solve_correction(interior, b, tol, maxiter):
        m = interior[:, None]
        # Jacobi on the projected operator: true diagonal inside, 1 on the
        # identity-padded boundary rows (guarded — isolated boundary-only
        # rows of a disconnected component would otherwise divide by 0).
        dmod = torch.clamp(m[:, 0] * dg.diag + (1.0 - m[:, 0]),
                           min=1e-30)[:, None]

        def matvec(y):
            return m * lap((m * y).contiguous()) + (1.0 - m) * y

        res = _pcg_loop(matvec, m * b, lambda r: r / dmod, tol, maxiter,
                        center=lambda v: v)
        return res._replace(x=m * res.x)

    solve_correction.laplacian = lap
    return solve_correction


def make_harmonic_solver(dg: DeviceGraph) -> Callable:
    """A closure ``(interior [n], xb [n, k], tol, maxiter)`` solving the
    Dirichlet problem on ``dg`` for any boundary split.

    ``interior`` is a float 0/1 mask (1 = free vertex), ``xb`` carries the
    boundary values on masked-out rows (interior rows of ``xb`` are
    ignored).  Returns the raw device result; :func:`harmonic_interpolate`
    is the host-facing wrapper (and adds f64 refinement on top).
    """
    core = make_dirichlet_core(dg)
    lap = core.laplacian

    def solve(interior, xb, tol, maxiter):
        m = interior[:, None]
        x0 = (1.0 - m) * xb
        b = -m * lap(x0.contiguous())
        res = core(interior, b, tol, maxiter)
        return res._replace(x=x0 + res.x)

    return solve


def _host_operator(dg: DeviceGraph, bmask: np.ndarray):
    """f64 numpy ``A`` (and raw ``L``) matvecs of the projected operator —
    the residual oracle for host-side iterative refinement."""
    src = dg.src.cpu().numpy()
    dst = dg.dst.cpu().numpy()
    w = dg.weight.cpu().numpy().astype(np.float64)[:, None]
    # Recompute the weighted degrees in f64 — ``dg.diag`` is an f32
    # sum whose ~1e-6 rounding would become the accuracy floor of the
    # refined solution (the f32 device solve is only a preconditioner
    # here; the residual oracle defines what "exact" means).
    d = np.zeros((dg.n, 1))
    np.add.at(d, src, w)
    np.add.at(d, dst, w)
    m = (~bmask).astype(np.float64)[:, None]

    def L64(x):
        y = d * x
        np.add.at(y, src, -w * x[dst])
        np.add.at(y, dst, -w * x[src])
        return y

    def A64(y):
        return m * L64(m * y) + (1.0 - m) * y

    return L64, A64, m


def _as_device(graph: Union[Graph, DeviceGraph], device) -> DeviceGraph:
    return graph if isinstance(graph, DeviceGraph) \
        else DeviceGraph.from_graph(graph, device=device)


def harmonic_interpolate(graph: Union[Graph, DeviceGraph], boundary,
                         values, *, tol: float = 1e-8,
                         maxiter: int = 2000,
                         max_refine: int = 2,
                         device="cuda") -> HarmonicResult:
    """Harmonic extension of ``values`` on ``boundary`` to the whole graph.

    ``boundary`` is a vertex-id array (or ``[n]`` bool mask); ``values`` is
    ``[|B|]`` / ``[|B|, k]`` aligned with it (or ``[n]`` / ``[n, k]`` when
    a mask is given).  Every connected component must contain at least one
    boundary vertex — otherwise the Dirichlet system is singular there.

    The device PCG runs in f32; tolerances below its ~1e-7 floor are
    reached by up to ``max_refine`` rounds of f64 iterative refinement
    (solve, recompute the true residual on the host, re-solve the
    correction) — the same contract the solver service offers.
    """
    dg = _as_device(graph, device)
    n = dg.n
    boundary = np.asarray(boundary)
    bids = None
    if boundary.dtype == bool:
        if boundary.shape != (n,):
            raise ValueError(f"boundary mask must be [{n}], got "
                             f"{boundary.shape}")
        bmask = boundary
    else:
        bids = boundary.astype(np.int64)
        bmask = np.zeros(n, dtype=bool)
        bmask[bids] = True
    nb = int(bmask.sum())
    if nb == 0:
        raise ValueError("boundary must be nonempty")

    vals = np.asarray(values, dtype=np.float32)
    squeeze = vals.ndim == 1
    if squeeze:
        vals = vals[:, None]
    xb = np.zeros((n, vals.shape[1]), dtype=np.float32)
    if vals.shape[0] == n:
        xb[bmask] = vals[bmask]
    elif bids is not None and vals.shape[0] == bids.shape[0]:
        xb[bids] = vals          # rows align with the ids AS GIVEN
    elif vals.shape[0] == nb:
        xb[bmask] = vals
    else:
        raise ValueError(f"values rows ({vals.shape[0]}) match neither the "
                         f"boundary size ({nb}) nor n ({n})")

    metrics = get_metrics()
    k = xb.shape[1]
    with get_tracer().span("spectral.harmonic", n=n, boundary=nb,
                           k=k) as sp:
        core = make_dirichlet_core(dg)
        L64, A64, m64 = _host_operator(dg, bmask)
        interior = torch.as_tensor(~bmask, dtype=torch.float32,
                                   device=dg.device)
        x0 = (1.0 - m64) * xb.astype(np.float64)
        b64 = -(m64 * L64(x0))
        bn = np.maximum(np.linalg.norm(b64, axis=0),
                        np.finfo(np.float64).tiny)

        c = np.zeros((n, k), dtype=np.float64)
        iters = np.zeros(k, dtype=np.int64)
        relres = np.ones(k)
        passes = 0
        for passes in range(1, max_refine + 2):
            r = b64 - A64(c)
            relres = np.linalg.norm(r, axis=0) / bn
            if np.all(relres <= tol):
                break
            # Per-pass target: the reduction factor still missing, clamped
            # to what one f32 PCG sweep can deliver.
            inner = float(np.clip((tol / max(relres.max(), tol)), 1e-7, 0.5))
            res = core(interior,
                       torch.as_tensor(r, dtype=torch.float32,
                                       device=dg.device),
                       inner, maxiter)
            # analysis: allow(sync-host-sync): the f64 refinement's read-back
            c += res.x.cpu().numpy().astype(np.float64)
            # analysis: allow(sync-host-sync): the same read-back, a pass
            iters += res.iters.cpu().numpy().astype(np.int64)
        relres = np.linalg.norm(b64 - A64(c), axis=0) / bn
        sp.set(iters=int(iters.max(initial=0)), passes=passes,
               max_relres=float(relres.max(initial=0.0)))
    metrics.inc("spectral.harmonic.solves")
    metrics.inc("spectral.harmonic.columns", k)
    metrics.observe_many("spectral.harmonic.iters", iters.tolist())

    x = x0 + m64 * c
    return HarmonicResult(
        x=x[:, 0] if squeeze else x,
        iters=iters, relres=relres, converged=relres <= tol)


def label_propagation(graph: Union[Graph, DeviceGraph], labeled, labels, *,
                      num_classes: int = None, tol: float = 1e-6,
                      maxiter: int = 2000, device="cuda"):
    """Semi-supervised node classification by harmonic extension.

    ``labeled`` are the seed vertex ids, ``labels`` their integer classes.
    Each class becomes a one-hot boundary column; the harmonic extension
    gives every vertex a score per class and the argmax is its prediction.
    Returns ``(pred [n] int64, scores [n, C] float64)``.
    """
    labeled = np.asarray(labeled, dtype=np.int64)
    labels = np.asarray(labels, dtype=np.int64)
    if labeled.shape != labels.shape:
        raise ValueError("labeled ids and labels must align")
    C = int(num_classes) if num_classes is not None else int(labels.max()) + 1
    onehot = np.zeros((labeled.shape[0], C), dtype=np.float32)
    onehot[np.arange(labeled.shape[0]), labels] = 1.0
    res = harmonic_interpolate(graph, labeled, onehot, tol=tol,
                               maxiter=maxiter, device=device)
    return np.argmax(res.x, axis=1), res.x
