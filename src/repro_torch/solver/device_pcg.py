"""Batched-RHS PCG on the device, preconditioned by the hierarchy.

The port of ``repro.solver.device_pcg``.  One loop advances all ``k``
right-hand sides of an ``[n, k]`` batch together (per-column alpha/beta,
converged columns frozen).  The Laplacian is singular, so the solve stays
in ``range(L)``: right-hand sides and preconditioner outputs are centered,
and solutions are defined up to a constant (compare after ``x - x[0]``).

The preconditioner is a symmetric V(1,1)-cycle over the
:class:`repro_torch.solver.hierarchy.Hierarchy`: Chebyshev pre-smooth,
restriction of the residual through the aggregation tree, a dense Cholesky
solve at the coarsest level, prolongation and Chebyshev post-smooth.

``matvec_impl``:

  * ``"fused"`` — the CUDA kernels: K1 for every matvec (the PCG's and the
    spectral radius power iteration's), K2 for every smoothing sweep (the
    post-smooth's with the prolongation folded in), K3 for every
    down-sweep.  On CPU tensors the same calls run the kernels'
    plain versions.
  * ``"kernel"`` — kernel K5, one launch per column of every matvec, as
    the reference's per-column Pallas route; the V-cycle then runs the
    unfused Chebyshev recurrence and restriction over that matvec.  On CPU
    tensors K5's wrapper runs its plain version.
  * ``"ref"`` — the plain PyTorch versions, composed as the reference's
    jnp path is.
  * ``None`` — ``"fused"`` on a CUDA device, ``"ref"`` on the CPU.

Column sums (:func:`colsum`) fold the rows in halves, a fixed pairwise
order: every column is summed the same way whatever ``k`` is and on either
device, so a column solved in a batch equals the column solved alone, and
two runs give the same bits.

The reference's PCG ``lax.while_loop`` (``device_pcg.py:309``) is a Python
loop that tests for "every column done" on the host every 8 trips.  Finished columns are frozen (alpha 0, p and rz held), so the extra
trips change neither ``x`` nor ``iters``.  With the tracer on,
``pcg.loop`` spans the trips and ``pcg.wait`` each of those tests, so the
loop less its waits is the host issuing the work.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels.spmv_ell import spmv_ell, to_ell
from repro_torch.kernels.vcycle_fused import (cheby_coeffs, cheby_recurrence,
                                              make_fused_chebyshev,
                                              make_fused_restrict_residual,
                                              spmv_ell_batched)
from repro_torch.obs import get_tracer
from repro_torch.obs.device import trace_annotation
from repro_torch.solver.hierarchy import Hierarchy


class BatchedPCGResult(NamedTuple):
    x: torch.Tensor          # [n, k] mean-zero solutions
    iters: torch.Tensor      # [k] int32 per-column iteration counts
    relres: torch.Tensor     # [k] true relative residuals ||b - Lx|| / ||b||
    converged: torch.Tensor  # [k] bool


def default_matvec_impl(device) -> str:
    """``"fused"`` (the CUDA kernels) on a CUDA device, ``"ref"`` on the CPU."""
    return "fused" if torch.device(device).type == "cuda" else "ref"


def ell_laplacian(graph, *, device="cuda"):
    """ELL slabs of a Graph's Laplacian on ``device``."""
    return to_ell(graph, device=device)


def make_matvec(idx, val, impl: str = "ref") -> Callable:
    """Batched ELL matvec ``[n, k] -> [n, k]``: ``"fused"`` through kernel
    K1, ``"kernel"`` through one launch of kernel K5 per column, ``"ref"``
    through K1's plain version.  All three sum each row in the same order,
    so they give the same bits."""
    if impl == "fused":
        def matvec(x):
            return spmv_ell_batched(idx, val, x)
    elif impl == "kernel":
        def matvec(x):
            return torch.stack([spmv_ell(idx, val, x[:, j].contiguous())
                                for j in range(x.shape[1])], dim=1)
    elif impl == "ref":
        def matvec(x):
            return kref.spmv_ell_batched_ref(idx, val, x)
    else:
        raise ValueError(f"unknown matvec impl {impl!r}")
    return matvec


def colsum(v: torch.Tensor) -> torch.Tensor:
    """``[rows, k] -> [k]`` column sums by pairwise folding of the rows."""
    while v.shape[0] > 1:
        h = v.shape[0] // 2
        head = v[:h] + v[h:2 * h]
        v = torch.cat([head, v[2 * h:]]) if v.shape[0] % 2 else head
    return v[0] if v.shape[0] else torch.zeros(v.shape[1:], dtype=v.dtype,
                                               device=v.device)


def _center(x):
    return x - colsum(x) / x.shape[0]


def estimate_dinv_rho_device(matvec: Callable, diag, iters: int = 12):
    """Power-iteration estimate of ``rho(D^-1 L)`` as a device scalar.

    Deterministic start vector ``sin(1.7 i + 0.3)``, no host sync; callers
    that estimate several levels read them all back together."""
    n = diag.shape[0]
    v = torch.sin(torch.arange(n, dtype=torch.float32, device=diag.device)
                  * 1.7 + 0.3)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = matvec(v[:, None])[:, 0] / diag
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    w = matvec(v[:, None])[:, 0] / diag
    return torch.linalg.vector_norm(w)


def estimate_dinv_rho(matvec: Callable, diag, iters: int = 12) -> float:
    """Host-scalar convenience over :func:`estimate_dinv_rho_device`."""
    return float(estimate_dinv_rho_device(matvec, diag, iters))


def make_chebyshev_smoother(matvec: Callable, diag, rho: float,
                            degree: int = 3) -> Callable:
    """Degree-``degree`` Chebyshev smoother for ``L z = r`` with Jacobi
    scaling, targeting eigenvalues of ``D^-1 L`` in ``[lmax/4, lmax]``.
    Returns ``smooth(r, z=None)`` (``None`` = zero initial iterate)."""
    theta, delta, sigma = cheby_coeffs(rho)
    theta_t = torch.full((), theta, dtype=torch.float32, device=diag.device)
    inv_d = (1.0 / diag)[..., None]

    def smooth(r, z=None):
        return cheby_recurrence(matvec, inv_d, r, z, degree=degree,
                                theta=theta_t, delta=delta, sigma=sigma)

    return smooth


def coarse_solve(r, chol: Optional[torch.Tensor]):
    """The coarsest level's solve ``[nc, k] -> [nc, k]``, mean zero: the
    grounded Laplacian's Cholesky factor ``chol`` (``None`` for a single
    vertex) on rows 1.. with row 0 pinned to zero, then centered.

    One batched solve per column, so a column's result does not depend on
    its neighbours (a multi-column triangular solve blocks over the
    columns).  On a CUDA device PyTorch solves a batch of one with
    cuSOLVER and a larger batch with MAGMA, which round differently: a lone
    column rides with a zero one, so that every width takes the batched
    route."""
    if chol is None:
        return torch.zeros_like(r)
    k = r.shape[1]
    rhs = r[1:].t().unsqueeze(-1)
    if k == 1:
        rhs = torch.cat([rhs, torch.zeros_like(rhs)])
    y = torch.cholesky_solve(rhs, chol, upper=False)
    y = y[:k].squeeze(-1).t()
    return _center(torch.cat([torch.zeros_like(r[:1]), y]))


def make_vcycle(hier: Hierarchy, *, degree: int = 2,
                matvec_impl: str = "ref") -> Callable:
    """Symmetric V(1,1)-cycle apply ``r [n, k] -> z ~= L_P^+ r``.

    Each level's spectral radius comes from the power iteration over that
    level's ``matvec_impl`` matvec; K1, K5 and their plain version are
    bitwise equal, so every impl bakes in the same polynomial
    coefficients."""
    fused = matvec_impl == "fused"
    matvecs = [make_matvec(lev.idx, lev.val, matvec_impl)
               for lev in hier.levels]
    rho_dev = [estimate_dinv_rho_device(mv, lev.diag)
               for mv, lev in zip(matvecs, hier.levels)]
    # the one build-time sync: every level's estimate read back together
    # analysis: allow(sync-host-sync): build time, once: the estimates
    rhos = torch.stack(rho_dev).tolist() if rho_dev else []
    if fused:
        smoothers = [make_fused_chebyshev(lev.idx, lev.val, lev.diag, rho,
                                          degree=degree, agg=lev.agg)
                     for lev, rho in zip(hier.levels, rhos)]
        restricts = [make_fused_restrict_residual(lev.idx, lev.val, lev.perm,
                                                  lev.agg_ptr, lev.agg_max)
                     for lev in hier.levels]
    else:
        smoothers = [make_chebyshev_smoother(mv, lev.diag, rho, degree=degree)
                     for mv, lev, rho in zip(matvecs, hier.levels, rhos)]
        restricts = [_make_restrict(mv, lev)
                     for mv, lev in zip(matvecs, hier.levels)]
    aggs = [] if fused else [lev.agg.long() for lev in hier.levels]

    def cycle(l: int, r):
        if l == len(hier.levels):
            with trace_annotation("vcycle.coarse"):
                return coarse_solve(r, hier.coarse_chol)
        smooth = smoothers[l]
        with trace_annotation(f"vcycle.L{l}.down"):
            z = smooth(r)                                   # pre-smooth
            rc = restricts[l](r, z)                         # restrict
        zc = cycle(l + 1, rc)                               # coarse correct
        with trace_annotation(f"vcycle.L{l}.up"):
            if fused:               # K2 reads z + zc[agg] as it post-smooths
                return smooth(r, z, zc)
            return smooth(r, z + zc[aggs[l]])               # prolong, smooth

    def msolve(r):
        return _center(cycle(0, r))

    msolve.rhos = rhos
    return msolve


def _make_restrict(matvec: Callable, lev) -> Callable:
    """``restrict(r, z)``: the ordered aggregate sum of ``r - A z`` with the
    level's own matvec (K3's function, unfused)."""
    def restrict(r, z):
        return kref.aggregate_sum_ref(r - matvec(z), lev.perm, lev.agg_ptr,
                                      lev.agg_max)

    return restrict


def make_jacobi(diag) -> Callable:
    """Diagonal preconditioner (cheap middle ground for comparisons)."""
    d = diag[:, None]

    def msolve(r):
        return _center(r / d)

    return msolve


_PCG_CHECK_EVERY = 8   # PCG trips between host tests of "all done"


def _pcg_loop(matvec: Callable, b, msolve: Callable, tol, maxiter,
              colsum: Callable = colsum,
              center: Callable = _center) -> BatchedPCGResult:
    """The batched PCG loop: per-column alpha/beta with converged columns
    frozen, the ``tol_inner = 0.5 * tol`` target and van der Vorst residual
    replacement every 50 trips, as in the reference.

    ``colsum(v) -> [k]`` sums a ``[rows, k]`` tensor over its rows and
    ``center`` projects the final ``x`` out of the operator's nullspace:
    the Laplacian's constants by default, the identity for a nonsingular
    operator (the harmonic Dirichlet solve).  ``b`` may carry leading
    axes (the sharded plane's ``[P, n_loc, k]``); columns are its last."""
    k = b.shape[-1]
    dev = b.device
    bnorm = torch.sqrt(colsum(b * b))
    bn = torch.clamp(bnorm, min=torch.finfo(b.dtype).tiny)
    maxiter_t = torch.broadcast_to(
        # analysis: allow(audit-host-transfer): the trip caps, once a solve
        torch.as_tensor(maxiter, dtype=torch.int32, device=dev), (k,))
    # analysis: allow(sync-host-sync): once a solve, before the loop
    # analysis: allow(audit-host-transfer): the trip cap, read once a solve
    max_trips = int(maxiter_t.max()) if k else 0
    tol_inner = 0.5 * tol
    replace_every = 50

    x = torch.zeros_like(b)
    r = b
    p = msolve(b)
    rz = colsum(b * p)
    done = (bnorm <= 0) | (maxiter_t <= 0)
    iters = torch.zeros((k,), dtype=torch.int32, device=dev)
    it = 0
    # pcg.loop less its pcg.wait spans is the host issuing the trips
    tracer = get_tracer()
    with tracer.span("pcg.loop", k=k):
        while it < max_trips:
            with tracer.span("pcg.wait"):
                # analysis: allow(sync-host-sync): the test of "all done"
                # analysis: allow(audit-host-transfer): that test, run time
                # analysis: allow(audit-loop-transfer): every 8th trip
                busy = bool((~done).any())               # host sync
            if not busy:
                break
            for _ in range(min(_PCG_CHECK_EVERY, max_trips - it)):
                active = ~done
                Ap = matvec(p)
                pAp = colsum(p * Ap)
                alpha = torch.where(active,
                                    rz / torch.where(pAp != 0, pAp, 1.0), 0.0)
                x = x + alpha * p
                r = r - alpha * Ap
                if (it + 1) % replace_every == 0:
                    r = b - matvec(x)
                relres = torch.sqrt(colsum(r * r)) / bn
                iters = iters + active.to(torch.int32)
                done = done | (relres <= tol_inner) | (iters >= maxiter_t)
                z = msolve(r)
                rz_new = colsum(r * z)
                beta = rz_new / torch.where(rz != 0, rz, 1.0)
                p = torch.where(active, z + beta * p, p)
                rz = torch.where(active, rz_new, rz)
                it += 1
    x = center(x)
    relres = torch.sqrt(colsum((b - matvec(x)) ** 2)) / bn  # true residual
    return BatchedPCGResult(x=x, iters=iters, relres=relres,
                            converged=relres <= tol)


def batched_pcg(matvec: Callable, b, msolve: Optional[Callable] = None,
                tol=1e-5, maxiter=2000) -> BatchedPCGResult:
    """PCG over a mean-zero ``[n, k]`` RHS batch.  ``maxiter`` may be a
    scalar or a ``[k]`` sequence."""
    if msolve is None:
        msolve = lambda r: r  # noqa: E731
    return _pcg_loop(matvec, b, msolve, tol, maxiter)


def make_solver(idx, val, hierarchy: Optional[Hierarchy] = None,
                precond: str = "hierarchy",
                matvec_impl: Optional[str] = None, mesh=None,
                shard_axis: str = "data", *, device="cuda") -> Callable:
    """Build the end-to-end solve ``(b [n, k], tol, maxiter) -> result``.

    ``precond``: ``"hierarchy"`` (V-cycle over ``hierarchy``), ``"jacobi"``
    or ``"none"``.  ``idx``/``val`` move to ``device``; the hierarchy must
    already live there.  With a ``mesh`` the solve runs on the sharded
    plane (:func:`repro_torch.solver.sharded.make_sharded_solver`), rows
    sharded over ``shard_axis``."""
    device = torch.device(device)
    if matvec_impl is None:
        matvec_impl = default_matvec_impl(device)
    if mesh is not None:
        from repro_torch.solver.sharded import make_sharded_solver

        return make_sharded_solver(idx, val, hierarchy, precond, mesh=mesh,
                                   shard_axis=shard_axis,
                                   matvec_impl=matvec_impl, device=device)
    idx, val = idx.to(device), val.to(device)
    matvec = make_matvec(idx, val, matvec_impl)
    if precond == "hierarchy":
        if hierarchy is None:
            raise ValueError("precond='hierarchy' needs a Hierarchy")
        for lev in hierarchy.levels:
            if lev.idx.device.type != device.type:
                raise ValueError(f"hierarchy lives on {lev.idx.device}, "
                                 f"the solver on {device}")
        msolve = make_vcycle(hierarchy, matvec_impl=matvec_impl)
    elif precond == "jacobi":
        rows = torch.arange(idx.shape[0], device=device)[:, None]
        msolve = make_jacobi(torch.sum(val * (idx == rows), dim=1))
    elif precond == "none":
        msolve = None
    else:
        raise ValueError(f"unknown precond {precond!r}")

    def solve(b, tol=1e-5, maxiter=2000):
        b = torch.as_tensor(b, dtype=torch.float32, device=device)
        with trace_annotation("batched_pcg"):
            return batched_pcg(matvec, _center(b), msolve, tol=tol,
                               maxiter=maxiter)

    solve.msolve = msolve
    return solve
