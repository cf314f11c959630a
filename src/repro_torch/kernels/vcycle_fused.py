"""Fused V-cycle kernels for the H100: batched ELL spmv (K1), the fused
Chebyshev smoother (K2) and the fused restrict+residual (K3).

The port of ``repro.kernels.vcycle_fused``.  Each wrapper launches its
hand-written CUDA kernel (``kernels/csrc/*.cu``) when its tensors lie on a
CUDA device, and runs the kernel's plain PyTorch version
(:mod:`repro_torch.kernels.ref`) when they lie on the CPU.  Nothing else
decides the route: no environment variable, no check of whether the
toolchain imports.  On a CUDA tensor the wrapper launches or raises.

Each launch adds one to its kernel's count
(:data:`repro_torch.kernels._launch.launches`), so a run can show that it
went through the kernels.

Design notes for the card (the TPU kernels held whole levels in VMEM):

  * K1 streams x through L2; one thread per (row, column).
  * K2 is one launch a pre-smooth and two a post-smooth.  From a zero
    start (the pre-smooth) step 1 has no matvec, so each row recomputes
    step 1's iterate of every neighbour and runs step 2 in the same pass.
    From a warm start (the post-smooth) step 1 reads every neighbour's
    iterate as ``z + zc[agg]``, the V-cycle's prolongation folded in, and
    step 2 needs every neighbour's step-1 iterate, so it is the next
    launch.  Steps past the second run one launch each
    (:func:`cheby_step`).
  * K3 walks a CSR of aggregates built once at hierarchy build, so the sum
    is deterministic without float atomics, reading a copy of the slabs in
    aggregate order made once when the V-cycle is set up.

:func:`cheby_coeffs` and :func:`cheby_recurrence` stay the one definition
of the polynomial; the fused smoother applies the same step coefficients
(:func:`cheby_step_coeffs`) in the same order.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._launch import (count, on_cuda, ptr, require,
                                         slabs, stream)


def cheby_coeffs(rho: float):
    """Chebyshev smoother coefficients for eigenvalues of ``D^-1 L`` in
    ``[lmax/4, lmax]`` with ``lmax = 1.1 * rho``.  Returns
    ``(theta, delta, sigma)`` — midpoint, half-width and their ratio."""
    lmax = 1.1 * rho
    lmin = lmax / 4.0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    return theta, delta, theta / delta


def cheby_step_coeffs(delta: float, sigma: float, degree: int):
    """``[(c1, c2), ...]`` of the ``degree - 1`` later recurrence steps,
    computed in Python double: ``c1 = rho_k * rho_prev``,
    ``c2 = 2 * rho_k / delta``."""
    out, rho_prev = [], 1.0 / sigma
    for _ in range(degree - 1):
        rho_k = 1.0 / (2.0 * sigma - rho_prev)
        out.append((rho_k * rho_prev, 2.0 * rho_k / delta))
        rho_prev = rho_k
    return out


def cheby_recurrence(matvec: Callable, inv_d, r, z, *, degree: int,
                     theta, delta: float, sigma: float):
    """The degree-``degree`` Chebyshev recurrence for ``L z ~= r`` with
    Jacobi scaling; ``z=None`` starts from the zero iterate.  ``theta`` may
    be a 0-dim tensor (a true division on every device)."""
    res = r if z is None else r - matvec(z)
    p = inv_d * res / theta
    z = p if z is None else z + p
    for c1, c2 in cheby_step_coeffs(delta, sigma, degree):
        res = r - matvec(z)
        p = c1 * p + c2 * (inv_d * res)
        z = z + p
    return z


# ---------------------------------------------------------------------------
# K1: batched-RHS ELL spmv
# ---------------------------------------------------------------------------

def spmv_ell_batched(idx, val, x):
    """``y[i, j] = sum_l val[i, l] * x[idx[i, l], j]`` for ``x [nx, k]``,
    ``nx >= n``; ``[n, k]`` out."""
    if not on_cuda(idx, val, x):
        return _ref.spmv_ell_batched_ref(idx, val, x)
    from repro_torch.kernels._build import check, library

    n, L = slabs(idx, val)
    require(x, "x", torch.float32, 2)
    if x.shape[0] < n:
        raise ValueError(f"x has {x.shape[0]} rows, the slab {n}")
    k = x.shape[1]
    y = torch.empty((n, k), dtype=torch.float32, device=x.device)
    check(library().repro_spmv_ell_batched(
        idx.data_ptr(), val.data_ptr(), x.data_ptr(), y.data_ptr(), n, L, k,
        stream()), "spmv_ell_batched")
    count("spmv_ell_batched")
    return y


# ---------------------------------------------------------------------------
# K2: fused Chebyshev smoother, one launch a pre-smooth, two a post-smooth
# ---------------------------------------------------------------------------

def cheby_step(idx, val, inv_d, r, z_prev, p, z_out, *, first: bool,
               theta: float, c1: float = 0.0, c2: float = 0.0):
    """One recurrence step: writes ``p`` (in place) and ``z_out``, returns
    them.  ``z_prev=None`` is the first step from the zero iterate (no
    matvec)."""
    if not on_cuda(idx, val, inv_d, r, z_prev, p, z_out):
        p_new, z_new = _ref.cheby_step_ref(idx, val, inv_d, r, z_prev, p,
                                           first=first, theta=theta,
                                           c1=c1, c2=c2)
        p.copy_(p_new)
        z_out.copy_(z_new)
        return p, z_out
    from repro_torch.kernels._build import check, library

    n, L = slabs(idx, val)
    require(inv_d, "inv_d", torch.float32, 1)
    for name, t in (("r", r), ("z_prev", z_prev), ("p", p), ("z_out", z_out)):
        if t is not None:
            require(t, name, torch.float32, 2)
            if t.shape != r.shape or r.shape[0] != n:
                raise ValueError(f"{name} shape {tuple(t.shape)} != "
                                 f"r {tuple(r.shape)} with {n} slab rows")
    if z_out is z_prev:
        raise ValueError("z_out must not alias z_prev (rows read z_prev)")
    check(library().repro_cheby_step(
        idx.data_ptr(), val.data_ptr(), inv_d.data_ptr(), r.data_ptr(),
        ptr(z_prev), p.data_ptr(), z_out.data_ptr(), n, L, r.shape[1],
        int(first), float(theta), float(c1), float(c2), stream()),
        "cheby_step")
    count("cheby_step")
    return p, z_out


def _sweep_operands(idx, val, inv_d, r, z=None, zc=None, agg=None):
    """Check a sweep's operands on the CUDA route; returns ``(n, L, k)``.
    ``agg``'s values must lie in ``[0, zc.shape[0])`` (a hierarchy's are;
    checking them would read them back)."""
    n, L = slabs(idx, val)
    require(inv_d, "inv_d", torch.float32, 1)
    require(r, "r", torch.float32, 2)
    if r.shape[0] != n or inv_d.shape[0] != n:
        raise ValueError(f"r {tuple(r.shape)} and inv_d "
                         f"{tuple(inv_d.shape)} need the slab's {n} rows")
    if z is not None:
        require(z, "z", torch.float32, 2)
        if z.shape != r.shape:
            raise ValueError(f"z {tuple(z.shape)} != r {tuple(r.shape)}")
    if (zc is None) != (agg is None):
        raise ValueError("zc and agg come together")
    if zc is not None:
        require(zc, "zc", torch.float32, 2)
        require(agg, "agg", torch.int32, 1)
        if agg.shape[0] != n or zc.shape[1] != r.shape[1]:
            raise ValueError(f"agg {tuple(agg.shape)} and zc "
                             f"{tuple(zc.shape)} do not fit r "
                             f"{tuple(r.shape)}")
    return n, L, r.shape[1]


def cheby_smooth_zero(idx, val, inv_d, r, *, theta: float, c1: float,
                      c2: float, want_p: bool = False):
    """Steps 1 and 2 from the zero iterate in one launch; returns ``(p,
    z)`` after step 2, ``p`` only with ``want_p`` (later steps need it)."""
    if not on_cuda(idx, val, inv_d, r):
        p, z = _ref.cheby_smooth_zero_ref(idx, val, inv_d, r, theta=theta,
                                          c1=c1, c2=c2)
        return (p if want_p else None), z
    from repro_torch.kernels._build import check, library

    n, L, k = _sweep_operands(idx, val, inv_d, r)
    p = torch.empty_like(r) if want_p else None
    z = torch.empty_like(r)
    check(library().repro_cheby_smooth_zero(
        idx.data_ptr(), val.data_ptr(), inv_d.data_ptr(), r.data_ptr(),
        ptr(p), z.data_ptr(), n, L, k, float(theta), float(c1), float(c2),
        stream()), "cheby_smooth_zero")
    count("cheby_smooth_zero")
    return p, z


def cheby_prolong_step(idx, val, inv_d, r, z, zc=None, agg=None, *,
                       theta: float):
    """Step 1 from the warm start ``z + zc[agg]`` (``z`` without ``zc``) in
    one launch; returns ``(p, z1)``.  The post-smooth's first launch;
    :func:`cheby_step` runs the next step."""
    if not on_cuda(idx, val, inv_d, r, z, zc, agg):
        return _ref.cheby_prolong_step_ref(idx, val, inv_d, r, z, zc, agg,
                                           theta=theta)
    from repro_torch.kernels._build import check, library

    n, L, k = _sweep_operands(idx, val, inv_d, r, z, zc, agg)
    p, z1 = torch.empty_like(r), torch.empty_like(r)
    check(library().repro_cheby_prolong_step(
        idx.data_ptr(), val.data_ptr(), inv_d.data_ptr(), r.data_ptr(),
        z.data_ptr(), ptr(zc), ptr(agg), p.data_ptr(), z1.data_ptr(), n, L,
        k, float(theta), stream()), "cheby_prolong_step")
    count("cheby_prolong_step")
    return p, z1


def make_fused_chebyshev(idx, val, diag, rho: float, *, degree: int = 3,
                         agg=None) -> Callable:
    """Build ``smooth(r, z=None, zc=None)``: the degree-``degree``
    polynomial.  ``zc [n_coarse, k]`` with the factory's ``agg`` (int32,
    each row's coarse vertex) starts from ``z + zc[agg]``: the V-cycle's
    prolongation, folded into the sweep's first step.  Coefficients are
    baked in from the spectral radius estimate ``rho``, exactly as the plain
    closure does.

    From zero the first two steps are one launch
    (:func:`cheby_smooth_zero`); from a warm start the first step is one
    (:func:`cheby_prolong_step`); each further step, and a degree-1 sweep
    from zero, is a :func:`cheby_step` launch."""
    if degree < 1:
        raise ValueError(f"degree must be at least 1, got {degree}")
    theta, delta, sigma = cheby_coeffs(rho)
    steps = cheby_step_coeffs(delta, sigma, degree)
    inv_d = 1.0 / diag

    def smooth(r, z=None, zc=None):
        if zc is not None and (z is None or agg is None):
            raise ValueError("zc needs a warm start z and the factory's agg")
        if z is None and not steps:         # degree 1 from zero: no matvec
            return cheby_step(idx, val, inv_d, r, None, torch.empty_like(r),
                              torch.empty_like(r), first=True,
                              theta=theta)[1]
        if z is None:
            p, cur = cheby_smooth_zero(idx, val, inv_d, r, theta=theta,
                                       c1=steps[0][0], c2=steps[0][1],
                                       want_p=len(steps) > 1)
            rest = steps[1:]
        else:
            p, cur = cheby_prolong_step(idx, val, inv_d, r, z, zc,
                                        None if zc is None else agg,
                                        theta=theta)
            rest = steps
        for c1, c2 in rest:
            _, cur = cheby_step(idx, val, inv_d, r, cur, p,
                                torch.empty_like(r), first=False,
                                theta=theta, c1=c1, c2=c2)
        return cur

    return smooth


# ---------------------------------------------------------------------------
# K3: fused restrict + residual
# ---------------------------------------------------------------------------

MAX_L = 16   # K3's template instances: slab widths 1..MAX_L


def aggregate_slabs(idx, val, perm):
    """K3's copy of the ELL slabs in aggregate order: row ``m`` holds slab
    row ``perm[m]``, padded with zero columns to ``4 * ceil(L / 4)`` (rows of
    whole 16-byte words).  One more slab's bytes a level, made once when the
    fused V-cycle is set up (:func:`make_fused_restrict_residual`)."""
    n, L = idx.shape
    width = -(-L // 4) * 4
    rows = perm.long()
    idx_agg = torch.zeros((n, width), dtype=idx.dtype, device=idx.device)
    val_agg = torch.zeros((n, width), dtype=val.dtype, device=val.device)
    idx_agg[:, :L] = idx[rows]
    val_agg[:, :L] = val[rows]
    return idx_agg, val_agg


def restrict_residual(idx, val, perm, agg_ptr, agg_max: int, r, z,
                      agg_slabs=None):
    """``rc[c] = sum_{i in aggregate c, ascending} (r - A z)[i]``,
    ``[n_coarse, k]`` out; the fine residual is never materialized.

    ``agg_slabs`` is :func:`aggregate_slabs` of ``(idx, val, perm)``; on the
    card, where k is a multiple of 4 and L at most :data:`MAX_L`, the kernel
    reads it and makes it first when it is not given.  The result does not
    depend on it."""
    if not on_cuda(idx, val, perm, agg_ptr, r, z):
        return _ref.restrict_residual_ref(idx, val, perm, agg_ptr, agg_max,
                                          r, z)
    from repro_torch.kernels._build import check, library

    n, L = slabs(idx, val)
    require(perm, "perm", torch.int32, 1)
    require(agg_ptr, "agg_ptr", torch.int32, 1)
    require(r, "r", torch.float32, 2)
    require(z, "z", torch.float32, 2)
    if r.shape != z.shape or r.shape[0] != n or perm.shape[0] != n:
        raise ValueError("restrict_residual: r, z and perm need the slab's "
                         f"{n} rows; got {tuple(r.shape)}, {tuple(z.shape)},"
                         f" {tuple(perm.shape)}")
    n_coarse, k = agg_ptr.shape[0] - 1, r.shape[1]
    rc = torch.empty((n_coarse, k), dtype=torch.float32, device=r.device)
    vec = (k % 4 == 0 and 1 <= L <= MAX_L
           and r.data_ptr() % 16 == 0 and z.data_ptr() % 16 == 0)
    copy = (None, None)
    if vec:
        copy = agg_slabs if agg_slabs is not None else \
            aggregate_slabs(idx, val, perm)
        width = -(-L // 4) * 4
        for t, name, dtype in zip(copy, ("idx_agg", "val_agg"),
                                  (torch.int32, torch.float32)):
            require(t, name, dtype, 2)
            if tuple(t.shape) != (n, width) or t.device != r.device:
                raise ValueError(f"{name} has shape {tuple(t.shape)} on "
                                 f"{t.device}, want ({n}, {width}) on "
                                 f"{r.device}")
    check(library().repro_restrict_residual(
        idx.data_ptr(), val.data_ptr(), perm.data_ptr(), agg_ptr.data_ptr(),
        ptr(copy[0]), ptr(copy[1]), r.data_ptr(), z.data_ptr(),
        rc.data_ptr(), n_coarse, L, k, stream()), "restrict_residual")
    count("restrict_residual")
    return rc


def make_fused_restrict_residual(idx, val, perm, agg_ptr,
                                 agg_max: int) -> Callable:
    """Build ``restrict(r, z) -> rc [n_coarse, k]`` over one level; on the
    card it makes the level's :func:`aggregate_slabs` once, here."""
    agg_slabs = (aggregate_slabs(idx, val, perm)
                 if on_cuda(idx, val, perm) and idx.shape[1] <= MAX_L
                 else None)

    def restrict(r, z):
        return restrict_residual(idx, val, perm, agg_ptr, agg_max, r, z,
                                 agg_slabs=agg_slabs)

    return restrict
