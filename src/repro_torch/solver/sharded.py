"""Mesh-sharded solve plane: row-sharded batched PCG + Chebyshev V-cycle.

The port of ``repro.solver.sharded``.  It runs the algorithms of
:mod:`repro_torch.solver.device_pcg` over the shards of a
:class:`repro_torch.launch.Mesh`, the mesh the distributed recovery uses:

  * **Row sharding.** Every level's ELL slabs, and every solve vector, are
    row-sharded over the mesh axis, padded so that the shard count divides
    the rows.  Padding rows are self-loops of weight zero: their matvec
    output is zero and no live row reads them.  A sharded vector is
    stacked ``[P, n_loc, k]``, shard ``s`` holding ``v[s]``.
  * **Halo matvec.** Each shard's column ids are rewritten at build time
    into local coordinates: its own rows first, then its **halo**, the
    sorted unique remote rows its slab references.  A matvec is one
    ``all_gather`` of ``x``, a halo gather, and the shard's contraction:
    kernel K1 on ``x_ext = [x_loc; x[halo]]`` (``matvec_impl="fused"``) or
    its plain version (``"ref"``).
  * **Collective reductions.** Column sums are each shard's pairwise fold
    and a ``psum`` in shard order; the centering masks the padding rows
    and divides by the true row count.
  * **Sharded V-cycle.** The smoother is the Chebyshev recurrence composed
    from the halo matvecs: K2 fuses the steps of one device's sweep, and a
    collective between two matvecs cannot sit inside a kernel.  The
    restriction is each shard's ordered aggregate sum of its residual
    (the CSR-of-aggregates order of K3's plain version) and a ``psum`` of
    the partial coarse vectors in shard order: no float atomics, so the
    bits never move.  Prolongation is an ``all_gather`` and an aggregate
    gather; the coarsest solve is replicated
    (:func:`repro_torch.solver.device_pcg.coarse_solve`).  Each level's
    spectral radius is estimated on its unsharded slabs, so the sharded
    cycle applies the single-device polynomial.

Every op is column-independent, so a column solved in a batch equals it
solved alone, and ``"fused"`` gives the bits of ``"ref"``.
:func:`make_sharded_solver` returns a closure with the signature of
:func:`repro_torch.solver.device_pcg.make_solver`'s product, on global
``[n, k]`` arrays, so ``SolverService(mesh=...)`` swaps it in.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.collectives import all_gather, psum
from repro_torch.kernels import ref as kref
from repro_torch.kernels.vcycle_fused import spmv_ell_batched
from repro_torch.obs import get_tracer
from repro_torch.obs.device import trace_annotation
from repro_torch.solver.device_pcg import (BatchedPCGResult, _center,
                                           _pcg_loop, coarse_solve, colsum,
                                           default_matvec_impl,
                                           estimate_dinv_rho_device,
                                           make_chebyshev_smoother,
                                           make_matvec)
from repro_torch.solver.hierarchy import Hierarchy


class ShardedSlab(NamedTuple):
    """Row-sharded ELL slabs with per-shard local coordinates.

    ``idx`` entries are local: ``t < n_loc`` addresses the shard's own row
    ``t``; ``t >= n_loc`` addresses slot ``t - n_loc`` of the shard's
    halo.  ``halo`` is flat ``[n_sh * H]``: shard ``s``'s slice holds the
    global rows it gathers."""

    idx: torch.Tensor    # [n_pad, L] int32 local coords
    val: torch.Tensor    # [n_pad, L] f32
    halo: torch.Tensor   # [n_sh * H] int32 global row ids


class SlabMeta(NamedTuple):
    n: int        # true row count
    n_pad: int    # padded row count (divisible by n_sh)
    n_loc: int    # rows per shard
    halo: int     # halo slots per shard


class ShardedLevel(NamedTuple):
    """One sharded V-cycle level: slabs, smoother diagonal, aggregation,
    and each shard's CSR of aggregates for the ordered restriction."""

    slab: ShardedSlab
    diag: torch.Tensor     # [n_pad] f32, 1.0 on padding rows
    agg: torch.Tensor      # [n_pad] int32 coarse ids; nc_pad on padding rows
    perm: torch.Tensor     # [n_sh, n_loc] int32 local rows by aggregate
    agg_ptr: torch.Tensor  # [n_sh, nc_pad + 1] int32


class LevelMeta(NamedTuple):
    slab: SlabMeta
    rho: float          # Chebyshev spectral-radius bound (unsharded estimate)
    nc: int             # true coarse row count
    nc_pad: int
    nc_loc: int
    agg_max: int        # the largest aggregate of any shard (the loop bound)


def shard_ell_slabs(idx, val, n_sh: int):
    """Global ELL slabs -> (:class:`ShardedSlab` on their device,
    :class:`SlabMeta`), planned on the host.

    Pads rows to a multiple of ``n_sh`` with weight-zero self-loops, then
    rewrites every shard's column ids into [own rows | halo] local
    coordinates.  Shard ``s``'s halo is the sorted unique set of global rows
    outside its block that its slab references, padded with the shard's
    first row (never referenced)."""
    dev = idx.device
    idx = idx.cpu().numpy()
    val = val.cpu().numpy()
    n, L = idx.shape
    n_loc = -(-n // n_sh)
    n_pad = n_loc * n_sh
    idx_g = np.empty((n_pad, L), np.int32)
    val_p = np.zeros((n_pad, L), val.dtype)
    idx_g[:n] = idx
    val_p[:n] = val
    idx_g[n:] = np.arange(n, n_pad, dtype=np.int32)[:, None]

    halos = []
    for s in range(n_sh):
        r0 = s * n_loc
        blk = idx_g[r0:r0 + n_loc]
        own = (blk >= r0) & (blk < r0 + n_loc)
        halos.append(np.unique(blk[~own]))
    H = max(1, max(h.shape[0] for h in halos))
    halo = np.empty((n_sh, H), np.int32)
    idx_l = np.empty_like(idx_g)
    for s, h in enumerate(halos):
        r0 = s * n_loc
        halo[s, :h.shape[0]] = h
        halo[s, h.shape[0]:] = r0
        blk = idx_g[r0:r0 + n_loc]
        own = (blk >= r0) & (blk < r0 + n_loc)
        idx_l[r0:r0 + n_loc] = np.where(
            own, blk - r0, n_loc + np.searchsorted(h, blk))
    slab = ShardedSlab(idx=torch.as_tensor(idx_l, device=dev),
                       val=torch.as_tensor(val_p, device=dev),
                       halo=torch.as_tensor(halo.reshape(-1), device=dev))
    return slab, SlabMeta(n=n, n_pad=n_pad, n_loc=n_loc, halo=H)


def _prep_level(lev, n_sh: int):
    """One hierarchy level -> (:class:`ShardedLevel`, :class:`LevelMeta`,
    device rho estimate).  The meta's ``rho`` is a placeholder: the caller
    reads every level's estimate back at once and patches the metas."""
    slab, meta = shard_ell_slabs(lev.idx, lev.val, n_sh)
    dev = lev.idx.device
    nc_loc = -(-lev.n_coarse // n_sh)
    nc_pad = nc_loc * n_sh
    fill = meta.n_pad - meta.n
    diag = torch.cat([lev.diag.float(),
                      torch.ones((fill,), dtype=torch.float32, device=dev)])
    agg = torch.cat([lev.agg.to(torch.int32),
                     torch.full((fill,), nc_pad, dtype=torch.int32,
                                device=dev)])
    # each shard's CSR of aggregates over the full coarse range; padding
    # rows (aggregate nc_pad) sort last and belong to no aggregate
    agg_loc = agg.view(n_sh, meta.n_loc).long()
    perm = torch.argsort(agg_loc, dim=1, stable=True).to(torch.int32)
    counts = torch.stack([torch.bincount(a, minlength=nc_pad + 1)[:nc_pad]
                          for a in agg_loc])
    agg_ptr = torch.zeros((n_sh, nc_pad + 1), dtype=torch.int32, device=dev)
    agg_ptr[:, 1:] = torch.cumsum(counts, dim=1)
    # analysis: allow(sync-host-sync): build time, once a level: a loop bound
    agg_max = int(counts.max())
    rho_dev = estimate_dinv_rho_device(
        make_matvec(lev.idx, lev.val, "ref"), lev.diag)
    return (ShardedLevel(slab=slab, diag=diag, agg=agg, perm=perm,
                         agg_ptr=agg_ptr),
            LevelMeta(slab=meta, rho=0.0, nc=lev.n_coarse, nc_pad=nc_pad,
                      nc_loc=nc_loc, agg_max=agg_max),
            rho_dev)


def shard_aggregate_sums(resid, perm, agg_ptr, agg_max: int):
    """Every shard's ordered aggregate sums of its rows, ``[P, n_loc, k] ->
    [P, nc_pad, k]``: ``out[s, c]`` sums the members of aggregate ``c``
    among shard ``s``'s rows in ascending order, from zero, as
    :func:`repro_torch.kernels.ref.aggregate_sum_ref` sums one device's
    rows.  The shards run side by side, each with its own CSR; a shard
    whose aggregates are all done adds nothing more."""
    start = agg_ptr[:, :-1].long()
    counts = agg_ptr[:, 1:].long() - start
    perm_l = perm.long()
    k = resid.shape[-1]
    out = torch.zeros(counts.shape + (k,), dtype=resid.dtype,
                      device=resid.device)
    for t in range(agg_max):
        live = counts > t
        rows = torch.gather(perm_l, 1, torch.where(live, start + t, 0))
        vals = torch.gather(resid, 1, rows[..., None].expand(-1, -1, k))
        out = torch.where(live[..., None], out + vals, out)
    return out


def _local_matvec(slab: ShardedSlab, meta: SlabMeta, n_sh: int,
                  impl: str = "ref"):
    """Sharded ELL matvec ``[P, n_loc, k] -> [P, n_loc, k]``: one
    ``all_gather`` of ``x``, the halo gather, then each shard's
    contraction of ``x_ext = [x_loc; x[halo]]`` (``[n_loc + H, k]``): K1
    with ``impl="fused"``, its plain version with ``"ref"``."""
    spmv = spmv_ell_batched if impl == "fused" else kref.spmv_ell_batched_ref
    idx = slab.idx.view(n_sh, meta.n_loc, -1)
    val = slab.val.view(n_sh, meta.n_loc, -1)
    halo = slab.halo.view(n_sh, meta.halo).long()

    def mv(x):
        xg = all_gather(x, tiled=True)                     # [n_pad, k]
        x_ext = torch.cat([x, xg[halo]], dim=1)            # [P, n_loc + H, k]
        return torch.stack([spmv(idx[s], val[s], x_ext[s])
                            for s in range(n_sh)])

    return mv


def make_sharded_solver(idx, val, hierarchy: Optional[Hierarchy] = None,
                        precond: str = "hierarchy", *, mesh,
                        shard_axis: str = "data", degree: int = 2,
                        matvec_impl: Optional[str] = None, device="cuda"):
    """Build the mesh-sharded ``solve(b, tol, maxiter)`` closure.

    The contract of :func:`repro_torch.solver.device_pcg.make_solver`:
    global ``[n, k]`` right-hand sides in, :class:`BatchedPCGResult` out.
    ``matvec_impl`` is ``"fused"`` (K1 on each shard) or ``"ref"``;
    ``None`` picks by device.  ``precond`` is ``"hierarchy"`` or
    ``"none"``: ``"jacobi"`` is a single-device comparison baseline, not
    sharded.  Every shard lives on ``device``, the mesh's device."""
    device = torch.device(device)
    if matvec_impl is None:
        matvec_impl = default_matvec_impl(device)
    if matvec_impl not in ("ref", "fused"):
        raise ValueError(
            f"sharded matvec_impl must be 'ref' or 'fused', got "
            f"{matvec_impl!r}")
    if precond == "hierarchy" and hierarchy is None:
        raise ValueError("precond='hierarchy' needs a Hierarchy")
    if precond == "jacobi":
        raise NotImplementedError(
            "precond='jacobi' is a single-device comparison baseline — "
            "the sharded path supports 'hierarchy' and 'none'")
    if precond not in ("hierarchy", "none"):
        raise ValueError(f"unknown precond {precond!r}")
    mesh.check_device(device, "the solver")
    n_sh = int(mesh.shape[shard_axis])
    idx, val = idx.to(device), val.to(device)
    n = int(idx.shape[0])

    tracer = get_tracer()
    with tracer.span("sharded.shard_slabs", n=n, n_sh=n_sh):
        top_slab, top_meta = shard_ell_slabs(idx, val, n_sh)
    levels, level_meta = (), ()
    coarse_chol, coarse_n = None, n
    if precond == "hierarchy":
        for lev in hierarchy.levels:
            if lev.idx.device.type != device.type:
                raise ValueError(f"hierarchy lives on {lev.idx.device}, "
                                 f"the solver on {device}")
        with tracer.span("sharded.prep_levels",
                         levels=len(hierarchy.levels), n_sh=n_sh):
            prepped = [_prep_level(lev, n_sh) for lev in hierarchy.levels]
        levels = tuple(p[0] for p in prepped)
        # the one build-time sync: every level's estimate read back at once
        # analysis: allow(sync-host-sync): build time, once: the estimates
        rhos = torch.stack([p[2] for p in prepped]).tolist() if prepped \
            else []
        level_meta = tuple(p[1]._replace(rho=float(r))
                           for p, r in zip(prepped, rhos))
        coarse_chol = hierarchy.coarse_chol
        coarse_n = hierarchy.coarse_n
    ncs_loc = -(-coarse_n // n_sh)
    n_levels = len(levels)

    rows = torch.arange(top_meta.n_pad, device=device).view(
        n_sh, top_meta.n_loc, 1)
    true_row = rows < n

    def _colsum(v):
        # each shard folds its rows (all shards at once: the same adds),
        # then the partial sums are added in shard order
        return psum(colsum(v.transpose(0, 1)))

    def _pcenter(x):
        """Mean-zero over the TRUE rows (padding masked out); the shift
        lands on padding rows too, which are sliced away on the way out."""
        return x - _colsum(torch.where(true_row, x, 0.0)) / n

    matvec = _local_matvec(top_slab, top_meta, n_sh, matvec_impl)
    lev_mvs = [_local_matvec(ll.slab, lm.slab, n_sh, matvec_impl)
               for ll, lm in zip(levels, level_meta)]
    smoothers = [make_chebyshev_smoother(
        mv, ll.diag.view(n_sh, lm.slab.n_loc), lm.rho, degree=degree)
        for mv, ll, lm in zip(lev_mvs, levels, level_meta)]
    aggs = [torch.clamp(ll.agg, max=lm.nc_pad - 1).long().view(
        n_sh, lm.slab.n_loc) for ll, lm in zip(levels, level_meta)]

    def restrict(l, resid):
        """Each shard's ordered aggregate sums, then a psum in shard order;
        returns the coarse vector's shard blocks."""
        ll, lm = levels[l], level_meta[l]
        parts = shard_aggregate_sums(resid, ll.perm, ll.agg_ptr, lm.agg_max)
        return psum(parts).view(n_sh, lm.nc_loc, -1)

    def coarse(r):
        rg = all_gather(r, tiled=True)[:coarse_n]
        z = coarse_solve(rg, coarse_chol)                 # replicated
        zp = torch.zeros((n_sh * ncs_loc, r.shape[-1]), dtype=r.dtype,
                         device=r.device)
        zp[:coarse_n] = z
        return zp.view(n_sh, ncs_loc, -1)

    def cycle(l, r):
        if l == n_levels:
            with trace_annotation("sharded_vcycle.coarse"):
                return coarse(r)
        mv, smooth = lev_mvs[l], smoothers[l]
        with trace_annotation(f"sharded_vcycle.L{l}.down"):
            z = smooth(r)                                 # pre-smooth
            rc = restrict(l, r - mv(z))                   # restrict
        zc = cycle(l + 1, rc)                             # coarse correct
        with trace_annotation(f"sharded_vcycle.L{l}.up"):
            z = z + all_gather(zc, tiled=True)[aggs[l]]   # prolong
            return smooth(r, z)                           # post-smooth

    if precond == "hierarchy":
        def msolve(r):
            return _pcenter(cycle(0, r))
    else:
        def msolve(r):
            return r

    n_pad, n_loc = top_meta.n_pad, top_meta.n_loc

    def solve(b, tol=1e-5, maxiter=2000):
        b = _center(torch.as_tensor(b, dtype=torch.float32, device=device))
        k = b.shape[1]
        bp = torch.zeros((n_pad, k), dtype=b.dtype, device=device)
        bp[:n] = b
        with trace_annotation("sharded_pcg"):
            res = _pcg_loop(matvec, bp.view(n_sh, n_loc, k), msolve, tol,
                            maxiter, colsum=_colsum, center=_pcenter)
        return BatchedPCGResult(x=res.x.reshape(n_pad, k)[:n],
                                iters=res.iters, relres=res.relres,
                                converged=res.converged)

    return solve
