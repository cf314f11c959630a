"""Registry of the port's hot entry points, for the dispatch audit.

The port of ``repro.analysis.registry``.  Each :class:`HotEntry` names one
hot path and a builder: ``build(device)`` returns the callable, a *small*
argument tuple and a *sibling* tuple of the same RHS pow2 bucket (``k =
5`` and ``k = 7`` both pad to bucket 8 in the service, so both must run
the same aten op sequence for one CUDA graph to serve the bucket), or
``None`` where the bucket check does not apply.

The entries mirror what production traffic runs:

* ``batched_pcg`` — ``make_solver(precond="hierarchy")`` on the fused
  route, the service's single-device workhorse.
* ``vcycle_plain`` / ``vcycle_fused`` — the V-cycle closure alone, over
  the plain versions and over the fused route.  On the CPU both run the
  plain versions; on the card the fused one launches K1-K3.
* ``sharded_solver`` — ``make_sharded_solver`` on a 2-shard mesh.
* ``device_contraction`` — the propose/accept hierarchy contraction
  (``_device_contract_arrays``).
* ``harmonic_pcg`` — the Dirichlet-projected PCG of
  ``make_dirichlet_core``, the spectral plane's hot path.

A PCG entry runs at tol 0, so it runs exactly ``maxiter`` trips at any
width: ``trips_arg`` is the position of ``maxiter`` among its arguments,
which the audit sets to each of its trip counts.

The shared artifacts (mesh2d(12, 12, seed=0), its ELL slabs and its
hierarchy at ``coarse_n=16``) are built lazily, once per (process,
device).  Everything here is float32: ``declared_dtype`` is what the
audit's f64 rule enforces.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

#: the trip count a PCG entry's arguments carry; the audit also runs 2x it
AUDIT_TRIPS = 16


@dataclasses.dataclass(frozen=True)
class HotEntry:
    """One registered hot path.

    ``build(device)`` returns ``(fn, args_small, args_sibling)``;
    ``args_sibling`` is ``None`` when the bucket check does not apply.
    ``trips_arg`` is the position of a PCG entry's ``maxiter`` argument
    (``None``: the entry has no trip loop)."""

    name: str
    doc: str
    build: Callable[[torch.device], Tuple[Callable, tuple, Optional[tuple]]]
    declared_dtype: str = "float32"
    trips_arg: Optional[int] = None


@functools.lru_cache(maxsize=2)
def _shared_artifacts(device: str):
    """(graph, idx, val, hierarchy) of the registry's suite graph on
    ``device``: small enough to run in seconds, deep enough for a real
    multilevel V-cycle (mesh2d 12x12 -> 2+ levels at coarse_n=16)."""
    from repro_torch.core.graph import mesh2d
    from repro_torch.solver.device_pcg import ell_laplacian
    from repro_torch.solver.hierarchy import build_hierarchy

    g = mesh2d(12, 12, seed=0)
    idx, val = ell_laplacian(g, device=device)
    hier = build_hierarchy(g, coarse_n=16, device=device)
    return g, idx, val, hier


def _rhs(n: int, k: int, device) -> torch.Tensor:
    """A mean-zero ``[n, k]`` float32 right-hand side from seed 0."""
    b = np.random.RandomState(0).randn(n, k).astype(np.float32)
    b -= b.mean(axis=0, keepdims=True)
    return torch.as_tensor(b, device=device)


def _solve_args(n: int, device):
    return tuple((_rhs(n, k, device), 0.0, AUDIT_TRIPS) for k in (5, 7))


def _build_batched_pcg(device):
    from repro_torch.solver.device_pcg import make_solver
    g, idx, val, hier = _shared_artifacts(str(device))
    solve = make_solver(idx, val, hier, precond="hierarchy",
                        matvec_impl="fused", device=device)
    return (solve,) + _solve_args(g.n, device)


def _build_vcycle(impl: str, device):
    from repro_torch.solver.device_pcg import make_vcycle
    g, _, _, hier = _shared_artifacts(str(device))
    vcycle = make_vcycle(hier, matvec_impl=impl)
    return vcycle, (_rhs(g.n, 5, device),), (_rhs(g.n, 7, device),)


def _build_sharded_solver(device):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.solver.sharded import make_sharded_solver
    g, idx, val, hier = _shared_artifacts(str(device))
    mesh = make_mesh((2,), ("data",), device=device)
    solve = make_sharded_solver(idx, val, hier, precond="hierarchy",
                                mesh=mesh, matvec_impl="fused",
                                device=device)
    return (solve,) + _solve_args(g.n, device)


def _build_device_contraction(device):
    from repro_torch.core.device_graph import DeviceGraph
    from repro_torch.solver.hierarchy import _device_contract_arrays
    g, _, _, _ = _shared_artifacts(str(device))
    dg = DeviceGraph.from_graph(g, device=device)
    return _device_contract_arrays, (dg.n, dg.src, dg.dst, dg.weight), None


def _build_harmonic_pcg(device):
    from repro_torch.core.device_graph import DeviceGraph
    from repro_torch.spectral.harmonic import make_dirichlet_core
    g, _, _, _ = _shared_artifacts(str(device))
    solve = make_dirichlet_core(DeviceGraph.from_graph(g, device=device))
    interior = torch.as_tensor(
        (np.arange(g.n) >= g.n // 4).astype(np.float32), device=device)
    return (solve,) + tuple((interior,) + a for a in
                            _solve_args(g.n, device))


HOT_ENTRIES: Tuple[HotEntry, ...] = (
    HotEntry("batched_pcg",
             "make_solver batched PCG + V-cycle, fused route",
             _build_batched_pcg, trips_arg=2),
    HotEntry("vcycle_plain",
             "make_vcycle closure over the plain versions",
             functools.partial(_build_vcycle, "ref")),
    HotEntry("vcycle_fused",
             "make_vcycle closure, fused route (K1-K3 on the card)",
             functools.partial(_build_vcycle, "fused")),
    HotEntry("sharded_solver",
             "make_sharded_solver on a 2-shard mesh, fused route",
             _build_sharded_solver, trips_arg=2),
    HotEntry("device_contraction",
             "propose/accept hierarchy contraction (_device_contract_arrays)",
             _build_device_contraction),
    HotEntry("harmonic_pcg",
             "make_dirichlet_core projected PCG (spectral plane)",
             _build_harmonic_pcg, trips_arg=3),
)
