"""Batched effective-resistance queries as a service endpoint.

The port of ``repro.spectral.resistance``.  Effective resistance
``R_eff(u, v) = (e_u - e_v)^T L^+ (e_u - e_v)`` is the core primitive of
spectral perturbation analysis — GRASS (arXiv 1911.04382) ranks edges by
it, and Spielman-Srivastava sampling needs it per edge.  The identity
``R_eff(u, v) = x_u - x_v`` where ``L x = e_u - e_v`` turns every query
into one Laplacian solve, which is exactly what the solver service
batches: ``q`` queries stack into a ``[n, q]`` RHS block solved by one
batched PCG against the cached hierarchy.

Three layers, thinnest on top:

  * :func:`effective_resistance` — the endpoint.  Accepts a
    :class:`~repro_torch.solver.service.SolverService` *or* a
    :class:`~repro_torch.serve.solver_daemon.SolverDaemon`, dedupes
    queries against a content-keyed :class:`ResistanceCache`, chunks large
    query sets (``chunk`` columns per request), and submits every chunk
    before resolving the first — all chunks of one call share a single
    flush group per ``(graph, config)``.
  * :func:`resistances_via_solver` — the same batched ±e_uv solves against
    a bare ``make_solver`` closure (no service, no cache); the building
    block for pipeline-internal consumers.
  * :func:`exact_offtree_resistances` / :func:`tree_preconditioned_solver`
    — real (not tree-approximated) resistances for the ``er_exact`` score
    stage: the full Laplacian solved with a V-cycle built over the
    *spanning tree* subgraph, so scoring never recurses into the pipeline
    it is configuring.  They take ``device=`` (default ``"cuda"``).
"""
from __future__ import annotations

import collections
import threading
from typing import Optional, Union

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.obs import get_tracer
from repro_torch.solver.requests import GraphHandle, SolveRequest


def _canonical_pairs(pairs) -> np.ndarray:
    """``[q, 2]`` int64 with ``u != v`` kept as given but order-normalized
    (``min, max``) — R_eff is symmetric, so (u, v) and (v, u) must share a
    cache entry and a solve column."""
    p = np.asarray(pairs, dtype=np.int64)
    if p.ndim == 1:
        p = p.reshape(1, 2)
    if p.ndim != 2 or p.shape[1] != 2:
        raise ValueError(f"pairs must be [q, 2] vertex pairs, got shape "
                         f"{p.shape}")
    return np.stack([np.minimum(p[:, 0], p[:, 1]),
                     np.maximum(p[:, 0], p[:, 1])], axis=1)


def pair_rhs(n: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``[n, q]`` float32 block of ±e_uv columns (+1 at ``u``, −1 at ``v``).

    Each column sums to zero, so it lies in ``range(L)`` exactly — no mass
    is lost to the centering the solver applies anyway.
    """
    q = len(u)
    B = np.zeros((n, q), dtype=np.float32)
    B[np.asarray(u), np.arange(q)] = 1.0
    B[np.asarray(v), np.arange(q)] -= 1.0
    return B


class ResistanceCache:
    """Content-keyed result cache for effective-resistance queries.

    Keys are ``(graph fingerprint, config digest, tol, u, v)`` — a value is
    reusable only under the same graph *content* and the same solve
    contract, which is the same invariant the artifact cache enforces one
    layer down.  Bounded LRU (``max_pairs`` entries, each one float);
    thread-safe so daemon-routed queries may share it.
    """

    def __init__(self, max_pairs: int = 1_000_000):
        self.max_pairs = int(max_pairs)
        self._data: "collections.OrderedDict[tuple, float]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._data)

    def lookup(self, keys) -> list:
        """Per-key ``float`` or ``None``; hits are LRU-refreshed."""
        out = []
        with self._lock:
            for k in keys:
                val = self._data.get(k)
                if val is None:
                    self.misses += 1
                else:
                    self._data.move_to_end(k)
                    self.hits += 1
                out.append(val)
        return out

    def insert(self, keys, values) -> None:
        with self._lock:
            for k, val in zip(keys, values):
                self._data[k] = float(val)
                self._data.move_to_end(k)
            while len(self._data) > self.max_pairs:
                self._data.popitem(last=False)
                self.evictions += 1

    @property
    def stats(self) -> dict:
        return {"pairs": len(self._data), "max_pairs": self.max_pairs,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


# Shared default cache: repeated queries for the same (graph, config, tol)
# across call sites hit it without any caller-side plumbing.  Pass an
# explicit ``cache=ResistanceCache(...)`` for isolation (benchmarks do).
_DEFAULT_CACHE = ResistanceCache()


def default_cache() -> ResistanceCache:
    return _DEFAULT_CACHE


def _service_of(svc):
    """The underlying :class:`SolverService` of a service-or-daemon, plus
    the submit callable routing through whichever plane was handed in."""
    inner = getattr(svc, "service", None)
    if inner is not None and hasattr(svc, "max_batch_delay_ms"):
        return inner, svc.submit        # SolverDaemon: async submit plane
    return svc, svc.submit              # SolverService: sync submit plane


def effective_resistance(svc, graph: Union[Graph, GraphHandle], pairs, *,
                         tol: float = 1e-7, maxiter: int = 2000,
                         chunk: int = 256,
                         pipeline=None,
                         cache: Optional[ResistanceCache] = None,
                         result_timeout: Optional[float] = None,
                         **submit_kw) -> np.ndarray:
    """Batched ``R_eff(u, v)`` queries against a solver service or daemon.

    ``pairs`` is ``[q, 2]`` (or a single ``(u, v)``); the return is ``[q]``
    float64 resistances in input order.  Self-pairs are 0 by definition and
    never solved.  Uncached queries are deduped, stacked into ±e_uv RHS
    blocks of ``chunk`` columns, and submitted *before* the first result is
    resolved — on a sync service the first ``result()`` flushes every chunk
    in one flush, and all chunks of one ``(graph, config)`` land in a
    single scheduler group either way.

    ``svc`` may be a :class:`SolverService` (lazy-flush path) or a
    :class:`SolverDaemon` (``submit_kw`` forwards e.g. ``tenant=...``;
    ``result_timeout`` bounds each blocking wait).  ``pipeline`` overrides
    the service-wide config per request, exactly as on ``SolveRequest``.
    The solves run on the service's device.
    """
    service, submit = _service_of(svc)
    handle = service.register(graph)
    p = _canonical_pairs(pairs)
    q = p.shape[0]
    if q and (p.min() < 0 or p.max() >= handle.n):
        raise ValueError(
            f"pair endpoints must be vertex ids in [0, {handle.n}), got "
            f"range [{p.min()}, {p.max()}]")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    cache = cache if cache is not None else _DEFAULT_CACHE
    config = pipeline if pipeline is not None else service.pipeline
    base = (handle.fingerprint, config.digest(), float(tol))
    metrics = service.metrics
    tracer = get_tracer()

    out = np.zeros(q, dtype=np.float64)
    keys = [base + (int(u), int(v)) for u, v in p]
    cached = cache.lookup(keys)
    todo: "collections.OrderedDict[tuple, list]" = collections.OrderedDict()
    for i, ((u, v), val) in enumerate(zip(p, cached)):
        if u == v:
            out[i] = 0.0
        elif val is not None:
            out[i] = val
            metrics.inc("spectral.resistance.cache_hits")
        else:
            todo.setdefault((int(u), int(v)), []).append(i)
    metrics.inc("spectral.resistance.queries", q)

    with tracer.span("spectral.resistance", pairs=q, misses=len(todo),
                     chunk=chunk) as sp:
        if todo:
            uniq = np.asarray(list(todo), dtype=np.int64)   # [t, 2] deduped
            tickets = []
            for lo in range(0, uniq.shape[0], chunk):
                part = uniq[lo:lo + chunk]
                B = pair_rhs(handle.n, part[:, 0], part[:, 1])
                tickets.append((part, submit(SolveRequest(
                    graph=handle, b=B, tol=tol, maxiter=maxiter,
                    pipeline=pipeline), **submit_kw)))
            metrics.inc("spectral.resistance.requests", len(tickets))
            metrics.inc("spectral.resistance.solved_columns", uniq.shape[0])
            for part, ticket in tickets:
                res = ticket.result(result_timeout) if result_timeout \
                    is not None else ticket.result()
                x = np.asarray(res.x, dtype=np.float64)
                x = x[:, None] if x.ndim == 1 else x
                cols = np.arange(part.shape[0])
                r_vals = x[part[:, 0], cols] - x[part[:, 1], cols]
                cache.insert([base + (int(u), int(v)) for u, v in part],
                             r_vals)
                for (u, v), r in zip(part, r_vals):
                    for i in todo[(int(u), int(v))]:
                        out[i] = r
        sp.set(requests=0 if not todo else
               int(np.ceil(len(todo) / chunk)))
    return out


def resistances_via_solver(solve, n: int, u, v, *, tol: float = 1e-6,
                           maxiter: int = 2000,
                           chunk: int = 512) -> np.ndarray:
    """``R_eff`` for vertex pairs against a bare solve closure
    (:func:`repro_torch.solver.device_pcg.make_solver` signature, on the
    closure's own device) — the service-free path used inside the
    pipeline, chunked so arbitrarily many queries never materialize one
    giant RHS block."""
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    q = u.shape[0]
    out = np.zeros(q, dtype=np.float64)
    for lo in range(0, q, chunk):
        uu, vv = u[lo:lo + chunk], v[lo:lo + chunk]
        k = uu.shape[0]
        res = solve(pair_rhs(n, uu, vv), tol=float(tol), maxiter=int(maxiter))
        x = res.x.cpu().numpy().astype(np.float64)
        cols = np.arange(k)
        out[lo:lo + chunk] = x[uu, cols] - x[vv, cols]
    return out


def tree_preconditioned_solver(graph: Graph, in_tree: np.ndarray, *,
                               coarse_n: int = 64, device="cuda"):
    """A solve closure for ``L_G x = b`` on ``device``, preconditioned by a
    V-cycle built over the *spanning tree* subgraph.

    The tree is already in hand when scores are computed (pipeline step 1),
    its hierarchy is cheap (a tree stays ultra-sparse under contraction),
    and — critically — building it runs the pipeline on a graph with zero
    off-tree edges, so the score stage is never re-entered: ``er_exact``
    can use this solver without recursing into itself.
    """
    from repro_torch.solver.device_pcg import ell_laplacian, make_solver
    from repro_torch.solver.hierarchy import build_hierarchy, subgraph

    tree_g = subgraph(graph, np.asarray(in_tree, dtype=bool))
    idx, val = ell_laplacian(graph, device=device)  # the FULL Laplacian
    hier = build_hierarchy(tree_g, coarse_n=coarse_n, device=device)
    return make_solver(idx, val, hierarchy=hier, device=device)


def exact_offtree_resistances(graph: Graph, in_tree: np.ndarray, u, v, *,
                              tol: float = 1e-6, maxiter: int = 2000,
                              chunk: int = 512, device="cuda") -> np.ndarray:
    """Real ``R_G(u, v)`` for the off-tree edges, via batched solves on the
    spanning-tree-preconditioned solver — the ``er_exact`` score stage's
    engine.  Unlike the tree resistance ``R_T`` (an upper bound that can
    badly over-rank edges shortcut by other off-tree edges), these are the
    true leverage-score resistances of the full graph."""
    with get_tracer().span("spectral.er_exact", m_off=int(len(u))):
        solve = tree_preconditioned_solver(graph, in_tree, device=device)
        return resistances_via_solver(solve, graph.n, u, v, tol=tol,
                                      maxiter=maxiter, chunk=chunk)
