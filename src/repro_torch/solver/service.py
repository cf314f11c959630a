"""Request/response Laplacian solve engine with slot batching.

The port of ``repro.solver.service``, over the port's hierarchy and batched
PCG on ``device`` (default ``"cuda"``):

    svc = SolverService(pipeline=pdgrass_config(alpha=0.05))
    h = svc.register(g)                       # content hash paid ONCE
    t0 = svc.submit(SolveRequest(graph=h, b=b0))
    t1 = svc.submit(SolveRequest(graph=h, b=b1,
                                 pipeline=fegrass_config(alpha=0.05)))
    svc.flush()                               # one flush, two groups
    x0, x1 = t0.result().x, t1.result().x     # resolvable in any order

The scheduler groups pending requests by ``(graph_fingerprint,
config_fingerprint)``: all right-hand sides of a group stack into one
``[n, k]`` batch served by one batched device PCG against that group's
cached hierarchy, so pdGRASS- and feGRASS-preconditioned requests for the
same mesh coexist in one flush and each hit the right artifacts.
``warmup(handle, configs=[...])`` prefetches artifacts + solver closures
ahead of traffic; ``stats()`` snapshots the cache, store, scheduler, and
per-config solve counters.

RHS batches are padded to the next power of two, as in the reference, so a
group's batch takes one of a handful of widths (fixed slots, variable
occupancy); the padding columns are inert.

Departures from the reference: the TPU knobs ``interpret`` and ``tile_n``
are gone and ``device`` is new; a ``mesh`` must live on ``device``; with
no jit cache to inspect, ``warmup(widths=...)`` books a bucket's first warm-up
as its compile time (the reference's own fallback); artifacts are keyed
under their own schema tag, so a ``disk_dir`` shared with the reference
never aliases.

v1 compatibility: ``submit``/``solve`` still accept raw ``Graph``s (they
are registered on the fly), tickets subclass ``int`` so ``flush()[ticket]``
indexing keeps working, and ticket ids are service-wide monotonic — stable
across flushes instead of per-flush list positions.
"""
from __future__ import annotations

import collections
import copy
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.graph import Graph, col_mean
from repro_torch.kernels.laplacian_residual import (laplacian_residual,
                                                    upload_csr)
from repro_torch.obs import Metrics, get_metrics, get_tracer
from repro_torch.obs.device import trace_annotation
from repro_torch.pipeline import PipelineConfig, pdgrass_config
from repro_torch.pipeline import validate as validate_config
from repro_torch.solver import cache as cache_mod
from repro_torch.solver.cache import LRUCache, artifact_key, mesh_descriptor
from repro_torch.solver.device_pcg import (default_matvec_impl,
                                           ell_laplacian, make_solver)
from repro_torch.solver.hierarchy import build_hierarchy
from repro_torch.solver.requests import (AdmissionError, GraphHandle,
                                         GraphStore, SolveRequest,
                                         SolveResponse, SolveTicket)

# artifact schema tag of the port: bump on layout changes.  Distinct from
# every tag of the reference (``solver-v7``), so the two packages never
# read each other's artifacts from a shared disk_dir.
_SCHEMA = "solver-torch-v1"


def _next_pow2(k: int) -> int:
    p = 1
    while p < k:
        p *= 2
    return p


class SolverService:
    """Cached, batched sparsifier-preconditioned Laplacian solver."""

    def __init__(self, alpha: Optional[float] = None,
                 precond: str = "hierarchy",
                 coarse_n: int = 64, cache_capacity: int = 16,
                 disk_dir: Optional[str] = None,
                 disk_max_entries: Optional[int] = None,
                 disk_max_bytes: Optional[int] = None,
                 matvec_impl: Optional[str] = None,
                 max_refine: int = 3,
                 pipeline: Optional[PipelineConfig] = None,
                 store: Optional[GraphStore] = None,
                 store_max_entries: Optional[int] = None,
                 store_max_bytes: Optional[int] = None,
                 contraction: Optional[str] = None,
                 max_pending_columns: Optional[int] = None,
                 mesh=None, shard_axis: str = "data",
                 metrics: Optional[Metrics] = None,
                 device="cuda"):
        """``pipeline`` selects the default sparsification pipeline backing
        the preconditioner (any family member — pdGRASS, feGRASS, custom
        stage mixes); individual requests may override it with
        ``SolveRequest(pipeline=...)``.  When omitted, a pdGRASS config is
        built from ``alpha`` (default 0.05).  Passing both is a conflict:
        alpha lives inside the config.  ``store`` shares a
        :class:`GraphStore` between services;
        ``store_max_entries``/``store_max_bytes`` cap the default store's
        persisted ``graphstore/`` tier (mtime-LRU eviction, mirroring the
        artifact ``disk_max_*`` caps) and are a conflict with an explicit
        ``store`` — caps live on the store you build.

        ``contraction`` selects the hierarchy-build matching path
        (``"device"`` propose/accept rounds, ``"host"`` sequential oracle,
        or ``"sharded"`` rounds over ``mesh``; the default is
        ``"sharded"`` with a mesh, else ``"device"``); it participates in
        the artifact fingerprint, so the modes never share cache entries.
        ``max_pending_columns`` bounds the scheduler: a ``submit`` that
        would push the queued RHS column count past the budget raises
        :class:`AdmissionError` instead of growing the next flush without
        limit (``None`` = unbounded).

        ``mesh`` (a :class:`repro_torch.launch.Mesh` on ``device``)
        switches the solve plane onto its shards: solves run on
        :mod:`repro_torch.solver.sharded`, rows sharded over
        ``shard_axis``, and the mesh descriptor joins the artifact key, so
        mesh and single-device artifacts never alias.  ``precond="jacobi"``
        is single-device only and raises ``NotImplementedError`` with a
        mesh.

        ``matvec_impl`` selects the solve plane's kernel path — ``"fused"``
        (kernels K1-K3: batched spmv, fused Chebyshev step, fused
        restrict+residual), ``"kernel"`` (kernel K5, one launch per column)
        or ``"ref"`` (the plain PyTorch versions); ``None`` picks
        ``"fused"`` on a CUDA device and ``"ref"`` on the CPU
        (:func:`~repro_torch.solver.device_pcg.default_matvec_impl`).  The
        impl and the device type join the artifact key.

        ``device`` is where artifacts live and solves run: ``"cuda"`` by
        default, the CPU only when asked for (``device="cpu"``)."""
        if pipeline is not None and alpha is not None:
            raise ValueError(
                "pass either alpha or pipeline, not both — alpha is "
                "pipeline.alpha (use pipeline.replace(alpha=...))")
        if contraction is None:
            contraction = "sharded" if mesh is not None else "device"
        if contraction not in ("device", "host", "sharded"):
            raise ValueError(
                f"unknown contraction mode {contraction!r}; "
                f"want 'device', 'host' or 'sharded'")
        if contraction == "sharded" and mesh is None:
            raise ValueError("contraction='sharded' needs a mesh")
        if mesh is not None and precond == "jacobi":
            # fail at construction, not first flush: the sharded plane
            # supports 'hierarchy' and 'none'
            raise NotImplementedError(
                "precond='jacobi' is not supported with mesh= — "
                "use precond='hierarchy' or 'none'")
        if mesh is not None:
            mesh.check_device(device, "the service")
        self.pipeline = (pipeline if pipeline is not None
                         else pdgrass_config(
                             alpha=0.05 if alpha is None else alpha,
                             chunk=512))
        self.alpha = self.pipeline.alpha
        self.precond = precond
        self.coarse_n = coarse_n
        self.contraction = contraction
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.max_refine = max_refine
        self.max_pending_columns = max_pending_columns
        self.device = torch.device(device)
        self.matvec_impl = matvec_impl or default_matvec_impl(self.device)
        # With a disk tier configured, the default store persists beside it
        # (``<disk_dir>/graphstore/<fingerprint>.npz``): a restarted service
        # rehydrates its handles AND hits the persisted artifacts — no
        # caller re-registers edge arrays, no O(m) re-fingerprints.
        if store is None:
            store = GraphStore(
                persist_dir=(os.path.join(disk_dir, "graphstore")
                             if disk_dir else None),
                max_entries=store_max_entries, max_bytes=store_max_bytes)
        elif store_max_entries is not None or store_max_bytes is not None:
            raise ValueError(
                "store_max_entries/store_max_bytes configure the default "
                "store — with an explicit store=, set the caps on it "
                "(GraphStore(max_entries=..., max_bytes=...))")
        self.store = store
        # Per-service metrics registry (``solver.*`` / ``cache.*``
        # namespaces): two services never share counters, so fresh-service
        # stats start from zero.  Module-level instrumentation (pipeline,
        # hierarchy, distributed) lands in the process-wide registry and is
        # merged into ``stats()["metrics"]`` read-only.
        self.metrics = metrics if metrics is not None else Metrics()
        self.cache = LRUCache(capacity=cache_capacity, disk_dir=disk_dir,
                              disk_max_entries=disk_max_entries,
                              disk_max_bytes=disk_max_bytes,
                              metrics=self.metrics, device=self.device)
        # fingerprint -> solve closure, LRU-bounded (see _solver_for)
        self._solvers: "collections.OrderedDict[str, object]" = \
            collections.OrderedDict()
        # graph fingerprint -> its CSR on the device, K7's operands; LRU,
        # the closures' capacity (see _csr_for)
        self._csrs: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()
        # [(ticket, handle, request)] — the scheduler's input queue.
        # Guarded by _lock: submits may race the daemon's background
        # flusher (and each other) once a SolverDaemon wraps this service.
        self._pending: List[Tuple[SolveTicket, GraphHandle, SolveRequest]] = []
        self._pending_columns = 0
        self._next_ticket = 0
        # Canonical shared-state inventory, in the form the reference's
        # lock checker reads: every field below may only be touched inside
        # `with self._lock` or from a *_locked method.
        # lock: self._lock
        #   _pending _pending_columns _next_ticket _sched
        #   _solvers _csrs _warmed _conv_digests _solves_by_config
        self._lock = threading.RLock()
        # "submitted" counts admitted requests (rejected ones never enter
        # the queue), so submitted/rejected is the admission split.
        self._sched = {"submitted": 0, "flushes": 0, "groups": 0,
                       "requests_solved": 0, "group_failures": 0,
                       "rejected": 0}
        self._warmed: set = set()   # (key, k_pad) buckets warmup has run
        self._solves_by_config: "collections.Counter[str]" = \
            collections.Counter()
        # config digests with convergence histograms (see stats())
        self._conv_digests: set = set()

    # -- graph plane ---------------------------------------------------------

    def register(self, graph: Union[Graph, GraphHandle]) -> GraphHandle:
        """Register a graph with the service's store; the returned handle
        carries the memoized content fingerprint, so requests built from it
        never re-hash the edge arrays."""
        return self.store.register(graph)

    # -- artifact plane ------------------------------------------------------

    def _config_for(self, request: SolveRequest) -> PipelineConfig:
        return request.pipeline if request.pipeline is not None \
            else self.pipeline

    def _key(self, handle: GraphHandle, config: PipelineConfig) -> str:
        return artifact_key(handle.fingerprint, config, extra=(
            _SCHEMA, self.precond, self.coarse_n, self.contraction,
            self.matvec_impl, self.device.type,
            mesh_descriptor(self.mesh, self.shard_axis)))

    def artifacts(self, graph: Union[Graph, GraphHandle],
                  key: Optional[str] = None,
                  pipeline: Optional[PipelineConfig] = None):
        """(idx, val, hierarchy), source — cached pipeline steps 1-4 and the
        multilevel chain, keyed by (graph content, PipelineConfig, precond).

        ``pipeline`` defaults to the service-wide config; ``key`` lets the
        scheduler skip recomputing the group key it already holds."""
        handle = self.store.register(graph)
        config = pipeline if pipeline is not None else self.pipeline
        if key is None:
            key = self._key(handle, config)

        def build():
            g = handle.graph
            idx, val = ell_laplacian(g, device=self.device)
            hier = (build_hierarchy(g, config=config, coarse_n=self.coarse_n,
                                    contraction=self.contraction,
                                    mesh=self.mesh,
                                    shard_axis=self.shard_axis,
                                    device=self.device)
                    if self.precond == "hierarchy" else None)
            return idx, val, hier

        value, source = self.cache.get_or_build(key, build)
        return key, value, source

    def _lru(self, field: str, key, make):
        """``self.<field>[key]``, made by ``make()`` on a miss, in that
        LRU dict bounded to the artifact cache's capacity.  The dict is
        read and written only under the lock; ``make`` runs OUTSIDE it:
        it stages device arrays and can take a while, and holding _lock
        there would stall every submit."""
        with self._lock:
            od = getattr(self, field)
            value = od.get(key)
            if value is not None:
                od.move_to_end(key)
                return value
        value = make()
        with self._lock:
            od = getattr(self, field)
            # two racing builders: first insert wins, both get one value
            value = od.setdefault(key, value)
            od.move_to_end(key)
            while len(od) > self.cache.capacity:
                od.popitem(last=False)
            return value

    def _solver_for(self, key: str, artifacts):
        """Solve closures are process-local (not picklable), so they live
        beside — not inside — the artifact cache, LRU-bounded to the same
        capacity (each closure holds its level operators on the device)."""
        def make():
            idx, val, hier = artifacts
            with get_tracer().span("solver.setup"):
                return make_solver(idx, val, hierarchy=hier,
                                   precond=self.precond,
                                   matvec_impl=self.matvec_impl,
                                   mesh=self.mesh, shard_axis=self.shard_axis,
                                   device=self.device)

        return self._lru("_solvers", key, make)

    def _csr_for(self, handle: GraphHandle):
        """The graph's CSR on the device for the refinement's residual
        (K7), uploaded once a graph: keyed by the graph's fingerprint, so
        every config of a graph shares it, and LRU-bounded to the solve
        closures' capacity."""
        return self._lru("_csrs", handle.fingerprint,
                         lambda: upload_csr(handle.graph, device=self.device))

    def warmup(self, graph: Union[Graph, GraphHandle],
               configs: Optional[Sequence[PipelineConfig]] = None,
               widths: Optional[Sequence[int]] = None) -> Dict[str, str]:
        """Prefetch artifacts + solver closures for ``graph`` under each
        config (default: the service-wide one) ahead of traffic.  Returns
        ``{config_digest: artifact_source}`` — "miss" means built now,
        "mem"/"disk" mean the cache already held it.

        ``widths`` additionally warms the solve itself: for every requested
        RHS width the corresponding power-of-two slot bucket runs one
        zero-RHS solve (a zero column converges in zero iterations, so the
        cost is the first-call set-up: the kernel library's build and
        load, allocator growth), moving it out of the first real flush.
        Its wall time lands in the ``solver.warmup.compile_ms`` histogram
        of ``stats()["metrics"]`` (``solver.warmup.compiles`` counts them),
        booked once per bucket: there is no jit cache to inspect, so this
        is the reference's own fallback."""
        handle = self.register(graph)
        sources: Dict[str, str] = {}
        if widths is not None and any(int(w) < 1 for w in widths):
            raise ValueError(f"widths must be >= 1, got {list(widths)}")
        buckets = sorted({_next_pow2(int(w)) for w in (widths or ())})
        tracer = get_tracer()
        for config in (configs if configs is not None else [self.pipeline]):
            validate_config(config)
            key = self._key(handle, config)
            with tracer.span("solver.warmup", config=config.digest(),
                             buckets=buckets):
                _, artifacts, source = self.artifacts(handle, key=key,
                                                      pipeline=config)
                solve = self._solver_for(key, artifacts)
            sources[config.digest()] = source
            for k_pad in buckets:
                # Mirror the flush call signature ([n, k_pad] f32 rhs,
                # [k_pad] f32 tol, [k_pad] int32 maxiter).
                t0 = time.perf_counter()
                res = solve(
                    torch.zeros((handle.n, k_pad), dtype=torch.float32,
                                device=self.device),
                    tol=torch.full((k_pad,), 1e-5, dtype=torch.float32,
                                   device=self.device),
                    maxiter=torch.full((k_pad,), 1, dtype=torch.int32,
                                       device=self.device))
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                # First warm-up per bucket is booked as compile time;
                # re-warms never double-count.
                compile_ms = (time.perf_counter() - t0) * 1e3
                with self._lock:
                    compiled = (key, k_pad) not in self._warmed
                    self._warmed.add((key, k_pad))
                if compiled:
                    self.metrics.observe("solver.warmup.compile_ms",
                                         compile_ms)
                    self.metrics.inc("solver.warmup.compiles")
        return sources

    # -- request plane -------------------------------------------------------

    @staticmethod
    def _validate(request: SolveRequest) -> None:
        g = request.graph.graph if isinstance(request.graph, GraphHandle) \
            else request.graph
        b = np.asarray(request.b)
        if b.ndim not in (1, 2) or b.shape[0] != g.n:
            raise ValueError(
                f"rhs shape {b.shape} does not match graph with "
                f"{g.n} vertices (want [n] or [n, k])")
        # Validate in the f32 dtype the device solve actually runs in: this
        # catches NaN/inf in the input AND f64 magnitudes that overflow to
        # inf on the cast (both would silently poison the PCG iteration and
        # read back as non-convergence).
        with np.errstate(over="ignore"):
            finite = np.isfinite(b.astype(np.float32, copy=False)
                                 if b.dtype != np.float32 else b)
        if not finite.all():
            bad = int(b.size - finite.sum())
            raise ValueError(
                f"rhs contains {bad} value(s) that are non-finite in the "
                f"f32 solve precision (NaN/inf, or magnitude > f32 max) — "
                f"clean or rescale the rhs before submitting")
        if request.pipeline is not None:
            if not isinstance(request.pipeline, PipelineConfig):
                raise TypeError(
                    f"request.pipeline wants a PipelineConfig, got "
                    f"{type(request.pipeline).__name__}")
            validate_config(request.pipeline)
        if request.deadline_ms is not None and not request.deadline_ms > 0:
            raise ValueError(
                f"deadline_ms must be positive, got {request.deadline_ms}")

    def submit(self, request: SolveRequest) -> SolveTicket:
        """Queue a request; returns a :class:`SolveTicket` future resolved
        by the next flush() (or by ``ticket.result()``, which flushes).

        With ``max_pending_columns`` set, a submit whose RHS columns would
        push the queue past the budget raises :class:`AdmissionError`
        (counted in ``stats()["scheduler"]["rejected"]``) — backpressure
        instead of an unbounded flush."""
        self._validate(request)
        shape = np.shape(request.b)   # no copy — b may be device-resident
        cols = 1 if len(shape) == 1 else int(shape[1])
        handle = self.store.register(request.graph)
        with self._lock:
            if (self.max_pending_columns is not None
                    and self._pending_columns + cols
                    > self.max_pending_columns):
                self._sched["rejected"] += 1
                self.metrics.inc("solver.rejected")
                raise AdmissionError(self._pending_columns, cols,
                                     self.max_pending_columns)
            ticket = SolveTicket(self._next_ticket, service=self,
                                 request=request)
            self._next_ticket += 1
            self._sched["submitted"] += 1
            self._pending.append((ticket, handle, request))
            self._pending_columns += cols
        self.metrics.inc("solver.submitted")
        return ticket

    def _new_ticket(self, request: SolveRequest,
                    handle: Optional[GraphHandle] = None,
    ) -> Tuple[SolveTicket, GraphHandle]:
        """Validate + register + allocate a service-wide ticket id WITHOUT
        queueing: the entry point for external schedulers (the async daemon
        keeps its own fairness-ordered queue and hands batches straight to
        :meth:`_solve_batch`).  The ticket carries no service back-ref, so
        ``result()`` never triggers a caller-thread flush."""
        self._validate(request)
        if handle is None:
            handle = self.store.register(request.graph)
        with self._lock:
            ticket = SolveTicket(self._next_ticket, service=None,
                                 request=request)
            self._next_ticket += 1
        return ticket, handle

    def _has_pending(self, ticket: SolveTicket) -> bool:
        """Identity membership in the pending queue (``result()`` uses this
        to distinguish a flushable ticket from a stale/foreign one)."""
        with self._lock:
            return any(t is ticket for t, _, _ in self._pending)

    def flush(self) -> Dict[SolveTicket, SolveResponse]:
        """Solve everything pending — one batched PCG per distinct
        (graph, pipeline-config) group."""
        with self._lock:
            pending, self._pending = self._pending, []
            self._pending_columns = 0
            self._sched["flushes"] += 1
        self.metrics.inc("solver.flushes")
        with get_tracer().span("solver.flush", requests=len(pending)):
            return self._solve_batch(pending)

    def solve(self, graph: Union[Graph, GraphHandle], b: np.ndarray,
              tol: float = 1e-5, maxiter: int = 2000,
              pipeline: Optional[PipelineConfig] = None) -> SolveResponse:
        """Convenience single-request path.  Does NOT touch the pending
        queue — other submitted tickets stay queued for the next flush()."""
        req = SolveRequest(graph=graph, b=b, tol=tol, maxiter=maxiter,
                           pipeline=pipeline)
        ticket, handle = self._new_ticket(req)
        out = self._solve_batch([(ticket, handle, req)])
        if ticket not in out:      # single group: surface its failure
            raise ticket.error()
        return out[ticket]

    def stats(self) -> dict:
        """Snapshot of the serving planes: artifact cache (+ disk tier),
        graph store, scheduler counters, and per-config solve counts
        (keyed by ``PipelineConfig.digest()``).  ``store.hash_events``
        counts the O(m) content hashes this service's store triggered
        (``process_hash_events`` is the process-wide total) — traffic over
        registered graphs keeps both flat.

        Telemetry keys (see README "Observability"):

        * ``"metrics"`` — the flat namespaced registry: this service's
          ``solver.*`` / ``cache.*`` instruments merged over the
          process-wide ``pipeline.*`` / ``hierarchy.*`` / ``dist.*`` /
          ``store.hash_events`` ones (the namespaces are disjoint, so the
          merge never shadows).
        * ``"convergence"`` — per config digest: PCG iteration-count and
          final-relative-residual histograms plus setup/solve latency
          percentiles, observed once per flush group.

        The returned dict is a **deep copy**: callers may mutate it freely
        (diffing, annotating, json round-trips) without corrupting the
        service's live counters."""
        with self._lock:
            digests = sorted(self._conv_digests)
        convergence = {}
        for d in digests:
            convergence[d] = {
                "iters": self.metrics.histogram(
                    f"solver.pcg.iters.{d}").snapshot(),
                "relres": self.metrics.histogram(
                    f"solver.pcg.relres.{d}").snapshot(),
                "setup_ms": self.metrics.histogram(
                    f"solver.latency.setup_ms.{d}").snapshot(),
                "solve_ms": self.metrics.histogram(
                    f"solver.latency.solve_ms.{d}").snapshot(),
            }
        with self._lock:
            return copy.deepcopy({
                "cache": self.cache.stats,
                "store": {**self.store.stats,
                          "process_hash_events": cache_mod.HASH_EVENTS},
                "scheduler": {**self._sched, "pending": len(self._pending),
                              "pending_columns": self._pending_columns,
                              "max_pending_columns": self.max_pending_columns},
                "solves_by_config": dict(self._solves_by_config),
                "solvers": {"closures": len(self._solvers),
                            "capacity": self.cache.capacity},
                "hierarchy": {"contraction": self.contraction,
                              "precond": self.precond,
                              "matvec_impl": self.matvec_impl,
                              "device": str(self.device)},
                "mesh": {"descriptor": mesh_descriptor(self.mesh,
                                                       self.shard_axis)},
                "metrics": {**get_metrics().snapshot(),
                            **self.metrics.snapshot()},
                "convergence": convergence,
            })

    # -- scheduler -----------------------------------------------------------

    def _solve_batch(
        self, pending: List[Tuple[SolveTicket, GraphHandle, SolveRequest]],
    ) -> Dict[SolveTicket, SolveResponse]:
        groups: Dict[Tuple[str, str], List[int]] = {}
        keys: Dict[Tuple[str, str], str] = {}
        for i, (_, handle, req) in enumerate(pending):
            config = self._config_for(req)
            gid = (handle.fingerprint, config.fingerprint())
            if gid not in keys:
                keys[gid] = self._key(handle, config)
            groups.setdefault(gid, []).append(i)
        with self._lock:
            self._sched["groups"] += len(groups)
        self.metrics.inc("solver.groups", len(groups))

        # Groups fail independently: an exception while building or solving
        # one (graph, config) group fails only that group's tickets (their
        # result() re-raises it) — every other group still solves and
        # resolves.  A serving flush must never lose unrelated tickets.
        out: Dict[SolveTicket, SolveResponse] = {}
        for gid, members in groups.items():
            entries = [pending[i] for i in members]
            config = self._config_for(entries[0][2])
            try:
                solved = self._solve_group(entries, config, keys[gid])
            except Exception as e:
                with self._lock:
                    self._sched["group_failures"] += 1
                self.metrics.inc("solver.group_failures")
                for ticket, _, _ in entries:
                    ticket._fail(e)
                continue
            with self._lock:
                self._sched["requests_solved"] += len(entries)
                self._solves_by_config[config.digest()] += len(entries)
            self.metrics.inc("solver.requests_solved", len(entries))
            out.update(solved)
        return out

    def _solve_group(
        self, entries: List[Tuple[SolveTicket, GraphHandle, SolveRequest]],
        config: PipelineConfig, key: str,
    ) -> Dict[SolveTicket, SolveResponse]:
        """Build/fetch one (graph, config) group's artifacts and run its
        slot-batched solve, resolving every ticket in the group."""
        handle = entries[0][1]
        g = handle.graph
        config_digest = config.digest()
        tracer = get_tracer()
        with tracer.span("solver.group", config=config_digest,
                         n=g.n, requests=len(entries)) as group_span:
            return self._solve_group_inner(
                entries, config, key, g, config_digest, tracer, group_span)

    def _solve_group_inner(self, entries, config, key, g, config_digest,
                           tracer, group_span):
        """Body of :meth:`_solve_group`, factored out so the whole group —
        artifact fetch, batched solve, refinement — nests under one
        ``solver.group`` span."""
        handle = entries[0][1]
        with tracer.span("solver.artifacts", config=config_digest) as asp:
            t0 = time.perf_counter()
            _, artifacts, source = self.artifacts(handle, key=key,
                                                  pipeline=config)
            setup_ms = (time.perf_counter() - t0) * 1e3
            solve = self._solver_for(key, artifacts)
            asp.set(source=source)

        with tracer.span("solver.stage", requests=len(entries)):
            cols, owner = [], []       # owner[j] = (entry-idx, col-in-request)
            for e, (_, _, req) in enumerate(entries):
                b = np.asarray(req.b, dtype=np.float32)
                b = b[:, None] if b.ndim == 1 else b
                for j in range(b.shape[1]):
                    cols.append(b[:, j])
                    owner.append((e, j))
            k = len(cols)
            k_pad = _next_pow2(k)
            B = np.zeros((g.n, k_pad), np.float32)
            B[:, :k] = np.stack(cols, axis=1)
            # L is singular with nullspace = constants: only the mean-zero
            # component of b is solvable.  Center here so the residual
            # measurement below targets the solvable system (else the
            # unsolvable mean would read as non-convergence).
            B -= col_mean(B)
            # Per-column tolerance and iteration budget: each request keeps
            # its own contract even when batched with stricter/larger
            # neighbors.  Padding columns are inert BY CONSTRUCTION — tol=inf
            # and maxiter=0 mean they can never drive batched_pcg's while-loop
            # (done from iteration zero) nor the refinement pass (zero
            # remaining budget, relres 0 <= inf), independent of the separate
            # zero-RHS short-circuit.
            reqs = [req for _, _, req in entries]
            tol_col = np.full(k_pad, np.inf)
            maxiter_col = np.zeros(k_pad, np.int32)
            for j, (e, _) in enumerate(owner):
                tol_col[j] = reqs[e].tol
                maxiter_col[j] = reqs[e].maxiter
            # The f32 device solve floors around 1e-7 relative residual; ask
            # it only for what it can deliver and let the f64 refinement
            # passes close the rest (each pass multiplies the true residual
            # by ~inner_tol).  Per column: a loose-tol request batched with
            # a strict one stops at its own contract instead of riding along
            # to the group minimum.
            inner_tol = torch.as_tensor(
                np.maximum(tol_col, 1e-5).astype(np.float32),
                device=self.device)

        t0 = time.perf_counter()
        with tracer.span("solver.solve", k=k, k_pad=k_pad, n=g.n), \
                trace_annotation("solver.solve"):
            b_dev = torch.as_tensor(B, device=self.device)
            res = solve(b_dev, tol=inner_tol,
                        maxiter=torch.as_tensor(maxiter_col,
                                                device=self.device))
            x = res.x.to(torch.float64)
            iters = res.iters.cpu().numpy().copy()

        # Mixed-precision iterative refinement: the f32 solve hits its
        # attainable-accuracy floor on large/ill-conditioned graphs, so
        # measure the true residual in f64 and re-solve for the correction
        # until tol is genuinely met.  x, the residual and the correction
        # stay on the service's device: the residual and its column norms
        # are K7's over the graph's own CSR (on a CPU service its plain
        # version, the host's NumPy), and only the k_pad relative
        # residuals that the accept/stop rule reads come back each pass.
        def residual(x, pass_, bn=None):
            """``(r, r's column means, relres, bn)`` of ``x``; the first
            pass (``bn`` None) also measures ``b``'s norms ``bn``."""
            with tracer.span("solver.residual", k=k, pass_=pass_,
                             on=self.device.type):
                r, r_mean, r_norm, b_norm = laplacian_residual(
                    *self._csr_for(handle), b_dev, x,
                    with_b_norm=bn is None)
                if bn is None:
                    bn = torch.clamp(b_norm, min=np.finfo(np.float64).tiny)
                # the one read-back a pass: the k_pad relative residuals
                # that the accept/stop rule reads
                return r, r_mean, (r_norm / bn).cpu().numpy(), bn

        resid, resid_mean, relres, bn = residual(x, 0)
        refinements = 0
        while refinements < self.max_refine and np.any(relres > tol_col):
            rc = (resid - resid_mean).to(torch.float32)
            # corrections draw from each column's remaining budget; the
            # span ends on the read-back, as solver.solve's does
            with tracer.span("solver.refine", pass_=refinements + 1,
                             k=k, k_pad=k_pad), \
                    trace_annotation("solver.refine"):
                corr = solve(rc, tol=inner_tol,
                             maxiter=torch.as_tensor(np.maximum(
                                 maxiter_col - iters, 0),
                                 device=self.device))
                corr_iters = corr.iters.cpu().numpy()
            x_new = x + corr.x.to(torch.float64)
            resid_new, mean_new, relres_new, _ = residual(
                x_new, refinements + 1, bn)
            # accept per column whenever the correction improved it ...
            take = relres_new < relres
            on_dev = torch.as_tensor(take, device=self.device)
            x = torch.where(on_dev, x_new, x)
            resid = torch.where(on_dev, resid_new, resid)
            resid_mean = torch.where(on_dev, mean_new, resid_mean)
            halved = np.any(relres_new < 0.5 * relres)
            relres = np.where(take, relres_new, relres)
            iters = iters + corr_iters
            refinements += 1
            if not halved:
                break  # ... but stop once passes stall at the f32 floor
        x = x[:, :k].cpu().numpy()
        solve_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self._conv_digests.add(config_digest)
        conv = relres <= tol_col
        # Convergence telemetry, fetched ONCE per flush group from arrays
        # this path already materializes (iters/relres came back with the
        # solution — no extra device round-trip).  Padding columns are
        # excluded: only the k real right-hand sides count.
        m = self.metrics
        m.observe_many(f"solver.pcg.iters.{config_digest}",
                       np.asarray(iters[:k], dtype=np.float64))
        m.observe_many(f"solver.pcg.relres.{config_digest}",
                       np.asarray(relres[:k], dtype=np.float64))
        m.observe(f"solver.latency.setup_ms.{config_digest}", setup_ms)
        m.observe(f"solver.latency.solve_ms.{config_digest}", solve_ms)
        m.inc("solver.refinement_passes", refinements)
        if not bool(conv[:k].all()):
            m.inc("solver.unconverged_columns",
                  int(k - int(conv[:k].sum())))
        group_span.set(k=k, k_pad=k_pad, source=source,
                       refinements=refinements,
                       max_iters=int(np.max(iters[:k])) if k else 0,
                       converged=bool(conv[:k].all()))
        out: Dict[SolveTicket, SolveResponse] = {}
        for e, (ticket, _, req) in enumerate(entries):
            mine = [j for j, (ee, _) in enumerate(owner) if ee == e]
            xs = x[:, mine]
            if np.asarray(req.b).ndim == 1:
                xs = xs[:, 0]
            response = SolveResponse(
                x=xs, iters=iters[mine], relres=relres[mine],
                converged=bool(conv[mine].all()), cache=source,
                refinements=refinements, setup_ms=setup_ms,
                solve_ms=solve_ms, config=config_digest)
            ticket._resolve(response)
            out[ticket] = response
        return out
