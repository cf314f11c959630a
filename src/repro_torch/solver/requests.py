"""Request-plane objects for the serving-grade solver API.

The port of ``repro.solver.requests``: numpy and threading only, a copy of
the reference's classes over the port's ``Graph``, ``PipelineConfig`` and
content fingerprint.  The ideas:

  * :class:`GraphHandle` / :class:`GraphStore` — register a graph once,
    pay its O(m) content hash once, and pass the handle on every request.
    The store dedupes by content digest, so two structurally identical
    graphs resolve to the same handle (and therefore the same cache keys).
  * :class:`SolveRequest` — a (graph-or-handle, rhs) pair plus its solve
    contract (``tol``/``maxiter``) and an optional per-request
    ``pipeline=PipelineConfig(...)`` override: requests with different
    stage mixes batch through one service and each hit their own cached
    hierarchy.
  * :class:`SolveTicket` — the future handed back by ``submit``.  Tickets
    are monotonically numbered per service (stable across flushes, unlike
    the v1 per-flush list indices), expose ``done()`` / ``result()``, and
    subclass ``int`` so v1 code that indexed the flush dict with the bare
    ticket keeps working unchanged.
  * :class:`AdmissionError` — raised by ``submit`` when a bounded scheduler
    (``SolverService(max_pending_columns=...)``) is over budget; callers
    back off or ``flush()`` and retry, instead of queueing unboundedly.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.core.graph import Graph, build_graph
from repro_torch.pipeline import PipelineConfig
from repro_torch.solver import cache as _cache
from repro_torch.solver.cache import content_fingerprint


@dataclasses.dataclass(frozen=True)
class GraphHandle:
    """A registered graph plus its memoized content digest.

    Handles are cheap value objects: equality/hash follow the fingerprint,
    so they key dicts and dedupe naturally.  Obtain them from
    :meth:`GraphStore.register` (or ``SolverService.register``).
    """

    graph: Graph
    fingerprint: str

    @property
    def n(self) -> int:
        return self.graph.n

    @property
    def m(self) -> int:
        return self.graph.m

    def __eq__(self, other) -> bool:
        return isinstance(other, GraphHandle) and \
            self.fingerprint == other.fingerprint

    def __hash__(self) -> int:
        return hash(self.fingerprint)

    def __repr__(self) -> str:
        return (f"GraphHandle(n={self.n}, m={self.m}, "
                f"fingerprint={self.fingerprint[:12]}...)")


class GraphStore:
    """Registry of content-addressed graphs behind a solver service.

    ``register`` is idempotent: re-registering the same graph object is a
    memo lookup, and registering a structurally identical copy returns the
    *existing* handle (one graph in the store, one set of cache entries).

    With ``persist_dir`` set the store survives restarts: every newly
    registered graph is written as ``<fingerprint>.npz`` (the canonical
    edge arrays, atomic tmp-file + ``os.replace`` write), and construction
    rehydrates every persisted graph back into handles.  The on-disk tier
    is bounded by ``max_entries`` / ``max_bytes`` (``None`` = unbounded)
    with least-recently-used eviction, exactly like the artifact disk
    tier: registering a graph whose file already exists refreshes its
    mtime, pruning evicts oldest-mtime files first, and the file just
    written is never the victim — a single graph larger than ``max_bytes``
    still persists.  Eviction only trims disk; live in-memory handles are
    untouched (a re-register of an evicted graph simply re-persists it).  Rehydration
    trusts the persisted digest (the filename, cross-checked against the
    digest stored *inside* the file) instead of re-hashing the edge
    arrays, so a restarted service hits its disk artifact cache with zero
    new ``hash_events`` — the whole point of persisting the store beside
    the artifact tier.  Torn or corrupt files (near-impossible given the
    atomic writes) are skipped, not fatal.

    Thread-safe: ``register``/``get`` may be called concurrently from
    producer threads feeding a background flusher.
    """

    def __init__(self, persist_dir: Optional[str] = None,
                 max_entries: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self._handles: Dict[str, GraphHandle] = {}
        self._lock = threading.Lock()
        self.hash_events = 0   # O(m) content hashes this store triggered
        self.persist_dir = persist_dir
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.persisted = 0     # graphs written to persist_dir by this store
        self.rehydrated = 0    # handles loaded from persist_dir at init
        self.persist_evictions = 0  # files pruned by the entries/bytes caps
        if persist_dir:
            os.makedirs(persist_dir, exist_ok=True)
            self._rehydrate()

    def _path(self, fingerprint: str) -> str:
        return os.path.join(self.persist_dir, f"{fingerprint}.npz")

    def _rehydrate(self) -> None:
        for name in sorted(os.listdir(self.persist_dir)):
            if not name.endswith(".npz"):
                continue
            fp = name[:-4]
            try:
                with np.load(self._path(fp)) as z:
                    stored_fp = str(z["fingerprint"])
                    if stored_fp != fp:
                        continue   # filename/content mismatch: ignore
                    g = build_graph(int(z["n"]), z["src"], z["dst"],
                                    z["weight"])
            except Exception:
                continue   # torn/corrupt/foreign file: skip, never crash
            # Adopt the persisted digest as the memo — no O(m) re-hash —
            # and freeze the arrays exactly like content_fingerprint does.
            object.__setattr__(g, "_content_fp", fp)
            for arr in (g.src, g.dst, g.weight):
                arr.flags.writeable = False
            self._handles[fp] = GraphHandle(graph=g, fingerprint=fp)
            self.rehydrated += 1

    def _disk_entries(self):
        """[(path, mtime, bytes)] for every graph file in ``persist_dir``."""
        out = []
        for name in os.listdir(self.persist_dir):
            if not name.endswith(".npz"):
                continue
            path = os.path.join(self.persist_dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue  # concurrently evicted by another process
            out.append((path, st.st_mtime, st.st_size))
        return out

    def _prune_disk(self, keep: str) -> None:
        """Evict least-recently-used graph files until under both caps;
        never evicts ``keep`` (the path just written/refreshed)."""
        if self.max_entries is None and self.max_bytes is None:
            return
        entries = sorted(self._disk_entries(), key=lambda e: e[1])
        total = sum(size for _, _, size in entries)
        count = len(entries)
        for path, _, size in entries:
            over = ((self.max_entries is not None
                     and count > self.max_entries)
                    or (self.max_bytes is not None
                        and total > self.max_bytes))
            if not over:
                break
            if path == keep:
                continue
            try:
                os.remove(path)
            except OSError:
                continue
            self.persist_evictions += 1
            count -= 1
            total -= size

    def _persist(self, handle: GraphHandle) -> None:
        path = self._path(handle.fingerprint)
        if os.path.exists(path):
            try:
                os.utime(path)  # refresh recency for mtime eviction
            except OSError:
                pass
            return
        g = handle.graph
        fd, tmp = tempfile.mkstemp(dir=self.persist_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, fingerprint=handle.fingerprint, n=g.n,
                         src=g.src, dst=g.dst, weight=g.weight)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        self.persisted += 1
        self._prune_disk(keep=path)

    def register(self, graph: Union[Graph, GraphHandle]) -> GraphHandle:
        if isinstance(graph, GraphHandle):
            with self._lock:
                handle = self._handles.setdefault(graph.fingerprint, graph)
                if self.persist_dir:
                    self._persist(handle)
                return handle
        if not isinstance(graph, Graph):
            raise TypeError(
                f"register wants a Graph or GraphHandle, got "
                f"{type(graph).__name__}")
        before = _cache.HASH_EVENTS
        fp = content_fingerprint(graph)
        with self._lock:
            self.hash_events += _cache.HASH_EVENTS - before
            handle = self._handles.get(fp)
            if handle is None:
                handle = GraphHandle(graph=graph, fingerprint=fp)
                self._handles[fp] = handle
            if self.persist_dir:
                self._persist(handle)
            return handle

    def get(self, fingerprint: str) -> Optional[GraphHandle]:
        with self._lock:
            return self._handles.get(fingerprint)

    def handles(self) -> List[GraphHandle]:
        """Snapshot of every registered handle (rehydrated ones included)."""
        with self._lock:
            return list(self._handles.values())

    def __len__(self) -> int:
        return len(self._handles)

    def __contains__(self, item) -> bool:
        """Content-based membership, mirroring ``register``'s dedup: a
        structurally identical Graph is "in" the store even if this
        particular object was never registered (its fingerprint is computed
        — and memoized — on demand)."""
        if isinstance(item, GraphHandle):
            return item.fingerprint in self._handles
        if isinstance(item, Graph):
            return content_fingerprint(item) in self._handles
        return item in self._handles

    @property
    def stats(self) -> dict:
        out = {"graphs": len(self._handles),
               "hash_events": self.hash_events}
        if self.persist_dir:
            entries = self._disk_entries()
            out.update({"persist_dir": self.persist_dir,
                        "persisted": self.persisted,
                        "rehydrated": self.rehydrated,
                        "persist_entries": len(entries),
                        "persist_bytes": sum(s for _, _, s in entries),
                        "persist_evictions": self.persist_evictions,
                        "max_entries": self.max_entries,
                        "max_bytes": self.max_bytes})
        return out


class AdmissionError(RuntimeError):
    """A submit was rejected because the scheduler's pending-column budget
    (``SolverService(max_pending_columns=...)``) would be exceeded.

    Carries the shape of the decision: ``pending`` columns already queued,
    ``requested`` columns in the rejected submit, and the ``budget``.
    """

    def __init__(self, pending: int, requested: int, budget: int,
                 tenant: Optional[str] = None):
        self.pending = pending
        self.requested = requested
        self.budget = budget
        self.tenant = tenant
        who = f"tenant {tenant!r}" if tenant is not None else "scheduler"
        super().__init__(
            f"admission rejected for {who}: {pending} column(s) pending + "
            f"{requested} requested > budget={budget} — "
            f"wait for the pending work to drain (or raise the budget) "
            f"and resubmit")


class DeadlineExceededError(RuntimeError):
    """A queued request expired before any flusher picked it up.

    Raised out of ``ticket.result()`` when a :class:`SolveRequest` carried
    ``deadline_ms`` and spent longer than that in the daemon's queue — the
    work was dropped unsolved (solving it would be wasted effort: the
    caller has already moved on).  Carries the contract and the overrun.
    """

    def __init__(self, ticket_id: int, deadline_ms: float, waited_ms: float,
                 tenant: Optional[str] = None):
        self.ticket_id = ticket_id
        self.deadline_ms = deadline_ms
        self.waited_ms = waited_ms
        self.tenant = tenant
        who = f" (tenant {tenant!r})" if tenant is not None else ""
        super().__init__(
            f"ticket {ticket_id}{who} expired in queue: waited "
            f"{waited_ms:.1f}ms against a {deadline_ms:.1f}ms deadline — "
            f"the daemon is saturated or the deadline is too tight")


@dataclasses.dataclass
class SolveRequest:
    """One Laplacian solve: ``L_G x = b`` under a per-request contract.

    ``graph`` may be a raw :class:`Graph` (v1 style — the service registers
    it on submit) or a :class:`GraphHandle`.  ``pipeline`` overrides the
    service-wide :class:`PipelineConfig` for this request only; requests
    with distinct configs are scheduled as separate groups sharing the
    flush.

    ``deadline_ms`` is a *queue-side* TTL honored by the daemon: a request
    still waiting in the queue that long past submit is expired with
    :class:`DeadlineExceededError` instead of being solved.  It bounds
    staleness, not solve time — once batched, a solve always completes.
    The synchronous service ignores it (flushes there happen on the
    caller's own thread, so there is no queue to go stale in).
    """

    graph: Union[Graph, GraphHandle]
    b: np.ndarray            # [n] or [n, k]
    tol: float = 1e-5
    maxiter: int = 2000
    pipeline: Optional[PipelineConfig] = None
    deadline_ms: Optional[float] = None


@dataclasses.dataclass
class SolveResponse:
    x: np.ndarray            # same trailing shape as the request's b
    iters: np.ndarray        # [k] per-column PCG iterations (all passes)
    relres: np.ndarray       # [k] f64-measured true relative residuals
    converged: bool
    cache: str               # "mem" | "disk" | "miss" (artifacts source)
    refinements: int         # mixed-precision refinement passes taken
    setup_ms: float          # hierarchy+ELL build (0.0 on a cache hit path)
    solve_ms: float
    config: str = ""         # digest of the PipelineConfig that served this


class SolveTicket(int):
    """Future for a submitted request.  ``done()`` says whether a flush has
    settled it (with a response or a failure); ``result()`` returns the
    :class:`SolveResponse` — or raises the group's build/solve exception —
    flushing the owning service first if the ticket is still pending.
    Tickets are resolvable in any order — each holds its own outcome.

    Tickets issued through a background flusher
    (:class:`~repro_torch.serve.solver_daemon.SolverDaemon`) carry a
    per-ticket ``threading.Event`` instead of a service back-ref:
    ``result(timeout=...)`` then *blocks* until the background flusher
    resolves the ticket (raising ``TimeoutError`` on expiry) — no caller
    ever triggers a flush.  ``done()`` stays non-blocking in both modes.

    Subclasses ``int`` (the service-wide monotonic ticket id), so v1 code
    doing ``svc.flush()[ticket]`` keeps working: flush dicts are keyed by
    these same objects and ints hash by value.
    """

    def __new__(cls, ticket_id: int, service=None,
                request: Optional[SolveRequest] = None):
        self = super().__new__(cls, ticket_id)
        self._service = service
        self._request = request
        self._response: Optional[SolveResponse] = None
        self._error: Optional[BaseException] = None
        self._event: Optional[threading.Event] = None
        self._resolved_at: Optional[float] = None  # time.perf_counter()
        return self

    @property
    def request(self) -> Optional[SolveRequest]:
        return self._request

    def done(self) -> bool:
        return self._response is not None or self._error is not None

    def error(self) -> Optional[BaseException]:
        """The exception that failed this ticket's group, if any."""
        return self._error

    def result(self, timeout: Optional[float] = None) -> SolveResponse:
        if not self.done():
            if self._event is not None:
                # Async (daemon) mode: block on the per-ticket event the
                # background flusher sets at resolution — never flush from
                # the caller's thread.
                if not self._event.wait(timeout):
                    raise TimeoutError(
                        f"ticket {int(self)} unresolved after {timeout}s — "
                        f"the daemon may be saturated or shut down")
            elif self._service is not None:
                if self._service._has_pending(self):
                    self._service.flush()
                else:
                    # The flush that should have settled this ticket already
                    # ran without it (stale ticket from a restarted service,
                    # or a ticket submitted to a *different* service).
                    # Flushing here would pointlessly solve unrelated
                    # pending work and still leave this ticket unresolved.
                    raise RuntimeError(
                        f"ticket {int(self)} is not pending on its service "
                        f"and was never resolved — it is stale (its flush "
                        f"already ran without it) or belongs to another "
                        f"service; re-submit the request")
        if self._error is not None:
            raise self._error
        if self._response is None:
            raise RuntimeError(
                f"ticket {int(self)} was not resolved by flush() — was it "
                f"submitted to this service?")
        return self._response

    def _resolve(self, response: SolveResponse) -> None:
        self._response = response
        self._resolved_at = time.perf_counter()
        if self._event is not None:
            self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._resolved_at = time.perf_counter()
        if self._event is not None:
            self._event.set()

    def __repr__(self) -> str:
        return f"SolveTicket({int(self)}, done={self.done()})"
