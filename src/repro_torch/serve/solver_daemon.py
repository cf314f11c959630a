"""Async serving runtime: a background flusher daemon over SolverService.

The port of ``repro.serve.solver_daemon``.  The request plane batches on
the *caller's* thread: ``SolveTicket.result()`` triggers a synchronous
``flush()``.  The daemon serves without any caller-side flush:

    svc = SolverService(disk_dir="cache")          # device="cuda"
    daemon = SolverDaemon(svc, max_batch_delay_ms=25.0,
                          tenants={"paid": TenantConfig(max_pending_columns=256,
                                                        weight=4.0),
                                   "free": TenantConfig(max_pending_columns=64)})
    h = svc.register(g)
    t = daemon.submit(SolveRequest(graph=h, b=b), tenant="paid")
    x = t.result(timeout=1.0).x                    # no flush() anywhere
    daemon.close()                                 # drains, then stops

Three mechanisms, one thread:

  * **Deadline + size batching.**  A background flusher thread sleeps until
    the oldest queued request's deadline (``submit time +
    max_batch_delay_ms``) or until ``max_batch_columns`` RHS columns are
    queued, whichever comes first, then drains a batch through the
    service's (graph, config)-group scheduler.  Requests carrying
    ``SolveRequest(deadline_ms=...)`` get a queue-side TTL: an entry still
    queued that long past submit is *expired* — failed with a typed
    :class:`~repro_torch.solver.requests.DeadlineExceededError` instead of
    solved.  Groups fail independently, so one tenant's poisoned request
    never loses another's tickets across the thread boundary.
  * **Multi-tenant fairness.**  ``submit(request, tenant=...)`` enforces
    per-tenant pending-column budgets (typed :class:`AdmissionError` with
    tenant context) and weighted priority lanes.  Batch selection is
    starvation-free: every tenant with queued work contributes its oldest
    entry to every cycle (tenants ordered oldest-deadline-first), then the
    remaining column budget fills by weighted deficit round-robin.
  * **Event-resolved tickets.**  Daemon tickets carry a per-ticket
    ``threading.Event``: ``result(timeout=...)`` blocks until the flusher
    resolves them, ``done()`` stays non-blocking, and ``close(drain=True)``
    settles every queued ticket deterministically (``drain=False`` fails
    them with :class:`DaemonShutdownError` instead — never a hang).

The daemon solves where its service does: on the card unless the service
was made with ``device="cpu"``.  The synchronous ``service.submit`` /
``flush`` path keeps working beside it, so two threads may build
hierarchies at once; the kernels' launch protocol holds under that
(:mod:`repro_torch.kernels.similarity`).

Observability (all in the service's metrics registry, ``serve.*``): a
``serve.flush_cycle`` span per cycle, a ``serve.queue_depth`` gauge,
``serve.queue_wait_ms`` / ``serve.e2e_ms`` latency histograms, and a
``serve.slo_violations`` counter incremented when a flush group's
end-to-end latency exceeds the ``max_batch_delay_ms``-derived budget.
"""
from __future__ import annotations

import copy
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.obs import get_tracer
from repro_torch.solver.requests import (AdmissionError,
                                         DeadlineExceededError, GraphHandle,
                                         SolveRequest, SolveTicket)
from repro_torch.solver.service import SolverService


class DaemonShutdownError(RuntimeError):
    """The daemon was closed (``drain=False``) before this ticket's batch
    ran; the request was never solved and should be re-submitted elsewhere."""


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """Per-tenant admission + scheduling policy.

    ``max_pending_columns`` bounds the tenant's queued RHS columns (``None``
    = unbounded); ``weight`` scales its share of each size-limited batch
    (weight 2 drains twice the columns of weight 1 under contention —
    starvation-freedom holds at any weight, the guaranteed floor is one
    entry per cycle)."""

    max_pending_columns: Optional[int] = None
    weight: float = 1.0

    def __post_init__(self):
        if not self.weight > 0:
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")


@dataclasses.dataclass
class _Lane:
    """Mutable runtime state of one tenant."""

    config: TenantConfig
    pending_columns: int = 0
    credit: float = 0.0          # weighted deficit counter (see _select)
    submitted: int = 0
    rejected: int = 0
    solved: int = 0
    failed: int = 0
    expired: int = 0             # queue-side TTL expiries (deadline_ms)


@dataclasses.dataclass
class _Entry:
    """One queued request with its serving metadata."""

    ticket: SolveTicket
    handle: GraphHandle
    request: SolveRequest
    tenant: str
    cols: int
    t_submit: float              # daemon clock
    deadline: float              # t_submit + max_batch_delay
    expiry: Optional[float] = None  # t_submit + deadline_ms (queue TTL)


class SolverDaemon:
    """Background flusher with deadline/size batching and tenant fairness.

    Wraps (does not replace) a :class:`SolverService`: ``submit`` goes to
    the daemon, everything else — registration, warmup, stats, the cache
    and store planes — stays on the service.  One daemon per service; the
    synchronous ``service.submit``/``flush`` path keeps working beside it
    (separate queues), but daemon traffic never requires it.

    ``clock`` is injectable (monotonic seconds) for deterministic tests.
    """

    def __init__(self, service: SolverService,
                 max_batch_delay_ms: float = 25.0,
                 max_batch_columns: Optional[int] = None,
                 tenants: Optional[Dict[str, TenantConfig]] = None,
                 default_tenant: str = "default",
                 slo_budget_ms: Optional[float] = None,
                 autostart: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        if max_batch_delay_ms <= 0:
            raise ValueError(
                f"max_batch_delay_ms must be > 0, got {max_batch_delay_ms}")
        if max_batch_columns is not None and max_batch_columns < 1:
            raise ValueError(
                f"max_batch_columns must be >= 1, got {max_batch_columns}")
        self.service = service
        self.max_batch_delay_ms = float(max_batch_delay_ms)
        self.max_batch_columns = max_batch_columns
        self.default_tenant = default_tenant
        # SLO budget: queueing is bounded by max_batch_delay_ms, so the
        # end-to-end target defaults to a small multiple of it (queue wait
        # + batched solve + readback); override for explicit latency SLOs.
        self.slo_budget_ms = (float(slo_budget_ms) if slo_budget_ms is not None
                              else 4.0 * self.max_batch_delay_ms)
        self._clock = clock
        self.device = service.device
        # Canonical shared-state inventory, machine-checked by
        # repro_torch.analysis.lock_lint: every field below may only be
        # touched inside `with self._cond` or from a *_locked method (the
        # Condition wraps an RLock, so nested acquisition is fine).
        # lock: self._cond
        #   _queue _pending_columns _lanes _closed _drain_on_close
        #   _thread _cycles _triggers _slo_violations _expired
        self._cond = threading.Condition()
        self._queue: List[_Entry] = []
        self._pending_columns = 0
        self._lanes: Dict[str, _Lane] = {}
        for name, cfg in (tenants or {}).items():
            if not isinstance(cfg, TenantConfig):
                raise TypeError(
                    f"tenants[{name!r}] wants a TenantConfig, got "
                    f"{type(cfg).__name__}")
            self._lanes[name] = _Lane(config=cfg)
        self._closed = False
        self._drain_on_close = True
        self._thread: Optional[threading.Thread] = None
        self._cycles = 0
        self._triggers = {"deadline": 0, "size": 0, "drain": 0}
        self._slo_violations = 0
        self._expired = 0
        if autostart:
            self.start()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "SolverDaemon":
        """Start the flusher thread (idempotent)."""
        with self._cond:
            if self._closed:
                raise RuntimeError("daemon is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="solver-daemon-flusher",
                    daemon=True)
                self._thread.start()
        return self

    @property
    def running(self) -> bool:
        with self._cond:
            thread = self._thread
        return thread is not None and thread.is_alive()

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop the daemon deterministically.  ``drain=True`` runs one
        final cycle over everything queued (every ticket resolves or
        carries its group's failure); ``drain=False`` fails queued tickets
        with :class:`DaemonShutdownError`.  Idempotent."""
        with self._cond:
            if self._closed:
                thread = self._thread
            else:
                self._closed = True
                self._drain_on_close = drain
                thread = self._thread
                self._cond.notify_all()
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                raise TimeoutError(
                    f"daemon flusher did not stop within {timeout}s")
        else:
            # never started (autostart=False): settle the queue inline
            self._shutdown_queue()

    def __enter__(self) -> "SolverDaemon":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc[0] is None)

    # -- request plane -------------------------------------------------------

    def _lane_locked(self, tenant: str) -> _Lane:
        lane = self._lanes.get(tenant)
        if lane is None:
            lane = self._lanes[tenant] = _Lane(config=TenantConfig())
        return lane

    def submit(self, request: SolveRequest,
               tenant: Optional[str] = None) -> SolveTicket:
        """Queue a request under ``tenant``'s lane; returns a ticket whose
        ``result(timeout=...)`` blocks until the background flusher
        resolves it — no caller ever flushes.

        Raises :class:`AdmissionError` (with ``.tenant`` set) when the
        tenant's pending-column budget would be exceeded: backpressure is
        per tenant, so one tenant hitting its budget never blocks another.
        """
        tenant = tenant if tenant is not None else self.default_tenant
        # Validate + register + allocate the ticket id outside the daemon
        # lock (registration may hash a new graph's edge arrays).
        ticket, handle = self.service._new_ticket(request)
        cols = request.b.shape[1] if getattr(request.b, "ndim", 1) == 2 else 1
        metrics = self.service.metrics
        with self._cond:
            if self._closed:
                raise RuntimeError(
                    "daemon is closed — submit to a live daemon or use the "
                    "synchronous service.submit()/flush() path")
            lane = self._lane_locked(tenant)
            budget = lane.config.max_pending_columns
            if budget is not None and lane.pending_columns + cols > budget:
                lane.rejected += 1
                metrics.inc("serve.rejected")
                metrics.inc(f"serve.tenant.{tenant}.rejected")
                raise AdmissionError(lane.pending_columns, cols, budget,
                                     tenant=tenant)
            ticket._event = threading.Event()
            now = self._clock()
            self._queue.append(_Entry(
                ticket=ticket, handle=handle, request=request, tenant=tenant,
                cols=cols, t_submit=now,
                deadline=now + self.max_batch_delay_ms / 1e3,
                expiry=(now + request.deadline_ms / 1e3
                        if request.deadline_ms is not None else None)))
            lane.pending_columns += cols
            lane.submitted += 1
            self._pending_columns += cols
            metrics.set_gauge("serve.queue_depth", len(self._queue))
            self._cond.notify_all()
        metrics.inc("serve.submitted")
        return ticket

    # -- flusher loop --------------------------------------------------------

    def _size_ready_locked(self) -> bool:
        return (self.max_batch_columns is not None
                and self._pending_columns >= self.max_batch_columns)

    def _expire_locked(self, now: float) -> None:
        """Queue-side TTL sweep: fail every still-queued entry whose
        ``deadline_ms`` expiry has passed with a typed
        :class:`DeadlineExceededError`, without solving it.  Runs under the
        condition lock; ``_fail`` only sets the ticket's outcome + event,
        so waking waiters from here is safe."""
        expired = [e for e in self._queue
                   if e.expiry is not None and e.expiry <= now]
        if not expired:
            return
        dead = set(id(e) for e in expired)
        self._queue = [e for e in self._queue if id(e) not in dead]
        metrics = self.service.metrics
        for e in expired:
            self._charge_locked(e)
            lane = self._lanes[e.tenant]
            lane.expired += 1
            self._expired += 1
            metrics.inc("serve.expired")
            metrics.inc(f"serve.tenant.{e.tenant}.expired")
            e.ticket._fail(DeadlineExceededError(
                int(e.ticket), e.request.deadline_ms,
                (now - e.t_submit) * 1e3, tenant=e.tenant))
        metrics.set_gauge("serve.queue_depth", len(self._queue))

    def _run(self) -> None:
        while True:
            with self._cond:
                trigger = None
                while trigger is None:
                    if self._closed:
                        trigger = "drain"
                        break
                    if not self._queue:
                        self._cond.wait()
                        continue
                    now = self._clock()
                    self._expire_locked(now)
                    if not self._queue:
                        continue
                    if self._size_ready_locked():
                        trigger = "size"
                        break
                    # Sleep until the batch deadline OR the earliest TTL
                    # expiry, whichever is sooner — an expiry must not wait
                    # out a longer batch window to be honored.
                    wake = self._queue[0].deadline
                    for e in self._queue:
                        if e.expiry is not None and e.expiry < wake:
                            wake = e.expiry
                    wait = wake - now
                    if wait <= 0:
                        # every expiry <= now was just swept, so an overdue
                        # wake-up time can only be the batch deadline
                        trigger = "deadline"
                        break
                    self._cond.wait(wait)
                if trigger == "drain":
                    break   # settle the remaining queue below, then exit
                batch = self._select_batch_locked()
            if batch:
                self._run_cycle(batch, trigger)
        self._shutdown_queue()

    def _shutdown_queue(self) -> None:
        """Settle whatever is still queued at close time: one final drain
        cycle, or a deterministic failure of every ticket."""
        with self._cond:
            # honor TTLs one last time: entries already past deadline get
            # the precise DeadlineExceededError, not a generic shutdown one
            self._expire_locked(self._clock())
            batch, self._queue = self._queue, []
            for e in batch:
                self._charge_locked(e)
            self.service.metrics.set_gauge("serve.queue_depth", 0)
            drain = self._drain_on_close
        if not batch:
            return
        if drain:
            self._run_cycle(batch, "drain")
        else:
            err = DaemonShutdownError(
                f"daemon closed with drain=False — {len(batch)} queued "
                f"ticket(s) failed without solving")
            with self._cond:
                for e in batch:
                    self._lanes[e.tenant].failed += 1
            for e in batch:
                e.ticket._fail(err)
            self.service.metrics.inc("serve.shutdown_failed", len(batch))

    def _charge_locked(self, e: _Entry) -> None:
        """Remove ``e``'s columns from the queue accounting (called when an
        entry leaves the queue for a cycle)."""
        self._pending_columns -= e.cols
        self._lanes[e.tenant].pending_columns -= e.cols

    def _select_batch_locked(self) -> List[_Entry]:
        """Pick this cycle's entries from the queue, fairly across tenants.

        Unbounded (``max_batch_columns=None``): take everything — the
        deadline already fired, and the group scheduler splits the batch.

        Bounded: two passes.  (1) *Starvation guard* — every tenant with
        queued work contributes its oldest entry, tenants visited
        oldest-deadline-first, regardless of the column budget: no tenant
        can be excluded from a flush window by another's flood.  (2)
        *Weighted fill* — remaining budget fills by deficit round-robin:
        each cycle a lane earns credit proportional to its weight, paying
        ``cols / weight`` per selected entry (heavier lanes drain more
        columns per cycle); credit persists across cycles so short-changed
        lanes catch up.  Ties break toward the oldest deadline.
        """
        if self.max_batch_columns is None:
            batch, self._queue = self._queue, []
            for e in batch:
                self._charge_locked(e)
            self.service.metrics.set_gauge("serve.queue_depth", 0)
            return batch
        by_tenant: Dict[str, List[_Entry]] = {}
        for e in self._queue:            # queue is submit-ordered: each
            by_tenant.setdefault(e.tenant, []).append(e)   # lane list FIFO
        selected: List[_Entry] = []
        cols = 0
        for t in sorted(by_tenant, key=lambda t: by_tenant[t][0].deadline):
            e = by_tenant[t].pop(0)
            selected.append(e)
            cols += e.cols
            self._lanes[t].credit += self._lanes[t].config.weight
        while cols < self.max_batch_columns:
            live = [t for t, es in by_tenant.items() if es]
            if not live:
                break
            t = max(live, key=lambda t: (self._lanes[t].credit,
                                         -by_tenant[t][0].deadline))
            e = by_tenant[t].pop(0)
            selected.append(e)
            cols += e.cols
            self._lanes[t].credit -= e.cols / self._lanes[t].config.weight
        chosen = set(id(e) for e in selected)
        self._queue = [e for e in self._queue if id(e) not in chosen]
        for e in selected:
            self._charge_locked(e)
        self.service.metrics.set_gauge("serve.queue_depth", len(self._queue))
        return selected

    def _run_cycle(self, batch: List[_Entry], trigger: str) -> None:
        """Solve one selected batch through the service's group scheduler
        and account latencies/SLO per entry.  Runs on the flusher thread;
        per-group failure isolation comes from ``_solve_batch`` itself
        (a failed group fails only its own tickets)."""
        metrics = self.service.metrics
        tracer = get_tracer()
        t_start = self._clock()
        with self._cond:
            cycle = self._cycles
            self._cycles += 1
            self._triggers[trigger] += 1
        for e in batch:
            metrics.observe("serve.queue_wait_ms",
                            (t_start - e.t_submit) * 1e3)
        with tracer.span("serve.flush_cycle", cycle=cycle, trigger=trigger,
                         requests=len(batch),
                         columns=sum(e.cols for e in batch),
                         tenants=len({e.tenant for e in batch})) as sp:
            self.service._solve_batch(
                [(e.ticket, e.handle, e.request) for e in batch])
            sp.set(queue_wait_ms=round((t_start - batch[0].t_submit) * 1e3, 3))
        t_end = self._clock()
        metrics.inc("serve.cycles")
        # Per-entry end-to-end latency; SLO violations counted per
        # (graph, config) group — the unit the scheduler dispatches — when
        # the group's slowest member blows the delay-derived budget.
        group_worst: Dict[tuple, float] = {}
        with self._cond:
            for e in batch:
                e2e_ms = (t_end - e.t_submit) * 1e3
                metrics.observe("serve.e2e_ms", e2e_ms)
                metrics.observe(f"serve.tenant.{e.tenant}.e2e_ms", e2e_ms)
                lane = self._lanes[e.tenant]
                if e.ticket.error() is not None:
                    lane.failed += 1
                else:
                    lane.solved += 1
                config = e.request.pipeline if e.request.pipeline is not None \
                    else self.service.pipeline
                gid = (e.handle.fingerprint, config.fingerprint())
                group_worst[gid] = max(group_worst.get(gid, 0.0), e2e_ms)
            for gid, worst in group_worst.items():
                if worst > self.slo_budget_ms:
                    self._slo_violations += 1
                    metrics.inc("serve.slo_violations")
        return None

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        """Daemon + per-tenant snapshot (deep copy, mutate freely).  The
        service's own ``stats()`` — cache, store, scheduler, metrics with
        the ``serve.*`` namespace — stays on ``daemon.service.stats()``."""
        with self._cond:
            tenants = {
                name: {
                    "pending_columns": lane.pending_columns,
                    "budget": lane.config.max_pending_columns,
                    "weight": lane.config.weight,
                    "submitted": lane.submitted,
                    "rejected": lane.rejected,
                    "solved": lane.solved,
                    "failed": lane.failed,
                    "expired": lane.expired,
                } for name, lane in self._lanes.items()}
            return copy.deepcopy({
                "daemon": {
                    "running": self.running,
                    "closed": self._closed,
                    "cycles": self._cycles,
                    "triggers": dict(self._triggers),
                    "queue_depth": len(self._queue),
                    "pending_columns": self._pending_columns,
                    "max_batch_delay_ms": self.max_batch_delay_ms,
                    "max_batch_columns": self.max_batch_columns,
                    "slo_budget_ms": self.slo_budget_ms,
                    "slo_violations": self._slo_violations,
                    "expired": self._expired,
                },
                "tenants": tenants,
            })
