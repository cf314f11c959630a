"""Traffic replay: open-loop arrival schedules + latency measurement.

The port of ``repro.serve.replay`` (host code: numpy and the clock).  The
daemon's figure of merit is wall-clock under a deadline, so it is
stressed the way a serving system is stressed: an **open-loop** workload
submits requests at pre-scheduled arrival times regardless of
completions (offered load is independent of the system's ability to keep
up — a saturated system shows queueing delay, not a silently throttled
workload).

The schedule is fully deterministic: arrival gaps, tenant assignment, and
every RHS vector derive from one seed (``np.random.default_rng``), the
same draws as the reference's, so one seed gives both packages the same
schedule.  The only nondeterminism at replay time is the machine itself.

    schedule = make_schedule(n_requests=64, rate_hz=200.0, seed=7)
    rep = replay_daemon(daemon, handle, schedule)     # or replay_sync(svc, ...)
    rep.p50_ms, rep.p99_ms, rep.throughput_rps

Latency is measured from the *scheduled* arrival to ticket resolution
(daemon mode: the resolution timestamp the flusher stamped on the ticket;
sync mode: the flush return), so a replay that falls behind still charges
the system, as an open-loop harness must.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.solver.requests import GraphHandle, SolveRequest


@dataclasses.dataclass(frozen=True)
class ReplayEvent:
    """One scheduled arrival: time offset (s), tenant lane, RHS width."""

    t: float
    tenant: str
    width: int
    rhs_seed: int


def make_schedule(n_requests: int, rate_hz: float, seed: int = 0,
                  tenants: Sequence[Tuple[str, float]] = (("default", 1.0),),
                  width: int = 1) -> List[ReplayEvent]:
    """Deterministic open-loop schedule: exponential inter-arrival gaps at
    ``rate_hz`` offered load, tenants drawn with the given relative
    probabilities.  Same seed, same schedule — byte for byte."""
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, size=n_requests)
    arrivals = np.cumsum(gaps) - gaps[0]        # first arrival at t=0
    names = [t for t, _ in tenants]
    probs = np.asarray([w for _, w in tenants], dtype=np.float64)
    probs = probs / probs.sum()
    lanes = rng.choice(len(names), size=n_requests, p=probs)
    return [ReplayEvent(t=float(arrivals[i]), tenant=names[int(lanes[i])],
                        width=width, rhs_seed=seed * 1_000_003 + i)
            for i in range(n_requests)]


def make_rhs(n: int, event: ReplayEvent) -> np.ndarray:
    """The event's deterministic right-hand side(s): ``[n]`` (width 1) or
    ``[n, width]`` standard normals from the event's own seed."""
    rng = np.random.default_rng(event.rhs_seed)
    b = rng.standard_normal((n, event.width)).astype(np.float32)
    return b[:, 0] if event.width == 1 else b


@dataclasses.dataclass
class ReplayReport:
    """Per-run latency/throughput summary with the raw samples attached."""

    mode: str                    # "daemon" | "sync"
    rate_hz: float               # offered load
    n_requests: int
    latencies_ms: List[float]    # per request, scheduled-arrival -> resolved
    duration_s: float            # first arrival -> last resolution
    errors: int = 0
    tenant_latencies_ms: Dict[str, List[float]] = \
        dataclasses.field(default_factory=dict)

    def percentile(self, p: float) -> float:
        if not self.latencies_ms:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_ms), p))

    @property
    def p50_ms(self) -> float:
        return self.percentile(50)

    @property
    def p99_ms(self) -> float:
        return self.percentile(99)

    @property
    def throughput_rps(self) -> float:
        if self.duration_s <= 0:
            return 0.0
        return self.n_requests / self.duration_s

    def to_record(self) -> dict:
        """bench-v1 row: everything a dashboard needs, JSON-safe."""
        return {
            "mode": self.mode,
            "rate_hz": self.rate_hz,
            "n_requests": self.n_requests,
            "errors": self.errors,
            "p50_ms": self.p50_ms,
            "p90_ms": self.percentile(90),
            "p99_ms": self.p99_ms,
            "max_ms": max(self.latencies_ms) if self.latencies_ms else 0.0,
            "throughput_rps": self.throughput_rps,
            "duration_s": self.duration_s,
            "tenants": {t: {"n": len(ls),
                            "p50_ms": float(np.percentile(ls, 50)),
                            "p99_ms": float(np.percentile(ls, 99))}
                        for t, ls in sorted(self.tenant_latencies_ms.items())
                        if ls},
        }


def _drive(submit_one, schedule: List[ReplayEvent]):
    """Open-loop submission: sleep to each scheduled arrival (never waiting for
    completions), submit, and return per-event (scheduled_abs_time, token)
    pairs.  A replay running behind schedule submits immediately — the
    lateness is charged to the system via the scheduled-arrival latency
    convention."""
    t0 = time.perf_counter()
    out = []
    for ev in schedule:
        target = t0 + ev.t
        delay = target - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        out.append((target, ev, submit_one(ev)))
    return out


def replay_daemon(daemon, handle: GraphHandle, schedule: List[ReplayEvent],
                  tol: float = 1e-5, maxiter: int = 2000,
                  timeout: float = 120.0) -> ReplayReport:
    """Replay ``schedule`` through a :class:`SolverDaemon` (no flush calls
    anywhere): submit open-loop, then collect every ticket.  Latency uses
    the resolution timestamp the flusher stamped on each ticket, so late
    collection by this loop costs nothing."""
    n = handle.n

    def submit_one(ev: ReplayEvent):
        return daemon.submit(
            SolveRequest(graph=handle, b=make_rhs(n, ev), tol=tol,
                         maxiter=maxiter), tenant=ev.tenant)

    submitted = _drive(submit_one, schedule)
    lat, by_tenant, errors, t_last = [], {}, 0, 0.0
    for scheduled, ev, ticket in submitted:
        try:
            ticket.result(timeout=timeout)
        except Exception:
            errors += 1
            continue
        resolved = ticket._resolved_at       # perf_counter, set by flusher
        ms = (resolved - scheduled) * 1e3
        lat.append(ms)
        by_tenant.setdefault(ev.tenant, []).append(ms)
        t_last = max(t_last, resolved)
    t0 = submitted[0][0]
    return ReplayReport(
        mode="daemon", rate_hz=_offered_rate(schedule),
        n_requests=len(schedule), latencies_ms=lat,
        duration_s=max(t_last - t0, 0.0), errors=errors,
        tenant_latencies_ms=by_tenant)


def replay_sync(service, handle: GraphHandle,
                schedule: List[ReplayEvent], tol: float = 1e-5,
                maxiter: int = 2000) -> ReplayReport:
    """The pre-daemon baseline: every arrival submits and immediately
    flushes on the caller's thread (the v2 ``result()``-triggers-flush
    discipline, one request per flush).  Same open-loop latency
    convention, so saturation shows up as schedule lag."""
    n = handle.n

    def submit_one(ev: ReplayEvent):
        ticket = service.submit(
            SolveRequest(graph=handle, b=make_rhs(n, ev), tol=tol,
                         maxiter=maxiter))
        try:
            ticket.result()                  # synchronous flush, per call
        except Exception:
            pass                             # counted via ticket.error()
        return ticket

    submitted = _drive(submit_one, schedule)
    lat, by_tenant, errors, t_last = [], {}, 0, 0.0
    for scheduled, ev, ticket in submitted:
        if ticket.error() is not None:
            errors += 1
            continue
        resolved = ticket._resolved_at
        ms = (resolved - scheduled) * 1e3
        lat.append(ms)
        by_tenant.setdefault(ev.tenant, []).append(ms)
        t_last = max(t_last, resolved)
    t0 = submitted[0][0]
    return ReplayReport(
        mode="sync", rate_hz=_offered_rate(schedule),
        n_requests=len(schedule), latencies_ms=lat,
        duration_s=max(t_last - t0, 0.0), errors=errors,
        tenant_latencies_ms=by_tenant)


def _offered_rate(schedule: List[ReplayEvent]) -> float:
    if len(schedule) < 2 or schedule[-1].t <= 0:
        return 0.0
    return (len(schedule) - 1) / schedule[-1].t
