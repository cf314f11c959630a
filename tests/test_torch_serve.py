"""The port's serving runtime (repro_torch.serve: the solver daemon and
traffic replay) held to the reference's contracts and against the
reference's daemon.

The contracts are those of ``tests/test_serve_daemon.py`` and
``tests/test_replay.py``, run on the port alone on the CPU
(``device="cpu"``): tickets resolve with no flush, size and deadline
triggers, group-failure isolation across the thread boundary, tenant
budgets, starvation-free and weighted batch selection, drain and no-drain
shutdown, queue-side expiry, SLO counting and the ``serve.*`` telemetry.
No test bounds a wall-clock time tightly: the SLO count and the expiry
run on an injected clock.

Parity with the JAX package: ``make_schedule`` and ``make_rhs`` give the
reference's events and right-hand sides for the same seed, and a port
daemon and a reference daemon answer the same requests within +-2
iterations with re-based x allclose (rtol 1e-3).
"""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as jgraph  # noqa: E402
from repro.serve import SolverDaemon as JSolverDaemon  # noqa: E402
from repro.serve import make_rhs as jmake_rhs  # noqa: E402
from repro.serve import make_schedule as jmake_schedule  # noqa: E402
from repro.solver import SolveRequest as JSolveRequest  # noqa: E402
from repro.solver import SolverService as JSolverService  # noqa: E402
from repro_torch.core import grid2d, mesh2d  # noqa: E402
from repro_torch.obs import get_tracer  # noqa: E402
from repro_torch.pipeline import fegrass_config  # noqa: E402
from repro_torch.serve import (DaemonShutdownError, ReplayReport,  # noqa: E402
                               SolverDaemon, TenantConfig, make_rhs,
                               make_schedule, replay_daemon, replay_sync)
from repro_torch.solver import (AdmissionError,  # noqa: E402
                                DeadlineExceededError, SolveRequest,
                                SolverService)

DELAY_MS = 40.0


def _rhs(n, k=1, seed=0):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((n, k)).astype(np.float32)
    return b[:, 0] if k == 1 else b


def _rebase(x):
    x = np.asarray(x, dtype=np.float64)
    return x - x[0]


@pytest.fixture(scope="module")
def svc():
    """One warm CPU service for the module: artifacts built, so the daemon
    tests time serving, not the build."""
    service = SolverService(alpha=0.1, device="cpu")
    h = service.register(grid2d(6, 6, seed=0))
    service.warmup(h, widths=[1, 2, 4, 8])
    return service, h


class _Clock:
    """A monotonic clock the test moves by hand."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _run_queue(d):
    """Run the daemon's cycles on this thread until its queue is empty;
    returns each window's tenants."""
    windows = []
    while True:
        with d._cond:
            if not d._queue:
                return windows
            batch = d._select_batch_locked()
        windows.append([e.tenant for e in batch])
        d._run_cycle(batch, "size")


# -- parity with the reference ------------------------------------------------

@pytest.mark.parametrize("n_requests,rate_hz,seed,tenants,width", [
    (32, 100.0, 7, (("p", 3.0), ("f", 1.0)), 1),
    (16, 8.0, 7, (("paid", 4.0), ("free", 1.0)), 1),
    (5, 200.0, 0, (("default", 1.0),), 3),
])
def test_schedule_and_rhs_equal_the_reference(n_requests, rate_hz, seed,
                                              tenants, width):
    kw = dict(seed=seed, tenants=tenants, width=width)
    mine = make_schedule(n_requests, rate_hz, **kw)
    ref = jmake_schedule(n_requests, rate_hz, **kw)
    assert [tuple(vars(e).values()) for e in mine] == \
        [tuple(vars(e).values()) for e in ref]
    for e_m, e_r in zip(mine[:4], ref[:4]):
        b_m, b_r = make_rhs(25, e_m), jmake_rhs(25, e_r)
        assert b_m.dtype == b_r.dtype and np.array_equal(b_m, b_r)


def test_daemon_answers_match_the_reference_daemon():
    """The same requests, drained through one cycle of each package's
    daemon: +-2 iterations, re-based x allclose, every request resolved."""
    seeds = [(0, 1), (1, 2), (2, 1)]          # (seed, columns)
    out = {}
    for name, service, daemon_cls, request_cls, g in (
            ("port", SolverService(alpha=0.1, device="cpu"), SolverDaemon,
             SolveRequest, mesh2d(8, 8, seed=0)),
            ("ref", JSolverService(alpha=0.1), JSolverDaemon, JSolveRequest,
             jgraph.mesh2d(8, 8, seed=0))):
        h = service.register(g)
        d = daemon_cls(service, max_batch_delay_ms=60_000.0,
                       autostart=False)
        tickets = [d.submit(request_cls(graph=h, b=_rhs(g.n, k, seed),
                                        tol=1e-5))
                   for seed, k in seeds]
        d.close(drain=True)
        out[name] = [t.result(timeout=1.0) for t in tickets]
        assert d.stats()["daemon"]["triggers"]["drain"] == 1
    for mine, ref in zip(out["port"], out["ref"]):
        assert mine.converged and ref.converged
        assert np.all(np.abs(np.asarray(mine.iters)
                             - np.asarray(ref.iters)) <= 2)
        np.testing.assert_allclose(_rebase(mine.x), _rebase(ref.x),
                                   rtol=1e-3, atol=1e-4)


# -- the daemon's own contracts ------------------------------------------------

def test_daemon_takes_the_service_device(svc):
    service, _ = svc
    d = SolverDaemon(service, autostart=False)
    assert d.device == service.device == torch.device("cpu")
    d.close()


def test_ticket_resolves_without_flush(svc):
    service, h = svc
    flushes_before = service.stats()["scheduler"]["flushes"]
    with SolverDaemon(service, max_batch_delay_ms=DELAY_MS) as d:
        t = d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=1)))
        res = t.result(timeout=30.0)
    assert res.converged and t.done()
    assert service.stats()["scheduler"]["flushes"] == flushes_before
    assert d.stats()["daemon"]["triggers"]["deadline"] >= 1


def test_done_is_nonblocking_and_result_timeout(svc):
    service, h = svc
    d = SolverDaemon(service, max_batch_delay_ms=60_000.0)
    try:
        t = d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=2)))
        assert not t.done()          # deadline is a minute out
        with pytest.raises(TimeoutError):
            t.result(timeout=0.05)
        assert not t.done()
    finally:
        d.close(drain=True)
    assert t.result(timeout=1.0).converged   # drain settled it


def test_size_trigger_fires_before_deadline(svc):
    service, h = svc
    with SolverDaemon(service, max_batch_delay_ms=60_000.0,
                      max_batch_columns=4) as d:
        tickets = [d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=10 + i)))
                   for i in range(4)]
        for t in tickets:
            assert t.result(timeout=30.0).converged
        assert d.stats()["daemon"]["triggers"]["size"] >= 1


def test_group_failure_isolation_across_thread_boundary(svc, monkeypatch):
    service, h = svc
    fe = fegrass_config(alpha=0.1)
    real = service._solve_group

    def poisoned(entries, config, key):
        if config.fingerprint() == fe.fingerprint():
            raise RuntimeError("poisoned group")
        return real(entries, config, key)

    monkeypatch.setattr(service, "_solve_group", poisoned)
    with SolverDaemon(service, max_batch_delay_ms=DELAY_MS) as d:
        ok = d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=3)))
        bad = d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=4),
                                    pipeline=fe))
        assert ok.result(timeout=30.0).converged
        with pytest.raises(RuntimeError, match="poisoned group"):
            bad.result(timeout=30.0)
        assert bad.done() and bad.error() is not None
    # the flusher counts a cycle's failures after it resolves the tickets:
    # read the count once close() has joined it
    assert d.stats()["tenants"]["default"]["failed"] == 1


def test_tenant_budget_rejects_with_tenant_context(svc):
    service, h = svc
    with SolverDaemon(
            service, max_batch_delay_ms=60_000.0,
            tenants={"free": TenantConfig(max_pending_columns=2)}) as d:
        d.submit(SolveRequest(graph=h, b=_rhs(h.n, k=2, seed=5)),
                 tenant="free")
        with pytest.raises(AdmissionError) as ei:
            d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=6)),
                     tenant="free")
        assert ei.value.tenant == "free" and "free" in str(ei.value)
        assert ei.value.budget == 2 and ei.value.pending == 2
        t = d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=7)),
                     tenant="paid")
        stats = d.stats()["tenants"]
        assert stats["free"]["rejected"] == 1
        assert stats["paid"]["submitted"] == 1
        d.close(drain=True)
        assert t.result(timeout=1.0).converged


def test_starvation_free_selection_under_flood(svc):
    service, h = svc
    d = SolverDaemon(service, max_batch_delay_ms=60_000.0,
                     max_batch_columns=3,
                     tenants={"heavy": TenantConfig(weight=8.0),
                              "light": TenantConfig(weight=1.0)},
                     autostart=False)
    heavy = [d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=20 + i)),
                      tenant="heavy") for i in range(9)]
    light = [d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=40 + i)),
                      tenant="light") for i in range(3)]
    windows = _run_queue(d)
    light_remaining = len(light)
    for window in windows:
        if light_remaining > 0:
            assert "light" in window, f"light starved in window {window}"
        light_remaining -= window.count("light")
    assert light_remaining == 0
    flat = [t for w in windows for t in w]
    assert flat.count("heavy") == 9 and flat.count("light") == 3
    d.close(drain=True)
    for t in heavy + light:
        assert t.result(timeout=1.0).converged


def test_weighted_fill_prefers_heavier_lane(svc):
    service, h = svc
    d = SolverDaemon(service, max_batch_delay_ms=60_000.0,
                     max_batch_columns=6,
                     tenants={"a": TenantConfig(weight=4.0),
                              "b": TenantConfig(weight=1.0)},
                     autostart=False)
    for i in range(8):
        d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=60 + i)), tenant="a")
        d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=80 + i)), tenant="b")
    with d._cond:
        batch = d._select_batch_locked()
    first = [e.tenant for e in batch]
    assert first.count("a") > first.count("b") >= 1
    d._run_cycle(batch, "size")
    d.close(drain=True)


def test_shutdown_drain_resolves_everything(svc):
    service, h = svc
    d = SolverDaemon(service, max_batch_delay_ms=60_000.0)
    tickets = [d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=100 + i)))
               for i in range(5)]
    assert not any(t.done() for t in tickets)
    d.close(drain=True)
    for t in tickets:
        assert t.done() and t.result(timeout=1.0).converged
    assert not d.running
    assert d.stats()["daemon"]["triggers"]["drain"] >= 1


def test_shutdown_without_drain_fails_deterministically(svc):
    service, h = svc
    d = SolverDaemon(service, max_batch_delay_ms=60_000.0)
    tickets = [d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=120 + i)))
               for i in range(3)]
    d.close(drain=False)
    for t in tickets:
        assert t.done()
        with pytest.raises(DaemonShutdownError):
            t.result(timeout=1.0)
    with pytest.raises(RuntimeError, match="closed"):
        d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=130)))
    d.close()   # idempotent


def test_multithreaded_submit_result_race(svc):
    """Producer threads x the deadline flusher x the synchronous flush
    path: every ticket resolves to its own request's solution, the queue
    accounting lands on zero, and nothing deadlocks."""
    service, h = svc
    n_threads, per_thread = 4, 5
    g = h.graph
    results, errors = {}, []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with SolverDaemon(service, max_batch_delay_ms=5.0) as d:
            def producer(tid):
                try:
                    for i in range(per_thread):
                        b = _rhs(h.n, seed=1000 + tid * 100 + i)
                        if tid == 0:     # the sync path beside the daemon
                            res = service.solve(h, b)
                        else:
                            res = d.submit(SolveRequest(graph=h, b=b),
                                           tenant=f"t{tid}").result(
                                               timeout=60.0)
                        results[(tid, i)] = (b, res)
                except Exception as e:   # pragma: no cover - reported below
                    errors.append(e)

            threads = [threading.Thread(target=producer, args=(tid,))
                       for tid in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(120.0)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors
    assert len(results) == n_threads * per_thread
    for (tid, i), (b, res) in results.items():
        assert res.converged, (tid, i)
        bc = b.astype(np.float64) - b.mean()
        r = bc - g.laplacian_matvec(np.asarray(res.x, dtype=np.float64))
        assert np.linalg.norm(r) <= 1e-4 * np.linalg.norm(bc), (tid, i)
    stats = d.stats()
    assert stats["daemon"]["pending_columns"] == 0
    assert stats["daemon"]["queue_depth"] == 0
    for tid in range(1, n_threads):
        lane = stats["tenants"][f"t{tid}"]
        assert lane["solved"] == per_thread and lane["pending_columns"] == 0


def test_slo_violation_counter_on_an_injected_clock(svc):
    """A cycle whose end comes 1 s after the submit on the daemon's clock
    breaches a 100 ms budget, once per (graph, config) group; a cycle
    inside the budget does not."""
    service, h = svc
    before = service.metrics.counter("serve.slo_violations").value
    clock = _Clock()
    d = SolverDaemon(service, max_batch_delay_ms=25.0, autostart=False,
                     clock=clock)
    assert d.slo_budget_ms == pytest.approx(100.0)
    t = d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=200)))
    clock.now = 1.0
    _run_queue(d)
    assert t.result(timeout=1.0).converged
    assert d.stats()["daemon"]["slo_violations"] == 1
    t = d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=201)))
    _run_queue(d)                      # no time passes on the clock
    assert t.result(timeout=1.0).converged
    assert d.stats()["daemon"]["slo_violations"] == 1
    d.close()
    after = service.metrics.counter("serve.slo_violations").value
    assert after - before == 1
    assert service.stats()["metrics"]["serve.slo_violations"] >= 1
    d2 = SolverDaemon(service, max_batch_delay_ms=25.0, slo_budget_ms=80.0,
                      autostart=False)
    assert d2.slo_budget_ms == 80.0
    d2.close()


def test_serve_metrics_surface_and_flush_cycle_span(svc):
    service, h = svc
    tr = get_tracer()
    was = tr.enabled
    tr.enable()
    tr.clear()
    try:
        with SolverDaemon(service, max_batch_delay_ms=10.0) as d:
            t = d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=300)))
            assert t.result(timeout=30.0).converged
        names = tr.span_names()
        cycle = next(e for e in tr.events()
                     if e["name"] == "serve.flush_cycle")
    finally:
        tr.clear()
        tr.enabled = was
    assert "solver.group" in names     # the scheduler ran inside the cycle
    assert cycle["args"]["requests"] == 1
    assert cycle["args"]["trigger"] in ("deadline", "size", "drain")
    m = service.stats()["metrics"]
    assert m["serve.queue_depth"] == 0
    assert m["serve.queue_wait_ms"]["count"] >= 1
    assert m["serve.e2e_ms"]["count"] >= 1 and m["serve.e2e_ms"]["p50"] > 0
    assert m["serve.cycles"] >= 1


def test_constructor_validation(svc):
    service, _ = svc
    with pytest.raises(ValueError, match="max_batch_delay_ms"):
        SolverDaemon(service, max_batch_delay_ms=0.0)
    with pytest.raises(ValueError, match="max_batch_columns"):
        SolverDaemon(service, max_batch_columns=0)
    with pytest.raises(TypeError, match="TenantConfig"):
        SolverDaemon(service, tenants={"a": {"weight": 2.0}},
                     autostart=False)
    with pytest.raises(ValueError, match="weight"):
        TenantConfig(weight=0.0)


def test_expiry_manual_clock_fails_only_deadlined_ticket(svc):
    service, h = svc
    clock = _Clock()
    d = SolverDaemon(service, max_batch_delay_ms=60_000.0, autostart=False,
                     clock=clock)
    doomed = d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=200),
                                   deadline_ms=50.0))
    safe = d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=201)))
    clock.now = 0.2                    # 200 ms later: 50 ms TTL long gone
    d.close(drain=True)                # drain sweeps expiries first
    with pytest.raises(DeadlineExceededError) as ei:
        doomed.result(timeout=1.0)
    assert ei.value.deadline_ms == 50.0 and ei.value.waited_ms >= 50.0
    assert safe.result(timeout=1.0).converged
    assert d.stats()["daemon"]["expired"] == 1


def test_expiry_fires_from_live_flusher_before_batch_deadline(svc):
    """The flusher's wait is min(batch deadline, earliest TTL): a 30 ms
    TTL inside a 60 s batch window expires long before the window."""
    service, h = svc
    with SolverDaemon(service, max_batch_delay_ms=60_000.0) as d:
        t = d.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=210),
                                  deadline_ms=30.0))
        with pytest.raises(DeadlineExceededError):
            t.result(timeout=30.0)
        st = d.stats()
        assert st["daemon"]["expired"] == 1
        assert st["tenants"]["default"]["expired"] == 1
        assert st["daemon"]["cycles"] == 0       # expired, never solved
    m = service.stats()["metrics"]
    assert m["serve.expired"] >= 1 and m["serve.tenant.default.expired"] >= 1


def test_deadline_ms_validation_and_sync_path(svc):
    service, h = svc
    with pytest.raises(ValueError, match="deadline_ms"):
        service.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=220),
                                    deadline_ms=-5.0))
    t = service.submit(SolveRequest(graph=h, b=_rhs(h.n, seed=221),
                                    deadline_ms=1e-3))
    service.flush()
    assert t.result().converged


# -- replay ---------------------------------------------------------------------

def test_schedule_is_deterministic_and_validated():
    a = make_schedule(32, 100.0, seed=7, tenants=(("p", 3.0), ("f", 1.0)))
    assert a == make_schedule(32, 100.0, seed=7,
                              tenants=(("p", 3.0), ("f", 1.0)))
    assert a != make_schedule(32, 100.0, seed=8,
                              tenants=(("p", 3.0), ("f", 1.0)))
    assert a[0].t == 0.0
    assert all(e2.t >= e1.t for e1, e2 in zip(a, a[1:]))
    assert sum(e.tenant == "p" for e in a) > sum(e.tenant == "f" for e in a)
    assert len({e.rhs_seed for e in a}) == 32
    with pytest.raises(ValueError, match="n_requests"):
        make_schedule(0, 10.0)
    with pytest.raises(ValueError, match="rate_hz"):
        make_schedule(4, 0.0)
    sched = make_schedule(4, 10.0, seed=1)
    b1 = make_rhs(25, sched[0])
    assert b1.shape == (25,) and b1.dtype == np.float32
    assert np.array_equal(b1, make_rhs(25, sched[0]))
    assert not np.array_equal(b1, make_rhs(25, sched[1]))
    assert make_rhs(25, make_schedule(2, 10.0, seed=1, width=3)[0]).shape \
        == (25, 3)


def test_replay_sync_and_daemon_agree_on_workload(svc):
    """Both replay modes over the same tiny schedule: zero errors, one latency
    sample per request, per-tenant sample counts match the schedule, and
    each request's answer is the same solve in both modes."""
    service, h = svc
    sched = make_schedule(8, 200.0, seed=3, tenants=(("p", 3.0), ("f", 1.0)))
    sync_rep = replay_sync(service, h, sched)
    with SolverDaemon(service, max_batch_delay_ms=10.0) as daemon:
        daemon_rep = replay_daemon(daemon, h, sched)
    want = {}
    for e in sched:
        want[e.tenant] = want.get(e.tenant, 0) + 1
    for rep in (sync_rep, daemon_rep):
        assert rep.errors == 0 and rep.n_requests == 8
        assert len(rep.latencies_ms) == 8
        assert all(ms > 0 for ms in rep.latencies_ms)
        assert rep.p99_ms >= rep.p50_ms > 0 and rep.throughput_rps > 0
        assert {t: len(ls) for t, ls in rep.tenant_latencies_ms.items()} \
            == want
        rec = rep.to_record()
        assert rec["p50_ms"] > 0 and rec["p99_ms"] >= rec["p50_ms"]
        assert set(rec["tenants"]) == set(want)
    assert sync_rep.mode == "sync" and daemon_rep.mode == "daemon"


def test_report_percentiles_empty_safe():
    rep = ReplayReport(mode="sync", rate_hz=1.0, n_requests=0,
                       latencies_ms=[], duration_s=0.0)
    assert rep.p50_ms == 0.0 and rep.p99_ms == 0.0
    assert rep.throughput_rps == 0.0
    assert rep.to_record()["max_ms"] == 0.0


def test_serve_imports_each_runtime_on_first_use():
    """Importing the LM engine pulls in neither the solver service nor
    the daemon (a fresh interpreter, so earlier imports do not count)."""
    import os
    import subprocess

    import repro_torch

    src = os.path.dirname(os.path.dirname(repro_torch.__file__))
    code = ("import sys; from repro_torch.serve import Engine, Request; "
            "print(sorted(m for m in sys.modules if m.startswith("
            "('repro_torch.solver', 'repro_torch.serve.solver_daemon'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.stdout.strip() == "[]"
    import repro_torch.serve as serve
    assert {"SolverDaemon", "make_schedule", "replay_daemon",
            "Engine"} <= set(serve.__all__)
    with pytest.raises(AttributeError):
        serve.no_such_name  # noqa: B018
