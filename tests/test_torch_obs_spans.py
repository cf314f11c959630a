"""The port's spans on the CPU: where the service, the PCG loop, the
pipeline and the graph store open them, how they nest and how many there
are, the synced span's syncs, and nothing of the tracer or the profiler
on a solve while the tracer is off."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import mesh2d  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.obs import NOOP_SPAN, get_tracer  # noqa: E402
from repro_torch.obs import trace as trace_mod  # noqa: E402
from repro_torch.obs.device import synced_span, trace_annotation  # noqa: E402
from repro_torch.solver import (SolveRequest, SolverService,  # noqa: E402
                                batched_pcg, ell_laplacian, make_matvec)
from repro_torch.solver.device_pcg import _PCG_CHECK_EVERY  # noqa: E402


def _rhs(n, k=1, seed=0):
    b = np.random.default_rng(seed).standard_normal((n, k))
    return (b - b.mean(axis=0)).astype(np.float32)


@pytest.fixture
def tracer():
    tr = get_tracer()
    was = tr.enabled
    tr.clear()
    tr.enable()
    try:
        yield tr
    finally:
        tr.clear()
        tr.enabled = was


def _named(events, name):
    return [e for e in events if e["name"] == name and "dur_ns" in e]


def _inside(child, parent) -> bool:
    return (child["tid"] == parent["tid"]
            and parent["ts_ns"] <= child["ts_ns"]
            and child["ts_ns"] + child["dur_ns"]
            <= parent["ts_ns"] + parent["dur_ns"]
            and child["depth"] > parent["depth"])


def _parent(child, events):
    """The innermost finished span that holds ``child``."""
    holders = [e for e in events if "dur_ns" in e and e is not child
               and _inside(child, e)]
    return max(holders, key=lambda e: e["depth"]) if holders else None


def _submit_flush(svc, g, tol=1e-3, k=2):
    t = svc.submit(SolveRequest(graph=g, b=_rhs(g.n, k), tol=tol))
    svc.flush()
    return t.result()


def test_the_spans_nest_as_the_work_does(tracer):
    g = mesh2d(16, 16, seed=1)
    _submit_flush(SolverService(device="cpu", alpha=0.05), g)
    ev = tracer.events()
    names = {e["name"] for e in ev}
    for want in ("store.hash", "solver.stage", "solver.residual",
                 "solver.setup", "pcg.loop", "pcg.wait", "pipeline.prepare",
                 "pipeline.tree", "pipeline.lifting", "pipeline.scores",
                 "pipeline.grouping", "pipeline.recovery"):
        assert want in names, want
    (flush,) = _named(ev, "solver.flush")
    (group,) = _named(ev, "solver.group")
    # the graph's hash at submit, before the flush and outside it
    (h,) = _named(ev, "store.hash")
    assert _parent(h, ev) is None
    assert h["ts_ns"] + h["dur_ns"] <= flush["ts_ns"]
    assert h["args"] == {"n": g.n, "m": g.m}
    assert _parent(group, ev) is flush
    (stage,) = _named(ev, "solver.stage")
    (solve,) = _named(ev, "solver.solve")
    (resid,) = _named(ev, "solver.residual")
    for e in (stage, solve, resid):
        assert _parent(e, ev) is group, e["name"]
    # staged, solved, then the float64 residual
    assert stage["ts_ns"] + stage["dur_ns"] <= solve["ts_ns"]
    assert solve["ts_ns"] + solve["dur_ns"] <= resid["ts_ns"]
    (setup,) = _named(ev, "solver.setup")
    assert _parent(setup, ev)["name"] == "solver.artifacts"
    # the PCG's trips inside the solve, each test of "all done" in them
    loops = _named(ev, "pcg.loop")
    assert [_parent(lp, ev) for lp in loops] == [solve]
    for w in _named(ev, "pcg.wait"):
        assert _parent(w, ev) is loops[0]
    # the pipeline's stages in its prepare, prepare and recovery in the
    # level's sparsify, at every level
    preps = _named(ev, "pipeline.prepare")
    recs = _named(ev, "pipeline.recovery")
    sparsify = _named(ev, "hierarchy.sparsify")
    assert len(preps) == len(recs) == len(sparsify) >= 1
    for p in preps + recs:
        assert _parent(p, ev)["name"] == "hierarchy.sparsify"
    for stage_name in ("pipeline.tree", "pipeline.lifting",
                       "pipeline.scores", "pipeline.grouping"):
        got = _named(ev, stage_name)
        assert len(got) == len(preps)
        assert all(_parent(s, ev)["name"] == "pipeline.prepare"
                   for s in got)
    for b in _named(ev, "recovery.in_block"):
        assert _parent(b, ev)["name"] == "pipeline.recovery"


def test_a_registered_graph_is_hashed_once(tracer):
    g = mesh2d(12, 12, seed=2)
    svc = SolverService(device="cpu", alpha=0.05)
    h = svc.register(g)
    _submit_flush(svc, h)
    _submit_flush(svc, g)          # the same Graph: its digest is memoized
    assert len(_named(tracer.events(), "store.hash")) == 1
    # the cached solve closure is not set up again
    assert len(_named(tracer.events(), "solver.setup")) == 1


@pytest.mark.parametrize("tol", [1e-3, 1e-9])
def test_one_residual_and_one_more_a_refinement(tracer, tol):
    g = mesh2d(16, 16, seed=3)
    resp = _submit_flush(SolverService(device="cpu", alpha=0.05), g, tol=tol)
    ev = tracer.events()
    resid = _named(ev, "solver.residual")
    refine = _named(ev, "solver.refine")
    assert len(resid) == 1 + resp.refinements
    assert len(refine) == resp.refinements
    assert [e["args"]["pass_"] for e in resid] == list(
        range(resp.refinements + 1))
    if tol < 1e-5:
        # the float32 solve stops at 0.5e-5: the float64 residual asks more
        assert resp.refinements >= 1
    # each pass: its solve read back, then the residual of its answer
    for r, after in zip(refine, resid[1:]):
        assert r["ts_ns"] + r["dur_ns"] <= after["ts_ns"]
        assert len([lp for lp in _named(ev, "pcg.loop")
                    if _inside(lp, r)]) == 1


def test_residual_spans_name_the_device_they_ran_on(tracer):
    g = mesh2d(12, 12, seed=5)
    resp = _submit_flush(SolverService(device="cpu", alpha=0.05), g,
                         tol=1e-9)
    resid = _named(tracer.events(), "solver.residual")
    assert len(resid) == 1 + resp.refinements >= 2
    assert {e["args"]["on"] for e in resid} == {"cpu"}


def _tests_made(trips_run: int, max_trips: int) -> int:
    """Host tests of "all done" by a loop whose last column finished at
    ``trips_run``: one each ``_PCG_CHECK_EVERY`` trips, and the one that
    finds every column done unless the cap ends the loop first."""
    rounds = -(-trips_run // _PCG_CHECK_EVERY)
    ran = rounds * _PCG_CHECK_EVERY
    return rounds + (1 if ran < max_trips else 0)


@pytest.mark.parametrize("tol,maxiter", [(0.0, 20), (0.0, 16), (1e-4, 500)])
def test_one_wait_a_host_test(tracer, tol, maxiter):
    g = mesh2d(10, 10, seed=4)
    idx, val = ell_laplacian(g, device="cpu")
    b = torch.as_tensor(_rhs(g.n, 3))
    res = batched_pcg(make_matvec(idx, val), b, tol=tol, maxiter=maxiter)
    trips = int(res.iters.max())
    if tol == 0.0:
        assert trips == maxiter     # never converges: the cap ends it
    else:
        assert trips < maxiter
    ev = tracer.events()
    (loop,) = _named(ev, "pcg.loop")
    waits = _named(ev, "pcg.wait")
    assert len(waits) == _tests_made(trips, maxiter)
    assert all(_parent(w, ev) is loop for w in waits)
    assert loop["args"] == {"k": 3}


def test_synced_span_syncs_only_while_tracing(monkeypatch, tracer):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    with synced_span("stage.a", "cuda", rows=3) as sp:
        assert calls == [torch.device("cuda")]       # drained on entry
        sp.set(done=True)
    assert calls == [torch.device("cuda")] * 2       # and on exit
    (e,) = _named(tracer.events(), "stage.a")
    assert e["args"] == {"rows": 3, "done": True}
    # the CPU has no queue to drain: the plain span
    with synced_span("stage.b", torch.device("cpu")):
        pass
    assert len(calls) == 2 and _named(tracer.events(), "stage.b")
    # an error inside still closes the span, and still syncs
    with pytest.raises(RuntimeError):
        with synced_span("stage.c", "cuda"):
            raise RuntimeError("boom")
    assert len(calls) == 4 and _named(tracer.events(), "stage.c")
    tracer.disable()
    assert synced_span("stage.d", "cuda", rows=1) is NOOP_SPAN
    with synced_span("stage.d", "cuda"):
        pass
    assert len(calls) == 4
    assert not _named(tracer.events(), "stage.d")


def test_synced_span_leaves_a_dropped_tree_unsynced(monkeypatch, tracer):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    monkeypatch.setattr(tracer, "_sample_period", 4)
    monkeypatch.setattr(tracer, "_sample_seq", 0)
    for root in range(4):                 # root 0 is kept, 1-3 dropped
        with tracer.span("build", root=root):
            for stage in ("pipeline.tree", "pipeline.recovery"):
                with synced_span(stage, "cuda", root=root):
                    pass
    # two syncs a stage of the kept tree, none in the three dropped ones
    assert calls == [torch.device("cuda")] * 4
    ev = tracer.events()
    assert [e["args"]["root"] for e in _named(ev, "pipeline.tree")] == [0]
    assert [e["args"]["root"] for e in _named(ev, "build")] == [0]
    assert tracer.sampled_out == 3


class _Spy:
    """Counts the tracer's live spans, the profiler's ranges and NVTX
    pushes opened while it is installed."""

    def __init__(self, monkeypatch):
        self.spans = self.ranges = self.nvtx = 0
        spy = self
        real_span, real_range = trace_mod._Span, torch.profiler.record_function

        class CountedSpan(real_span):
            __slots__ = ()

            def __init__(self, *a, **kw):
                spy.spans += 1
                super().__init__(*a, **kw)

        def counted_range(*a, **kw):
            spy.ranges += 1
            return real_range(*a, **kw)

        def counted_push(*a, **kw):
            spy.nvtx += 1

        monkeypatch.setattr(trace_mod, "_Span", CountedSpan)
        monkeypatch.setattr(torch.profiler, "record_function", counted_range)
        monkeypatch.setattr(torch.cuda.nvtx, "range_push", counted_push)


@pytest.mark.parametrize("plane", ["single", "sharded"])
def test_tracer_off_opens_nothing(monkeypatch, plane):
    mesh = make_mesh((4,), ("data",), device="cpu") if plane == "sharded" \
        else None
    tr = get_tracer()
    was = tr.enabled
    tr.disable()
    tr.clear()
    spy = _Spy(monkeypatch)
    try:
        assert trace_annotation("vcycle.L0.down") is NOOP_SPAN
        g = mesh2d(12, 12, seed=5)
        svc = SolverService(device="cpu", alpha=0.05, mesh=mesh)
        _submit_flush(svc, g)                     # build, set-up and solve
        _submit_flush(svc, g, tol=1e-9)           # and refinement passes
        assert (spy.spans, spy.ranges, spy.nvtx) == (0, 0, 0)
        assert tr.events() == []
        assert "timing" not in svc.stats()
        # the same solve with the tracer on opens both: the spies see
        tr.enable()
        _submit_flush(svc, g)
        assert spy.spans > 0 and spy.ranges > 0
        names = set(tr.span_names())
        assert {"pcg.loop", "pcg.wait", "solver.residual"} <= names
    finally:
        tr.clear()
        tr.enabled = was
