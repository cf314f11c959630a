"""The readers of the program's host spans: the float64 residual, the
PCG's dispatch and the pipeline's two steps, on hand-made spans with the
traced batch left out, on a tiny traced run of each cell, and nothing
read where the program has no such span."""
import numpy as np
import pytest

from gssbench.harness import Batch, Run
from gssbench.tests.conftest import run_tiny

SOLVE = ("service.residual_ms.solve", "pcg.dispatch_ms.solve")
RESPARSIFY = ("service.residual_ms.resparsify",
              "pipeline.prepare_s.resparsify",
              "pipeline.recovery_s.resparsify")


def _span(name, t0_s, dur_s):
    return {"name": name, "ts_ns": int(round(t0_s * 1e9)),
            "dur_ns": int(round(dur_s * 1e9))}


def _batches():
    return [Batch(0.0, 4.0, 32, np.array([90, 100]), 2),
            Batch(5.0, 11.0, 32, np.array([120, 110]), 2, True),
            Batch(12.0, 15.0, 32, np.array([80, 60]), 2)]


@pytest.fixture
def solve_run():
    r = Run(cell="c", kind="closed_batch", seconds=10.0, trace=True)
    r.batches = _batches()
    r.spans = [_span("solver.flush", 0.1, 3.8),
               _span("pcg.loop", 0.3, 0.9),
               _span("pcg.wait", 0.4, 0.1), _span("pcg.wait", 0.8, 0.2),
               _span("solver.residual", 1.3, 2.0),
               _span("pcg.loop", 3.4, 0.3), _span("pcg.wait", 3.5, 0.05),
               _span("solver.residual", 3.75, 0.1),
               # the traced flush: slowed by the profiler, left out
               _span("pcg.loop", 5.3, 3.0), _span("pcg.wait", 5.4, 0.1),
               _span("solver.residual", 8.5, 2.0),
               _span("pcg.loop", 12.3, 0.7), _span("pcg.wait", 12.4, 0.3),
               _span("solver.residual", 13.1, 1.5)]
    r.profiled = (5.0, 11.0)
    return r


@pytest.fixture
def resparsify_run():
    r = Run(cell="c", kind="resparsify", seconds=10.0, trace=True)
    r.batches = _batches()
    r.spans = [_span("store.hash", 0.05, 0.02),
               _span("hierarchy.sparsify", 0.1, 1.1),
               _span("pipeline.prepare", 0.1, 0.6),
               _span("pipeline.recovery", 0.7, 0.45),
               _span("hierarchy.sparsify", 1.3, 0.5),
               _span("pipeline.prepare", 1.3, 0.3),
               _span("pipeline.recovery", 1.6, 0.15),
               _span("solver.residual", 3.0, 0.25),
               _span("pipeline.prepare", 5.1, 2.0),
               _span("pipeline.recovery", 7.1, 2.0),
               _span("solver.residual", 9.5, 1.0),
               _span("pipeline.prepare", 12.1, 1.0),
               _span("pipeline.recovery", 13.1, 0.5),
               _span("solver.residual", 14.0, 0.35)]
    r.profiled = (5.0, 11.0)
    return r


def test_residual_per_flush(manifest, solve_run):
    # flushes 0 and 2: (2.0 + 0.1) and 1.5 s
    got = manifest.reader("service.residual_ms.solve")(solve_run)
    assert got == pytest.approx((2.1 + 1.5) / 2 * 1e3)
    assert manifest.reader("service.residual_ms.resparsify")(
        solve_run) is None


def test_dispatch_per_trip(manifest, solve_run):
    # loops less waits: (0.9 - 0.3) + (0.3 - 0.05) and (0.7 - 0.3) s,
    # over 100 + 80 trips
    got = manifest.reader("pcg.dispatch_ms.solve")(solve_run)
    assert got == pytest.approx((0.85 + 0.4) / 180 * 1e3)
    # what it splits: the loop's time a trip, of which dispatch is part
    assert got < (0.9 + 0.3 + 0.7) / 180 * 1e3


def test_resparsify_readers(manifest, resparsify_run):
    read = manifest.reader
    # cycles 0 and 2, the traced cycle 1 left out
    assert read("pipeline.prepare_s.resparsify")(resparsify_run) == \
        pytest.approx((0.9 + 1.0) / 2)
    assert read("pipeline.recovery_s.resparsify")(resparsify_run) == \
        pytest.approx((0.6 + 0.5) / 2)
    assert read("service.residual_ms.resparsify")(resparsify_run) == \
        pytest.approx((0.25 + 0.35) / 2 * 1e3)
    for name in SOLVE:
        assert read(name)(resparsify_run) is None


def _without(run, names):
    run.spans = [e for e in run.spans if e["name"] not in names]
    return run


@pytest.mark.parametrize("metric", SOLVE + RESPARSIFY)
def test_nothing_to_read(manifest, solve_run, resparsify_run, metric):
    """``None`` with no spans, with none of the metric's own (a program
    that lacks them), with only the traced batch, and in the other kind."""
    read = manifest.reader(metric)
    run = solve_run if metric in SOLVE else resparsify_run
    other = resparsify_run if metric in SOLVE else solve_run
    assert read(run) is not None
    assert read(other) is None
    new = {"solver.residual", "pcg.loop", "pcg.wait", "pipeline.prepare",
           "pipeline.recovery"}
    assert read(_without(run, new)) is None
    run.spans = []
    assert read(run) is None
    traced_only = Run(cell="c", kind=run.kind, seconds=1.0, trace=True)
    traced_only.batches = [_batches()[1]]
    traced_only.spans = [_span(n, 5.5, 0.1) for n in sorted(new)]
    assert read(traced_only) is None


def test_tiny_solve_cell_reads_both(manifest):
    r = run_tiny(manifest, "mesh2d-1024.solve-b32", trace=True, seconds=0.6)
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert r["correct"]
    for name in SOLVE:
        assert got[name] > 0, name
    # the residual is part of the service's host work, the dispatch part
    # of the trip
    assert got["service.residual_ms.solve"] < got["service.host_ms.solve"]
    assert got["pcg.dispatch_ms.solve"] <= got["pcg.trip_ms.solve"]
    assert not set(RESPARSIFY) & set(got)


def test_tiny_resparsify_cell_reads_all_three(manifest):
    r = run_tiny(manifest, "ecology2.resparsify", trace=True, seconds=0.6)
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert r["correct"]
    for name in RESPARSIFY:
        assert got[name] > 0, name
    # the pipeline's two steps inside its sparsify spans, and most of them
    steps = got["pipeline.prepare_s.resparsify"] + \
        got["pipeline.recovery_s.resparsify"]
    sparsify = got["pipeline.sparsify_s.resparsify"]
    assert 0.5 * sparsify < steps <= sparsify
    assert not set(SOLVE) & set(got)


@pytest.mark.parametrize("cell", ["mesh2d-1024.solve-b32",
                                  "ecology2.resparsify"])
def test_untraced_line_has_no_span_metric(manifest, cell):
    r = run_tiny(manifest, cell)
    assert not (set(SOLVE) | set(RESPARSIFY)) & set(r["metrics"])
