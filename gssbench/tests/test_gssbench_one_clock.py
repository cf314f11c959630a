"""The tracer's spans and the profiler's events on one clock: a span and a
profiler range opened together start together once ``reduce()`` maps the
spans over, and an idle gap inside ``solver.residual`` of a real traced
run is put down to that span, not to the group that holds it."""
import pytest

from gssbench import profiling
from gssbench.tests.conftest import tiny

CUDA = "DeviceType.CUDA"


class _Event:
    """A profiler event reduced to what ``reduce_events`` reads."""

    def __init__(self, name, start, dur, device, annotation):
        self._v = (name, start, dur, device, annotation)

    @classmethod
    def of(cls, e):
        return cls(e.name(), e.start_ns(), e.duration_ns(),
                   str(e.device_type()), e.is_user_annotation())

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


@pytest.fixture
def captured(monkeypatch):
    """What ``TracedWindow.reduce`` hands ``reduce_events``: the events
    (copied out of the profiler), the tracer's spans and the offset."""
    got = {}
    real = profiling.reduce_events

    def spy(events, host_spans=(), offset_ns=0, **kw):
        got.update(events=[_Event.of(e) for e in events],
                   spans=list(host_spans), offset=offset_ns)
        return real(events, host_spans, offset_ns, **kw)

    monkeypatch.setattr(profiling, "reduce_events", spy)
    return got


@pytest.fixture
def tracer():
    from repro_torch.obs import get_tracer

    tr = get_tracer()
    was = tr.enabled
    tr.clear()
    tr.enable()
    try:
        yield tr
    finally:
        tr.clear()
        tr.enabled = was


def test_span_and_range_start_together(captured, tracer):
    import time

    import torch

    w = profiling.TracedWindow(cuda=False)
    w.start()
    for _ in range(3):
        with tracer.span("clock.probe"), \
                torch.profiler.record_function("clock.probe"):
            time.sleep(0.002)
        time.sleep(0.005)
    w.stop()
    spans = [(e["ts_ns"], e["ts_ns"] + e["dur_ns"], e["name"])
             for e in tracer.events()]
    assert w.reduce(spans) is not None
    ranges = sorted(e.start_ns() for e in captured["events"]
                    if e.name() == "clock.probe"
                    and profiling.classify(e) == "range")
    mapped = sorted(s + captured["offset"] for s, _, _ in captured["spans"])
    assert len(ranges) == len(mapped) == 3
    for r, s in zip(ranges, mapped):
        assert abs(r - s) < 1e6, (r, s)


def test_a_gap_in_the_residual_is_the_residuals(manifest, captured):
    """A tiny traced run through the harness; the card is stood in for by
    device work over the whole window but for the traced flush's float64
    residual, so the one idle gap is that residual's."""
    from gssbench import harness

    cell = "mesh2d-1024.solve-b32"
    config, tr = tiny(manifest, cell, 20)
    r = harness.run_cell(manifest, cell, 7, 0.6, True, device="cpu",
                         config=config, traffic=tr)
    assert r["correct"]
    events, off = captured["events"], captured["offset"]
    (window,) = [e for e in events if e.name() == profiling.WINDOW]
    w0 = window.start_ns()
    w1 = w0 + window.duration_ns()
    inside = [(s + off, e + off) for s, e, name in captured["spans"]
              if name == "solver.residual" and w0 <= s + off < w1]
    (res0, res1), = inside
    group = [(s + off, e + off) for s, e, name in captured["spans"]
             if name == "solver.group" and s + off <= res0 and res1 <= e + off]
    assert group, "the residual runs inside its group"
    busy = [_Event("k", w0, res0 - w0, CUDA, False),
            _Event("k", res1, w1 - res1, CUDA, False)]
    d = profiling.reduce_events(events + busy, captured["spans"], off)
    assert d.busy_s == pytest.approx((w1 - w0 - (res1 - res0)) / 1e9)
    (label,) = d.gap_s
    assert label.split(" / ")[0] == "solver.residual", label
    assert d.gap_s[label] == pytest.approx((res1 - res0) / 1e9)
