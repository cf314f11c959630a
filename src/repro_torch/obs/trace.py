"""Thread-safe span tracer: nested spans, monotonic clocks, Perfetto export.

The serving stack's timing story used to be ad-hoc ``perf_counter`` deltas
scattered through ``service.py``; this module replaces them with one
structured tracer:

    from repro_torch.obs import get_tracer

    tr = get_tracer()
    tr.enable()
    with tr.span("solver.flush", groups=2):
        with tr.span("solver.solve", k=8):
            ...
    tr.export_chrome("trace.json")     # open in ui.perfetto.dev

Design constraints (all load-bearing for the serving hot path):

  * **Near-zero cost when disabled.**  ``span()`` on a disabled tracer is
    one attribute read returning a shared singleton no-op context manager —
    no allocation, no lock, no clock read.  The solver's warm-solve path is
    instrumented unconditionally, so this is what keeps the <2% overhead
    contract (asserted in ``tests/test_obs.py`` via an allocation spy).
  * **Thread-safe.**  Spans may open/close concurrently from any thread
    (the request plane is headed for a background flusher); the finished-
    event buffer is lock-guarded and per-thread nesting depth lives in
    ``threading.local`` storage.
  * **Monotonic clocks.**  ``time.perf_counter_ns`` throughout — wall-clock
    adjustments can never produce negative durations.
  * **Bounded.**  At most ``max_events`` finished spans are retained;
    overflow increments ``dropped`` instead of growing without limit.

Exports:

  * **Chrome trace-event format** (``to_chrome()`` / ``export_chrome()``) —
    complete ("X") events with microsecond timestamps, viewable in Perfetto
    or ``chrome://tracing``.  Nesting is implicit: events on the same thread
    whose time ranges contain each other render as a flame stack.
  * **JSONL** (``export_jsonl()``) — one event object per line for ad-hoc
    ``jq``/pandas analysis.

This module is dependency-free (stdlib only) by design: the tracer must be
importable from every layer — kernels, pipeline, solver, benches — without
dragging torch or numpy into modules that do not already need them.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


class _NoopSpan:
    """Shared do-nothing context manager returned by disabled tracers.

    A single module-level instance serves every disabled ``span()`` call, so
    the disabled hot path allocates nothing (``tracer.span(a) is
    tracer.span(b)``).
    """

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class _DroppedSpan:
    """Context manager for an *unsampled* trace on an enabled tracer.

    Sampling decisions are made at the root span only; everything nested
    under a dropped root must also be dropped, and the no-op singleton
    cannot express that (it does not track enter/exit).  This object
    maintains a per-thread "drop depth" so nested ``span()`` calls know
    they are inside a dropped trace.  It is only ever constructed when
    ``sample_rate < 1.0`` — the always-on and disabled paths never pay
    the allocation.
    """

    __slots__ = ("_tracer",)

    def __init__(self, tracer: "Tracer"):
        self._tracer = tracer

    def __enter__(self) -> "_DroppedSpan":
        tls = self._tracer._tls
        tls.drop_depth = getattr(tls, "drop_depth", 0) + 1
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._tls.drop_depth -= 1
        return False

    def set(self, **attrs) -> "_DroppedSpan":
        return self


class _Span:
    """A live (entered, not yet exited) span.  Only ever constructed by an
    *enabled* tracer — the allocation spy in the tests counts instances of
    this class to prove the disabled path allocates nothing."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.args = args

    def set(self, **attrs) -> "_Span":
        """Attach/override attributes after entry (e.g. a result computed
        inside the span)."""
        if self.args is None:
            self.args = {}
        self.args.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        tls = self._tracer._tls
        tls.depth = getattr(tls, "depth", 0) + 1
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        tls = self._tracer._tls
        depth = getattr(tls, "depth", 1) - 1
        tls.depth = depth
        self._tracer._record(self.name, self._t0, t1 - self._t0, depth,
                             self.args)
        return False


class Tracer:
    """Span recorder with Chrome-trace / JSONL export.

    ``enabled`` gates everything: a disabled tracer's ``span()`` returns the
    shared :data:`NOOP_SPAN` and records nothing.
    """

    def __init__(self, enabled: bool = False, max_events: int = 200_000,
                 sample_rate: float = 1.0):
        """``sample_rate`` keeps 1-in-round(1/rate) *root* spans (depth 0 on
        their thread) and everything nested under them; the other traces are
        dropped wholesale.  The decision is a deterministic counter, not a
        RNG — rate 0.25 records roots 0, 4, 8, ... — so production sampling
        (e.g. 1-in-N daemon flush cycles) is reproducible.  ``1.0`` (the
        default) records everything and skips the sampling machinery
        entirely; the disabled path is unaffected either way."""
        self.enabled = bool(enabled)
        self.max_events = int(max_events)
        sample_rate = float(sample_rate)
        if not 0.0 < sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate wants a fraction in (0, 1], got {sample_rate}")
        self.sample_rate = sample_rate
        self._sample_period = max(1, round(1.0 / sample_rate))
        self._sample_seq = 0
        self.sampled_out = 0   # root spans dropped by the sampler
        self.dropped = 0
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._tls = threading.local()

    # -- control -------------------------------------------------------------

    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def set_sample_rate(self, sample_rate: float) -> "Tracer":
        """Reconfigure sampling on a live tracer (see ``__init__``); the
        root-span counter restarts so the next root is always recorded."""
        sample_rate = float(sample_rate)
        if not 0.0 < sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate wants a fraction in (0, 1], got {sample_rate}")
        with self._lock:
            self.sample_rate = sample_rate
            self._sample_period = max(1, round(1.0 / sample_rate))
            self._sample_seq = 0
        return self

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    # -- recording -----------------------------------------------------------

    def span(self, name: str, **attrs):
        """Context manager timing a named span; ``**attrs`` become the
        event's ``args``.  The no-op singleton when disabled."""
        if not self.enabled:
            return NOOP_SPAN
        if self._sample_period > 1:
            tls = self._tls
            if getattr(tls, "drop_depth", 0) > 0:
                return _DroppedSpan(self)     # inside a dropped trace
            if getattr(tls, "depth", 0) == 0:
                with self._lock:
                    seq = self._sample_seq
                    self._sample_seq += 1
                if seq % self._sample_period != 0:
                    self.sampled_out += 1
                    return _DroppedSpan(self)
        return _Span(self, name, attrs or None)

    def instant(self, name: str, **attrs) -> None:
        """A zero-duration marker event (Chrome "i" phase).  Instants inside
        a sampled-out trace are dropped with it."""
        if not self.enabled:
            return
        tls = self._tls
        if getattr(tls, "drop_depth", 0) > 0:
            return
        self._record(name, time.perf_counter_ns(), None,
                     getattr(tls, "depth", 0), attrs or None)

    def _record(self, name: str, t0_ns: int, dur_ns: Optional[int],
                depth: int, args: Optional[Dict[str, Any]]) -> None:
        ev = {"name": name, "ts_ns": t0_ns, "tid": threading.get_ident(),
              "depth": depth}
        if dur_ns is not None:
            ev["dur_ns"] = dur_ns
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    # -- introspection / export ----------------------------------------------

    def events(self) -> List[dict]:
        """Snapshot copy of the finished-span buffer (oldest first)."""
        with self._lock:
            return [dict(ev) for ev in self._events]

    def span_names(self) -> List[str]:
        with self._lock:
            return [ev["name"] for ev in self._events]

    def durations_ms(self, name: str) -> List[float]:
        """All recorded durations (ms) of spans named ``name``."""
        with self._lock:
            return [ev["dur_ns"] / 1e6 for ev in self._events
                    if ev["name"] == name and "dur_ns" in ev]

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable).

        Complete ("X") events carry microsecond ``ts``/``dur``; instants map
        to thread-scoped "i" events.  All events share this process's pid.
        """
        trace_events = []
        for ev in self.events():
            out = {
                "name": ev["name"],
                "ph": "X" if "dur_ns" in ev else "i",
                "ts": ev["ts_ns"] / 1e3,
                "pid": self._pid,
                "tid": ev["tid"],
            }
            if "dur_ns" in ev:
                out["dur"] = ev["dur_ns"] / 1e3
            else:
                out["s"] = "t"
            if "args" in ev:
                out["args"] = {k: _jsonable(v) for k, v in ev["args"].items()}
            trace_events.append(out)
        return {"traceEvents": trace_events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path

    def export_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for ev in self.events():
                if "args" in ev:
                    ev = dict(ev, args={k: _jsonable(v)
                                        for k, v in ev["args"].items()})
                f.write(json.dumps(ev) + "\n")
        return path


def _jsonable(v):
    """Coerce span attributes to JSON-safe scalars (numpy ints/floats and
    arbitrary objects degrade to ``str``)."""
    if isinstance(v, (str, bool)) or v is None:
        return v
    if isinstance(v, (int, float)):
        return v
    try:
        import numbers
        if isinstance(v, numbers.Integral):
            return int(v)
        if isinstance(v, numbers.Real):
            return float(v)
    except Exception:
        pass
    return str(v)


# -- process-wide default tracer ---------------------------------------------

_GLOBAL = Tracer(
    enabled=os.environ.get("REPRO_TRACE", "0") not in ("", "0", "false"))


def get_tracer() -> Tracer:
    """The process-wide tracer every instrumented module records into.
    Disabled by default; enable with :func:`enable_tracing` or by setting
    ``REPRO_TRACE=1`` in the environment before import."""
    return _GLOBAL


def enable_tracing(sample_rate: Optional[float] = None) -> Tracer:
    """Enable the process-wide tracer; ``sample_rate`` (optional) installs
    1-in-N root-span sampling for always-on production tracing."""
    if sample_rate is not None:
        _GLOBAL.set_sample_rate(sample_rate)
    return _GLOBAL.enable()


def disable_tracing() -> Tracer:
    return _GLOBAL.disable()


def span(name: str, **attrs):
    """Module-level convenience: a span on the process-wide tracer."""
    return _GLOBAL.span(name, **attrs)
