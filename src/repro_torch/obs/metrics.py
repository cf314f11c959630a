"""Metrics registry: counters, gauges, bounded-bucket latency histograms.

One namespaced surface for every number the serving stack used to scatter
across per-object counters (``LRUCache.hits``) and module globals
(``cache.HASH_EVENTS``):

    from repro_torch.obs import get_metrics

    m = get_metrics()
    m.counter("cache.mem_hits").inc()
    m.histogram("solver.latency.solve_ms").observe(12.7)
    m.snapshot()   # {"cache.mem_hits": 1,
                   #  "solver.latency.solve_ms": {"count": 1, ..., "p99": 12.7}}

Instruments are created on first touch and keyed by dotted names
(``plane.thing.detail``); re-requesting a name returns the same instrument,
and requesting it as a different type raises (a counter silently read as a
gauge is a bug, not a feature).

Histograms are **bounded**: a fixed geometric bucket grid (default ~19
decades at ~1.26x resolution, covering everything from 1e-12 relative
residuals to 1e7 ms latencies) plus count/sum/min/max — O(1) memory per
histogram regardless of observation count, percentile queries by cumulative
bucket counts with linear interpolation inside the winning bucket.  The
relative error of a percentile is therefore at most one bucket ratio
(~26%), which is the right trade for latency telemetry (the oracle test
asserts this against numpy).

Everything here is stdlib-only and thread-safe (one lock per registry, one
per histogram; counters/gauges take the registry's lock only at creation
and rely on a dedicated lock for mutation).
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Optional, Sequence, Union

Number = Union[int, float]


class Counter:
    """Monotonically increasing value (float-capable, for ms accumulators)."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> Number:
        return self._value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def set(self, v: Number) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self) -> Number:
        return self._value


def default_edges() -> List[float]:
    """Geometric bucket edges 1e-12 .. 1e7, 10 per decade (~1.26x steps)."""
    return [10.0 ** (k / 10.0) for k in range(-120, 71)]


class Histogram:
    """Bounded-bucket histogram with percentile snapshots.

    ``edges`` are the bucket upper bounds (ascending); values above the last
    edge land in an overflow bucket whose "upper bound" is the observed max.
    Negative/zero values clamp into the first bucket (latencies and
    iteration counts are nonnegative by construction).
    """

    __slots__ = ("edges", "_counts", "_count", "_sum", "_min", "_max",
                 "_lock")

    def __init__(self, edges: Optional[Sequence[float]] = None):
        self.edges = list(edges) if edges is not None else default_edges()
        if sorted(self.edges) != self.edges:
            raise ValueError("histogram edges must be ascending")
        self._counts = [0] * (len(self.edges) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: Number) -> None:
        v = float(v)
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def observe_many(self, values) -> None:
        for v in values:
            self.observe(v)

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, p: float) -> float:
        """Value at percentile ``p`` (0..100), interpolated within the
        winning bucket; exact at the recorded min/max endpoints."""
        with self._lock:
            return self._percentile_locked(p)

    def _percentile_locked(self, p: float) -> float:
        if self._count == 0:
            return 0.0
        target = (p / 100.0) * self._count
        seen = 0.0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            lo = self.edges[i - 1] if i > 0 else min(self._min, self.edges[0])
            hi = self.edges[i] if i < len(self.edges) else self._max
            lo = max(lo, self._min)
            hi = min(hi, self._max)
            if seen + c >= target:
                frac = (target - seen) / c
                return lo + (hi - lo) * max(0.0, min(1.0, frac))
            seen += c
        return self._max

    def snapshot(self) -> dict:
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                        "p50": 0.0, "p90": 0.0, "p99": 0.0}
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "p50": self._percentile_locked(50),
                "p90": self._percentile_locked(90),
                "p99": self._percentile_locked(99),
            }


class Metrics:
    """A namespaced instrument registry.

    Use the process-wide default (:func:`get_metrics`) for cross-cutting
    plumbing (pipeline stages, hierarchy builds, content hashes), or a
    private instance (``SolverService`` owns one per service) where
    isolation matters — e.g. two services must not share latency histograms.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(*args)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(inst).__name__}, "
                    f"requested as {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  edges: Optional[Sequence[float]] = None) -> Histogram:
        if edges is not None:
            return self._get(name, Histogram, edges)
        return self._get(name, Histogram)

    # convenience one-liners for call sites that don't hold the instrument
    def inc(self, name: str, n: Number = 1) -> None:
        self.counter(name).inc(n)

    def observe(self, name: str, v: Number) -> None:
        self.histogram(name).observe(v)

    def observe_many(self, name: str, values) -> None:
        self.histogram(name).observe_many(values)

    def set_gauge(self, name: str, v: Number) -> None:
        self.gauge(name).set(v)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> dict:
        """Flat ``{name: value-or-histogram-dict}`` copy of every
        instrument.  Every container in the result is freshly built —
        callers can mutate it freely without corrupting live state."""
        with self._lock:
            items = list(self._instruments.items())
        out = {}
        for name, inst in items:
            if isinstance(inst, Histogram):
                out[name] = inst.snapshot()
            else:
                out[name] = inst.value
        return out

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


_GLOBAL = Metrics()


def get_metrics() -> Metrics:
    """The process-wide registry for instrumentation that has no service to
    hang off (pipeline stages, hierarchy builds, distributed recovery,
    content-hash events)."""
    return _GLOBAL
