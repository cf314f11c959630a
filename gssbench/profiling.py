"""The traced window of a ``--trace 1`` run: ``torch.profiler`` (CUPTI on
the card) over part of the measured window, reduced to device numbers.

:class:`TracedWindow` starts the profiler and opens the range
``gssbench.traced_window``; :meth:`TracedWindow.stop` closes both, and
:meth:`TracedWindow.reduce`, after the measured window, turns the raw
events (kernels, copies and memsets on the device; ranges and operators
on the host) into a :class:`DeviceTrace`:

* ``window_s``: the range's length; ``busy_s``: the union of device
  activity inside it.
* ``op_s``: device seconds by kernel name.
* ``gap_s``: idle device seconds inside the window, by what the host was
  doing at each gap's middle: the innermost named range (a program span
  of the tracer or a profiler range) and the innermost host operator.
* ``annotated_s``: device seconds of the activity inside the device-side
  extent of a named range (``solver.solve``, ``solver.refine``).
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Tuple

WINDOW = "gssbench.traced_window"


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    op_s: Dict[str, float]
    gap_s: Dict[str, float]
    annotated_s: Dict[str, float]

    def top(self, table: Dict[str, float], n: int = 10) -> List[list]:
        return [[k, v] for k, v in
                sorted(table.items(), key=lambda kv: -kv[1])[:n]]


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _innermost(points: List[int], ranges: List[Tuple[int, int, str]]):
    """For each of the sorted ``points``, the name of the latest-started
    range of ``ranges`` (start, end, name) that covers it, or ``None``."""
    ranges = sorted(ranges)
    heap: list = []
    out, i = [], 0
    for t in points:
        while i < len(ranges) and ranges[i][0] <= t:
            s, e, name = ranges[i]
            heapq.heappush(heap, (-s, e, name))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def classify(e) -> str:
    """``"device"`` (a kernel, copy or memset), ``"gpu_range"`` (a named
    range's extent on the device), ``"range"`` (a named range on the
    host) or ``"op"`` (an operator or a CUDA runtime call on the host)."""
    on_device = str(e.device_type()).split(".")[-1] != "CPU"
    if e.is_user_annotation():
        return "gpu_range" if on_device else "range"
    return "device" if on_device else "op"


def reduce_events(events, host_spans=(), offset_ns: int = 0,
                  annotations=("solver.solve", "solver.refine")
                  ) -> Optional[DeviceTrace]:
    """Reduce raw profiler events (objects with ``name()``,
    ``device_type()``, ``is_user_annotation()``, ``start_ns()``,
    ``duration_ns()``) to a :class:`DeviceTrace`.  ``host_spans`` are the
    tracer's ``(start_ns, end_ns, name)`` on ``time.perf_counter_ns``;
    ``offset_ns`` maps them onto the profiler's clock.  ``None`` when the
    events hold no traced window."""
    window = None
    device, ranges, ops, gpu_ranges = [], [], [], []
    for e in events:
        kind = classify(e)
        item = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if kind == "device":
            device.append(item)
        elif kind == "range":
            if item[2] == WINDOW:
                window = item[:2]
            else:
                ranges.append(item)
        elif kind == "op":
            ops.append(item)
        elif item[2] in annotations:
            gpu_ranges.append(item)
    if window is None:
        return None
    w0, w1 = window
    ranges += [(s + offset_ns, e + offset_ns, name)
               for s, e, name in host_spans]
    inside = [(max(s, w0), min(e, w1), name) for s, e, name in device
              if e > w0 and s < w1]
    op_s: Dict[str, float] = {}
    for s, e, name in inside:
        op_s[name] = op_s.get(name, 0.0) + (e - s) / 1e9
    busy = _merge([(s, e) for s, e, _ in inside])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    mids = [(s + e) // 2 for s, e in gaps]
    where = _innermost(mids, ranges)
    what = _innermost(mids, ops)
    gap_s: Dict[str, float] = {}
    for (s, e), rng, op in zip(gaps, where, what):
        label = (rng or "no named range") + (f" / {op}" if op else "")
        gap_s[label] = gap_s.get(label, 0.0) + (e - s) / 1e9
    annotated_s: Dict[str, float] = {}
    for name in annotations:
        spans = _merge([(s, e) for s, e, n in gpu_ranges if n == name])
        if not spans:
            continue
        total, j = 0, 0
        for s, e in busy:
            while j < len(spans) and spans[j][1] <= s:
                j += 1
            k = j
            while k < len(spans) and spans[k][0] < e:
                total += min(e, spans[k][1]) - max(s, spans[k][0])
                k += 1
        annotated_s[name] = total / 1e9
    return DeviceTrace(window_s=(w1 - w0) / 1e9,
                       busy_s=sum(e - s for s, e in busy) / 1e9, op_s=op_s,
                       gap_s=gap_s, annotated_s=annotated_s)


class TracedWindow:
    """``start()`` ... ``stop()`` around part of the window, ``reduce()``
    after it."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self._prof = None
        self._range = None
        self._t0_ns = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, record_shapes=False,
                             with_stack=False, profile_memory=False)
        self._prof.start()
        self._t0_ns = time.perf_counter_ns()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    def stop(self) -> None:
        """Close the window; its events wait for :meth:`reduce`."""
        self._range.__exit__(None, None, None)
        self._prof.stop()

    def reduce(self, host_spans=()) -> Optional[DeviceTrace]:
        """Reduce the window's events, after the measured window.
        ``host_spans``: the tracer's ``(start_ns, end_ns, name)``."""
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        start = [e.start_ns() for e in events
                 if e.name() == WINDOW and classify(e) == "range"]
        offset = start[0] - self._t0_ns if start else 0
        return reduce_events(events, host_spans, offset)
