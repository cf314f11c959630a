"""What the metric readers of ``gssbench/metrics/`` share.

Each reader takes a :class:`gssbench.harness.Run` and returns a number, or
``None`` when the run holds nothing it can read (no such traffic, no
device trace, no batch outside the traced one).  Span-based numbers leave
out the batch that ran under the profiler, whose host work the profiler
slows.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from gssbench import roofline


def clean_batches(run) -> list:
    return [b for b in run.batches if not b.profiled]


def span_s(run, batch, names) -> float:
    """Seconds of the program's spans named in ``names`` that start
    inside ``batch``."""
    t0, t1 = batch.t0 * 1e9, batch.t1 * 1e9
    return sum(e["dur_ns"] for e in run.spans
               if e["name"] in names and t0 <= e["ts_ns"] <= t1) / 1e9


def per_batch_span_s(run, names) -> Optional[float]:
    """Mean over the untraced batches of their summed spans ``names``."""
    batches = clean_batches(run)
    if not batches or not run.spans:
        return None
    return float(np.mean([span_s(run, b, names) for b in batches]))


def mean_iters(run) -> Optional[float]:
    """Mean PCG iterations a column (solve and refinement passes)."""
    iters: List[int] = [int(i) for b in run.batches for i in b.iters]
    return float(np.mean(iters)) if iters else None


def idle_pct(run) -> Optional[float]:
    """The share of the traced window with nothing running on the device."""
    d = run.device
    if d is None or d.busy_s <= 0 or d.window_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)


def trips(batch) -> int:
    """PCG trips of a batch: the most iterations of any of its columns."""
    return int(np.max(batch.iters)) if len(batch.iters) else 0


def solve_roofline(run) -> Optional[float]:
    """The least time of the traced flush's solve (its trips' bytes at the
    HBM rate) over the device time of the work under its solve and
    refinement ranges, in %."""
    d = run.device
    traced = [b for b in run.batches if b.profiled]
    if d is None or not traced or not run.shapes:
        return None
    device_s = sum(d.annotated_s.values())
    if device_s <= 0:
        return None
    s = run.shapes
    nbytes = roofline.pcg_trip_bytes(s["n"], s["ell_width"], s["k"],
                                     s["level_triples"]) * trips(traced[0])
    return 100.0 * nbytes / roofline.HBM_BW / device_s
