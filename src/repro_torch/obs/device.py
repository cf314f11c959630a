"""Device-timeline annotations and synced spans for the solver internals.

Host spans (:mod:`repro_torch.obs.trace`) time the host's dispatch; CUDA
launches are asynchronous, so they do not time the device.  Two helpers
close that gap, both free while the port's tracer is off:

  * :func:`trace_annotation` — a ``torch.profiler.record_function`` range
    (shown in ``torch.profiler`` traces) plus an NVTX range when CUDA is
    up, so a profile labels device work with solver semantics.
  * :func:`synced_span` — a tracer span that drains the device queue on
    entry and on exit, so a stage's device work is charged to that stage
    and not to whichever span waits next.

With the tracer off each is one attribute read returning the shared
no-op singleton: no range, no clock, no sync.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.obs.trace import NOOP_SPAN, _Span, get_tracer


@contextlib.contextmanager
def _ranges(name: str):
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def trace_annotation(name: str):
    """Profiler range (plus NVTX on CUDA) around the ops issued under it;
    the no-op singleton unless the tracer is on."""
    if not get_tracer().enabled:
        return NOOP_SPAN
    return _ranges(name)


@contextlib.contextmanager
def _synced(span, device: torch.device):
    # The entry's sync drains earlier work before the clock starts; the
    # exit's waits for this span's work before the clock stops.
    torch.cuda.synchronize(device)
    with span as live:
        try:
            yield live
        finally:
            torch.cuda.synchronize(device)


def synced_span(name: str, device, **attrs):
    """``tracer.span(name, **attrs)`` that, while the tracer is on and
    ``device`` is CUDA, synchronizes ``device`` as it opens and as it
    closes; on the CPU, or in a tree the sampler dropped, the plain span;
    with the tracer off the no-op."""
    tracer = get_tracer()
    if not tracer.enabled:
        return NOOP_SPAN
    span = tracer.span(name, **attrs)
    device = torch.device(device)
    if device.type != "cuda" or not isinstance(span, _Span):
        return span
    return _synced(span, device)
