"""Device-timeline annotations: semantic labels for the solver internals.

Host spans (:mod:`repro_torch.obs.trace`) time the host's dispatch; CUDA
launches are asynchronous, so they do not time the device.  Two mechanisms
put solver semantics onto the profiler's device timeline instead:

  * :func:`named_scope` — a ``torch.profiler.record_function`` range (shown
    in ``torch.profiler`` traces; near-free when no profiler is active) plus
    an NVTX range when the work runs on CUDA.  Always on.
  * :func:`trace_annotation` — the same pair, but only while the port's
    tracer is enabled, so the disabled hot path stays free.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.obs.trace import get_tracer


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


def named_scope(name: str):
    """Profiler range (plus NVTX on CUDA) around the ops issued under it."""
    return _ranges(name)


def trace_annotation(name: str):
    """Profiler range around a dispatch; no-op unless the tracer is on."""
    if not get_tracer().enabled:
        return contextlib.nullcontext()
    return _ranges(name)

