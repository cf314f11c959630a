"""Dispatch audit: run the registered hot entries and read every aten op.

The port of ``repro.analysis.jaxpr_audit``.  The sync lint
(:mod:`repro_torch.analysis.sync_lint`) reads *source*; this audit sees
what an entry actually dispatched, under a
``torch.utils._python_dispatch.TorchDispatchMode`` that records every
aten op, its outputs' dtypes and devices, and the first stack frame
outside PyTorch and outside this package, where findings are located.
When the entry's arguments lie on the card, it also runs under
``torch.cuda.set_sync_debug_mode("warn")``, and each sync warning is
collected at the op that raised it: that catches syncs inside ops the
dispatch mode cannot see into or that bypass it (a copy's implicit
synchronize, ``torch.tensor(x, device="cuda")``'s host-to-device copy, a
library call's check).

Four rules over each entry of
:data:`repro_torch.analysis.registry.HOT_ENTRIES`:

``audit-host-transfer``
    ``aten._local_scalar_dense`` (``.item()``, ``bool()``, ``int()`` of a
    tensor), an op that copies a CUDA tensor to the CPU, or a sync
    warning, anywhere in the entry; one finding a site.

``audit-loop-transfer``
    eager PyTorch has no while body, so the loop is measured by its
    growth: a PCG entry runs at tol 0 at two trip counts
    (:data:`TRIPS`), and a transfer site whose count grows with the trips
    is a sync inside the loop.  The one allowed rate is one transfer
    every ``_PCG_CHECK_EVERY`` trips
    (:data:`repro_torch.solver.device_pcg._PCG_CHECK_EVERY`), at a line
    that carries ``# analysis: allow(audit-loop-transfer): <reason>``;
    anything faster, or elsewhere, is a finding.

``audit-f64-promotion``
    any float64 output inside a ``declared_dtype="float32"`` entry.

``audit-structure-hazard``
    the aten op sequence at ``k = 5`` and ``k = 7`` (one pow2 bucket)
    differs, so one CUDA graph could not serve the bucket
    (``solver/service.py`` warms and pads per bucket).

An entry that fails to build or run is a ``meta-not-run`` finding.
Pragmas are read from the source of the site's file.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import warnings
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding, scan_pragmas
from repro_torch.analysis.registry import AUDIT_TRIPS, HOT_ENTRIES, HotEntry

#: the two trip counts of the loop rule
TRIPS = (AUDIT_TRIPS, 2 * AUDIT_TRIPS)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.dirname(os.path.abspath(__file__))
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))
_SKIP = (_HERE, _TORCH, os.path.dirname(os.path.abspath(
    dataclasses.__file__)))   # the standard library's frames

Site = Tuple[str, int]
_SYNC_WARNING = "called a synchronizing CUDA operation"


def _site() -> Site:
    """``(file, line)`` of the first frame outside this package, PyTorch
    and the standard library; a ``repro_torch`` file is reported relative
    to the package's parent (``repro_torch/solver/device_pcg.py``)."""
    f = sys._getframe(2)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PKG + os.sep) and not path.startswith(_HERE):
            return os.path.relpath(path, os.path.dirname(_PKG)), f.f_lineno
        if not path.startswith(_SKIP) and not path.startswith("<"):
            return path, f.f_lineno
        f = f.f_back
    return "<unknown>", 1


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def device_of(args) -> torch.device:
    """The device a call runs on, from its tensor arguments: the card if
    any of them lies there.  A call with no tensor argument is refused:
    the audit would not know whether to watch the card's syncs."""
    devices = {t.device for t in _tensors(args)}
    if not devices:
        raise ValueError("the audited call has no tensor argument, so its "
                         "device cannot be told")
    return next((d for d in devices if d.type == "cuda"),
                next(iter(devices)))


class _Recorder(TorchDispatchMode):
    """Records every aten op of a run: its name and site, the transfer
    sites (with counts and what they were) and the float64 sites."""

    def __init__(self):
        super().__init__()
        self.ops: List[str] = []
        self.transfers: Counter = Counter()
        self.what: Dict[Site, set] = {}
        self.f64: Dict[Site, str] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.name()
        self.ops.append(name)
        outs = list(_tensors(out))
        to_cpu = (any(t.device.type == "cpu" for t in outs)
                  and any(t.device.type != "cpu"
                          for t in _tensors((args, kwargs))))
        if name == "aten::_local_scalar_dense" or to_cpu:
            site = _site()
            self.transfers[site] += 1
            kind = "a copy to the CPU" if to_cpu else "a scalar read"
            self.what.setdefault(site, set()).add(f"{name} ({kind})")
        if any(t.dtype == torch.float64 for t in outs):
            self.f64.setdefault(_site(), name)
        return out


def run_recorded(fn: Callable, args: tuple) -> "_Recorder":
    """Run ``fn(*args)`` under the recorder; when its arguments lie on
    the card also under the sync debug mode, synchronizing before and
    after so that no other work is charged to it.

    PyTorch raises a sync warning as a Python warning at the call that
    entered it, so a ``showwarning`` hook locates each at the first frame
    of the caller's code, like an op.  A site's transfers are the larger
    of its two counts (a scalar read is both an op and a sync)."""
    cuda = device_of(args).type == "cuda"
    rec = _Recorder()
    syncs: Counter = Counter()
    if cuda:
        torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def hook(message, category, filename, lineno, file=None,
                 line=None):
            if _SYNC_WARNING in str(message):
                syncs[_site()] += 1
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = hook
        if cuda:
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with rec:
                fn(*args)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(prev)
    if cuda:
        torch.cuda.synchronize()
    for site, n in syncs.items():
        rec.transfers[site] = max(rec.transfers[site], n)
        rec.what.setdefault(site, set()).add("a CUDA sync warning")
    return rec


class _Pragmas:
    """Per-file pragma tables, read once; ``source`` overrides the
    reader (the tests strip a pragma this way)."""

    def __init__(self, source: Optional[Callable[[str], str]] = None):
        self.source = source
        self.tables: Dict[str, Dict[int, set]] = {}

    def allowed(self, site: Site) -> set:
        path, line = site
        if path not in self.tables:
            full = path if os.path.isabs(path) else os.path.join(
                os.path.dirname(_PKG), path)
            if self.source is not None:
                text = self.source(path)
            elif os.path.exists(full):
                with open(full) as f:
                    text = f.read()
            else:
                text = ""
            self.tables[path] = scan_pragmas(text, path)[0]
        return self.tables[path].get(line, set())


@dataclasses.dataclass
class AuditReport:
    """Findings of one audited callable, and what its runs measured:
    ``ops`` and ``transfers`` of the first run, and for a trip loop the
    growth a trip (``ops_per_trip``, ``transfers_per_trip``)."""

    findings: List[Finding]
    ops: int = 0
    transfers: int = 0
    ops_per_trip: Optional[float] = None
    transfers_per_trip: Optional[float] = None


def _with_trips(args: tuple, pos: int, trips: int) -> tuple:
    return args[:pos] + (trips,) + args[pos + 1:]


def audit_callable(name: str, fn: Callable, args: tuple,
                   sibling: Optional[tuple] = None, *,
                   trips_arg: Optional[int] = None,
                   declared_dtype: str = "float32",
                   source: Optional[Callable[[str], str]] = None
                   ) -> AuditReport:
    """Run the four rules over ``fn``: ``args`` is the first run (with
    ``trips_arg``, its trip cap is set to ``TRIPS[0]``, then a second run
    at ``TRIPS[1]`` measures the loop), ``sibling`` the other width of
    the bucket.  The device is the arguments' (:func:`device_of`)."""
    from repro_torch.solver.device_pcg import _PCG_CHECK_EVERY

    pragmas = _Pragmas(source)
    findings: List[Finding] = []
    if trips_arg is not None:
        args = _with_trips(args, trips_arg, TRIPS[0])
    fn(*args)       # unrecorded: first-call work is not the steady state
    first = run_recorded(fn, args)
    report = AuditReport(findings, ops=len(first.ops),
                         transfers=sum(first.transfers.values()))

    for site, count in sorted(first.transfers.items()):
        if "audit-host-transfer" in pragmas.allowed(site):
            continue
        findings.append(Finding(
            file=site[0], line=site[1], rule="audit-host-transfer",
            message=f"{count} host transfer(s) in hot entry '{name}': "
                    f"{', '.join(sorted(first.what[site]))} — a blocking "
                    f"device round trip per call"))

    if declared_dtype == "float32":
        for site, op in sorted(first.f64.items()):
            if "audit-f64-promotion" in pragmas.allowed(site):
                continue
            findings.append(Finding(
                file=site[0], line=site[1], rule="audit-f64-promotion",
                message=f"'{op}' produces float64 inside declared-float32 "
                        f"hot entry '{name}'"))

    if trips_arg is not None:
        second = run_recorded(fn, _with_trips(args, trips_arg, TRIPS[1]))
        extra = TRIPS[1] - TRIPS[0]
        report.ops_per_trip = (len(second.ops) - len(first.ops)) / extra
        report.transfers_per_trip = (sum(second.transfers.values())
                                     - report.transfers) / extra
        for site in sorted(set(first.transfers) | set(second.transfers)):
            rate = (second.transfers[site] - first.transfers[site]) / extra
            if rate <= 0:
                continue
            if rate <= 1.0 / _PCG_CHECK_EVERY and \
                    "audit-loop-transfer" in pragmas.allowed(site):
                continue
            findings.append(Finding(
                file=site[0], line=site[1], rule="audit-loop-transfer",
                message=f"{rate:g} host transfer(s) a PCG trip in hot "
                        f"entry '{name}' ({first.transfers[site]} at "
                        f"{TRIPS[0]} trips, {second.transfers[site]} at "
                        f"{TRIPS[1]}): "
                        f"{', '.join(sorted(second.what[site]))} — the "
                        f"allowed rate is one every {_PCG_CHECK_EVERY} "
                        f"trips, at a line that allows it"))

    if sibling is not None:
        if trips_arg is not None:
            sibling = _with_trips(sibling, trips_arg, TRIPS[0])
        other = run_recorded(fn, sibling)
        a, b = first.ops, other.ops
        if a != b:
            i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            findings.append(Finding(
                file=f"<entry:{name}>", line=1,
                rule="audit-structure-hazard",
                message=f"aten op sequence differs between two widths of "
                        f"one RHS bucket for '{name}' ({len(a)} vs "
                        f"{len(b)} ops, first divergence at #{i}: "
                        f"{a[i] if i < len(a) else '<end>'} vs "
                        f"{b[i] if i < len(b) else '<end>'}) — one CUDA "
                        f"graph cannot serve the bucket"))
    return report


def audit_entry(entry: HotEntry, device="cuda",
                source: Optional[Callable[[str], str]] = None
                ) -> AuditReport:
    """Build one registered entry on ``device`` and audit it."""
    try:
        fn, small, sibling = entry.build(torch.device(device))
        return audit_callable(entry.name, fn, small, sibling,
                              trips_arg=entry.trips_arg,
                              declared_dtype=entry.declared_dtype,
                              source=source)
    except Exception as e:   # a hot entry that cannot run is a finding
        return AuditReport([Finding(
            file=f"<entry:{entry.name}>", line=1, rule="meta-not-run",
            message=f"entry {entry.name} failed to build or run on "
                    f"{device}: {type(e).__name__}: {e}")])


def check_registry(entries: Optional[Sequence[HotEntry]] = None,
                   device="cuda") -> List[Finding]:
    """Audit every registered hot entry (or an explicit subset) on
    ``device``.  A CUDA device that is not there is a ``meta-not-run``
    finding: on the card a check that cannot run is an error."""
    if torch.device(device).type == "cuda" and \
            not torch.cuda.is_available():
        return [Finding(file="<audit>", line=1, rule="meta-not-run",
                        message="the dispatch audit was asked for the "
                                "card, but torch.cuda.is_available() is "
                                "false")]
    out: List[Finding] = []
    for entry in (HOT_ENTRIES if entries is None else entries):
        out.extend(audit_entry(entry, device).findings)
    return out
