"""Static and run-time invariant checkers of the port.

The port of ``repro.analysis``: four checkers, one
:class:`~repro_torch.analysis.findings.Finding` shape, each the torch or
CUDA counterpart of the reference's (in brackets):

* ``audit`` [``jaxpr``] — :mod:`repro_torch.analysis.dispatch_audit`: run
  the registered hot entries (:mod:`repro_torch.analysis.registry`) under
  a dispatch mode (and, on the card, the CUDA sync debug mode) and flag
  host transfers, transfers that grow with the PCG trips, float64
  outputs, and op sequences that differ inside one RHS bucket.
* ``sync`` [``trace``] — :mod:`repro_torch.analysis.sync_lint`: AST lint
  of the hot modules for host syncs, numpy on tensors and branches on
  tensors.
* ``locks`` — :mod:`repro_torch.analysis.lock_lint`: ``# lock:``
  inventory discipline of the threaded service, daemon and kernel launch
  state.
* ``cuda`` [``vmem``] — :mod:`repro_torch.analysis.cuda_check`: the
  kernels' registers, shared memory and spills from the build's ptxas
  log, their launch arithmetic against the suite's levels, and the
  sharded slab layout.

Every checker takes an explicit device; ``"cuda"`` is the default, as for
every entry point of the port.  On the card a check that cannot run is a
``meta-not-run`` finding.  On the CPU the ptxas rules need a build log;
without one they are listed as not run, which is not a pass.

CLI: ``python -m repro_torch.analysis --check all --device cpu [--json
PATH]``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.findings import (  # noqa: F401  (public API)
    RULES, RULES_BY_ID, RULE_IDS, Finding, write_findings_json)

CHECKS = ("audit", "sync", "locks", "cuda")


def _default_root() -> str:
    """The ``src/repro_torch`` package directory this module was imported
    from."""
    return os.path.dirname(os.path.abspath(__file__)).rsplit(
        os.sep + "analysis", 1)[0]


class CheckResults(dict):
    """``{check: findings}`` of one run, and ``not_run``: the ids of the
    rules that could not run (the ptxas rules on the CPU without a build
    log), which is not a pass."""

    def __init__(self, findings: Dict[str, List[Finding]],
                 not_run: Sequence[str] = ()):
        super().__init__(findings)
        self.not_run = list(not_run)


def run_checks(checks: Sequence[str] = ("all",),
               root: Optional[str] = None, *, device="cuda",
               ptxas_log: Optional[str] = None) -> CheckResults:
    """Run the selected checkers; returns ``{check: findings}`` with the
    rules that did not run in its ``not_run``.

    ``root`` overrides the tree the AST checkers walk (default: the
    installed ``repro_torch`` package directory); the audit and the CUDA
    check run against the imported code on ``device``.  ``ptxas_log`` is
    a build log for the CUDA check's ptxas rules.
    """
    selected = list(CHECKS) if "all" in checks else list(checks)
    unknown = sorted(set(selected) - set(CHECKS))
    if unknown:
        raise ValueError(
            f"unknown check(s) {unknown}; valid: all, {', '.join(CHECKS)}")
    root = root or _default_root()
    out = CheckResults({})
    for check in selected:
        if check == "audit":
            from repro_torch.analysis.dispatch_audit import check_registry
            out[check] = check_registry(device=device)
        elif check == "sync":
            from repro_torch.analysis.sync_lint import check_tree
            out[check] = check_tree(root)
        elif check == "locks":
            from repro_torch.analysis.lock_lint import check_tree
            out[check] = check_tree(root)
        elif check == "cuda":
            from repro_torch.analysis.cuda_check import check_suite
            report = check_suite(device=device, ptxas_log=ptxas_log)
            out[check] = report.findings
            out.not_run.extend(report.not_run)
    return out
