"""Static invariant checkers of the port.

The port of ``repro.analysis``, one checker so far, in the
:class:`~repro_torch.analysis.findings.Finding` shape:

* ``locks`` — :mod:`repro_torch.analysis.lock_lint`: ``# lock:``
  inventory discipline of the threaded service, daemon and kernel
  launch state, read from the AST.

CLI: ``python -m repro_torch.analysis --check locks [--json PATH]``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.findings import (  # noqa: F401  (public API)
    RULES, RULES_BY_ID, RULE_IDS, Finding, write_findings_json)

CHECKS = ("locks",)


def _default_root() -> str:
    """The ``src/repro_torch`` package directory this module was imported
    from."""
    return os.path.dirname(os.path.abspath(__file__)).rsplit(
        os.sep + "analysis", 1)[0]


def run_checks(checks: Sequence[str] = ("all",),
               root: Optional[str] = None) -> Dict[str, List[Finding]]:
    """Run the selected checkers; returns ``{check: findings}``.

    ``root`` overrides the tree the AST checkers walk (default: the
    installed ``repro_torch`` package directory).
    """
    selected = list(CHECKS) if "all" in checks else list(checks)
    unknown = sorted(set(selected) - set(CHECKS))
    if unknown:
        raise ValueError(
            f"unknown check(s) {unknown}; valid: all, {', '.join(CHECKS)}")
    root = root or _default_root()
    out: Dict[str, List[Finding]] = {}
    for check in selected:
        if check == "locks":
            from repro_torch.analysis.lock_lint import check_tree
            out[check] = check_tree(root)
    return out
