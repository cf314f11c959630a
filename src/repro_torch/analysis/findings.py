"""Finding records, the rule registry, and suppression pragmas.

The port of ``repro.analysis.findings``.  Every checker in
:mod:`repro_torch.analysis` reports :class:`Finding` records — ``(file,
line, rule id, severity, message)`` — so the CLI, the CI gate and the
tests consume one shape regardless of which analysis produced it.

Suppressions are *inline and reasoned*: a line carrying

    # analysis: allow(<rule-id>): <reason>

silences exactly that rule on that line (or, for block constructs like a
``with`` statement, on the line that opens it).  The reason is mandatory —
a suppression without one is itself reported as ``meta-bare-allow`` — so
every exception to an invariant documents *why* it is safe, reviewable in
the diff that introduced it.

A pragma alone on a comment line applies to the code line directly
below its run of comment lines, so a line that several rules report can
carry one reasoned pragma a rule above it.  A blank line ends the run:
a stray pragma never reaches past it.

The ruleset holds the rules of the ported checkers, each the torch or
CUDA counterpart of the reference's: ``audit-*`` (the dispatch audit,
for the reference's ``jaxpr-*``), ``sync-*`` (the host-sync lint, for
``trace-*``), ``lock-*`` (the lock checker, the reference's own) and
``cuda-*`` (the CUDA resource check, for ``vmem-*``), plus the meta
rules.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import time
from typing import Dict, Iterable, List, Optional, Tuple

SEV_ERROR = "error"
SEV_WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One invariant the analyzers enforce."""

    id: str
    checker: str          # "audit" | "sync" | "locks" | "cuda" | "meta"
    severity: str
    summary: str


# The canonical ruleset.  Rule ids are stable API: tests, suppressions and
# the CI artifact all key on them — add, never repurpose.
RULES: Tuple[Rule, ...] = (
    Rule("lock-unguarded-field", "locks", SEV_ERROR,
         "field listed in a '# lock:' inventory read/written outside "
         "'with <lock>' and outside *_locked methods"),
    Rule("lock-unlocked-call", "locks", SEV_ERROR,
         "*_locked method called without holding the lock"),
    Rule("meta-bare-allow", "meta", SEV_ERROR,
         "suppression pragma without a reason — every allow() must say why"),
    Rule("sync-host-sync", "sync", SEV_ERROR,
         "float()/int()/bool()/.item()/.tolist()/.cpu()/.numpy() of a "
         "tensor in a hot module (a blocking device round trip)"),
    Rule("sync-numpy-on-tensor", "sync", SEV_ERROR,
         "np.* applied to a tensor in a hot module (a silent host copy)"),
    Rule("sync-tensor-branch", "sync", SEV_ERROR,
         "if/while/conditional expression whose test is a tensor in a hot "
         "module (an implicit bool(): a host sync, and a branch a CUDA "
         "graph cannot capture)"),
    Rule("audit-host-transfer", "audit", SEV_ERROR,
         "aten._local_scalar_dense, a copy to the CPU or a CUDA sync "
         "warning inside a registered hot entry"),
    Rule("audit-loop-transfer", "audit", SEV_ERROR,
         "a host transfer whose count grows with the PCG trips faster than "
         "the allowed rate (one per _PCG_CHECK_EVERY trips, at the allowed "
         "line) — a sync per iteration"),
    Rule("audit-f64-promotion", "audit", SEV_ERROR,
         "a float64 output inside a declared-float32 hot entry"),
    Rule("audit-structure-hazard", "audit", SEV_ERROR,
         "the aten op sequence differs between two widths of one RHS pow2 "
         "bucket — one CUDA graph cannot serve the bucket"),
    Rule("cuda-smem-budget", "cuda", SEV_ERROR,
         "a kernel's static shared memory above 48 KiB, or static plus "
         "dynamic above the 227 KiB per-block opt-in (232,448 B)"),
    Rule("cuda-register-budget", "cuda", SEV_ERROR,
         "registers x __launch_bounds__ threads x min blocks above the "
         "65,536 registers of an SM (spills are reported as warnings)"),
    Rule("cuda-launch-limits", "cuda", SEV_ERROR,
         "a level's launch arithmetic overflows the types the kernel's "
         "source uses (grid as unsigned, int n/L/k and int products)"),
    Rule("cuda-tile-halo", "cuda", SEV_ERROR,
         "tile divisibility / halo extent violation in the sharded slab "
         "layout"),
    Rule("meta-not-run", "meta", SEV_ERROR,
         "a check could not run where it must (on the card, or a hot "
         "entry that failed to build or run) — an error, never a quiet "
         "skip"),
)

RULE_IDS = frozenset(r.id for r in RULES)
RULES_BY_ID: Dict[str, Rule] = {r.id: r for r in RULES}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: where, which rule, and what happened."""

    file: str
    line: int
    rule: str
    message: str
    severity: str = SEV_ERROR

    def format(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


_ALLOW_RE = re.compile(
    r"#\s*analysis:\s*allow\(\s*([\w.\-]+)\s*\)\s*(?::\s*(\S.*))?")


def scan_pragmas(source: str, path: str
                 ) -> Tuple[Dict[int, set], List[Finding]]:
    """Collect ``# analysis: allow(<rule>)`` pragmas per line.

    Returns ``(allowed, findings)`` where ``allowed[line]`` is the set of
    rule ids suppressed on that line (a pragma alone on a comment line
    counts for the code line directly below its run of comment lines; a
    blank line in between drops it), and ``findings`` reports bare
    (reason-less) or unknown-rule pragmas — a suppression of nothing is a
    typo that would otherwise silently not suppress."""
    allowed: Dict[int, set] = {}
    findings: List[Finding] = []
    pending: set = set()    # pragmas on comment lines, for the next line
    for i, text in enumerate(source.splitlines(), start=1):
        comment_only = text.lstrip().startswith("#")
        if not text.strip():
            pending = set()
        elif pending and not comment_only:
            allowed.setdefault(i, set()).update(pending)
            pending = set()
        m = _ALLOW_RE.search(text)
        if not m:
            continue
        rule, reason = m.group(1), m.group(2)
        if rule not in RULE_IDS:
            findings.append(Finding(
                file=path, line=i, rule="meta-bare-allow",
                message=f"allow({rule}) names no known rule — valid ids: "
                        f"{', '.join(sorted(RULE_IDS))}"))
            continue
        if not reason:
            findings.append(Finding(
                file=path, line=i, rule="meta-bare-allow",
                message=f"allow({rule}) carries no reason — write "
                        f"'# analysis: allow({rule}): <why this is safe>'"))
            continue
        if comment_only:
            pending.add(rule)
        else:
            allowed.setdefault(i, set()).add(rule)
    return allowed, findings


def apply_pragmas(findings: Iterable[Finding],
                  allowed: Dict[int, set]) -> List[Finding]:
    """Drop findings whose (line, rule) is suppressed by a pragma on the
    same line."""
    return [f for f in findings
            if f.rule not in allowed.get(f.line, ())]


def _git_sha(cwd: str) -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True, cwd=cwd,
                             timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def write_findings_json(path: str, findings: List[Finding],
                        checks_run: List[str],
                        extra: Optional[dict] = None) -> dict:
    """bench-v1-style machine-readable artifact — the same envelope the
    benchmark harness emits (``schema``/``bench``/``git_sha``/``records``)
    so the CI validator and any downstream tooling parse one format."""
    doc = {
        "schema": "bench-v1",
        "bench": "analysis",
        # resolve the SHA from the checked tree (this package lives in
        # it), not from wherever the artifact is being written
        "git_sha": _git_sha(os.path.dirname(os.path.abspath(__file__))),
        "created_unix": time.time(),
        "records": {
            "checks_run": sorted(checks_run),
            "ruleset": [dataclasses.asdict(r) for r in RULES],
            "findings": [f.as_dict() for f in findings],
            "finding_count": len(findings),
        },
    }
    if extra:
        doc.update(extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    return doc
