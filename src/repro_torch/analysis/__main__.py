"""CLI: ``python -m repro_torch.analysis --check all|locks``.

Prints every finding as ``file:line: [rule-id] message``, a per-check
summary, and exits non-zero when anything fired — the CI
``static-analysis`` job is exactly this invocation.  ``--json PATH``
additionally writes the bench-v1-style findings artifact.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List

from repro_torch.analysis import CHECKS, run_checks
from repro_torch.analysis.findings import write_findings_json


def main(argv: List[str] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant checks for the repro_torch tree")
    parser.add_argument(
        "--check", action="append", default=None,
        choices=("all",) + CHECKS, metavar="|".join(("all",) + CHECKS),
        help="checker to run (repeatable; default: all)")
    parser.add_argument(
        "--json", default=None, metavar="PATH",
        help="write the bench-v1-style findings artifact here")
    parser.add_argument(
        "--root", default=None, metavar="DIR",
        help="package tree for the AST checkers "
             "(default: the imported repro_torch package)")
    args = parser.parse_args(argv)
    checks = args.check or ["all"]

    t0 = time.time()
    per_check = run_checks(checks, root=args.root)
    elapsed = time.time() - t0

    findings = [f for fs in per_check.values() for f in fs]
    for f in sorted(findings, key=lambda f: (f.file, f.line, f.rule)):
        print(f.format())

    ran = sorted(per_check)
    counts = ", ".join(f"{c}: {len(per_check[c])}" for c in ran)
    status = "FAIL" if findings else "OK"
    print(f"[analysis] {status} — {len(findings)} finding(s) "
          f"({counts}) in {elapsed:.1f}s")

    if args.json:
        write_findings_json(args.json, findings, ran,
                            extra={"elapsed_s": elapsed})
        print(f"[analysis] wrote {args.json}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
