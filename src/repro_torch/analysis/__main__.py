"""CLI: ``python -m repro_torch.analysis --check all|audit|sync|locks|cuda
[--device cpu|cuda]``.

Prints every finding as ``file:line: [rule-id] message``, the rules that
did not run (the ptxas rules on the CPU without ``--ptxas-log``: not a
pass), a per-check summary, and exits non-zero when anything fired.
``--device`` defaults to ``cuda``, as every entry point of the port does;
on a machine without a card, pass ``--device cpu``.  ``--json PATH``
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
    parser.add_argument(
        "--device", default="cuda", choices=("cpu", "cuda"),
        help="device the audit and the CUDA check run on (default: cuda)")
    parser.add_argument(
        "--ptxas-log", default=None, metavar="PATH",
        help="build log for the CUDA check's ptxas rules (default on the "
             "card: the build's own; on the CPU they do not run)")
    args = parser.parse_args(argv)
    checks = args.check or ["all"]

    t0 = time.time()
    per_check = run_checks(checks, root=args.root, device=args.device,
                           ptxas_log=args.ptxas_log)
    not_run = per_check.not_run
    elapsed = time.time() - t0

    findings = [f for fs in per_check.values() for f in fs]
    for f in sorted(findings, key=lambda f: (f.file, f.line, f.rule)):
        print(f.format())
    if not_run:
        print(f"[analysis] NOT RUN on {args.device}: {', '.join(not_run)} "
              f"(no ptxas log; pass --ptxas-log PATH, or run on the card)")

    ran = sorted(per_check)
    counts = ", ".join(f"{c}: {len(per_check[c])}" for c in ran)
    status = "FAIL" if findings else "OK"
    print(f"[analysis] {status} — {len(findings)} finding(s) "
          f"({counts}) in {elapsed:.1f}s"
          + (f"; {len(not_run)} rule(s) not run" if not_run else ""))

    if args.json:
        write_findings_json(args.json, findings, ran,
                            extra={"elapsed_s": elapsed,
                                   "device": args.device,
                                   "not_run": not_run})
        print(f"[analysis] wrote {args.json}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
