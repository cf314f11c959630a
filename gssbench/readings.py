"""The readings that the limits of a resparsify cell's build numbers are
set from: sound builds on many seeds, and each build fault of
:mod:`gssbench.faults` on a few, at the cell's own size.

Each seed builds the hierarchy of the cell's first cycle (its topology,
conductances drawn from the seed) through the service, as a run's cycle
does, solves that cycle's right-hand sides, and judges both as a run
does (:func:`gssbench.harness.worst_relres`,
:func:`gssbench.build_reference.judge_hierarchy`).  One JSON line a
build.  The benchmark's own runs do not run this::

    python3 gssbench/readings.py --workload ecology2.resparsify \
        --seeds 1 2 3 --fault-seeds 4 5 6 [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from gssbench import build_reference, faults, harness  # noqa: E402
from gssbench.manifest import Manifest  # noqa: E402


def reading(cell, seed: int, fault=None) -> dict:
    """Build and solve the first cycle of ``seed`` (with ``fault``
    planted) and judge both."""
    cell.seed = int(seed)
    cell._make_service()
    patch = faults.Patch()
    if fault is not None:
        faults.BUILD[fault](patch)
    try:
        g, w = cell.reweighted(harness.WEIGHTS, 0)
        b = cell.columns(int(cell.traffic["columns"]), harness.RHS, 0)
        t0 = time.perf_counter()
        resp = cell.flush_one(g, b)
        cell.sync()
        build_s = time.perf_counter() - t0
        hier = harness.host_hierarchy(cell.hierarchy(g))
    finally:
        patch.undo()
    del cell.svc
    s = cell.config["solver"]
    t0 = time.perf_counter()
    got = build_reference.judge_hierarchy(
        cell.n, cell.src, cell.dst, w, hier["levels"], hier["chol"],
        float(s["alpha"]), int(s["c"]), cell.dev)
    judge_s = time.perf_counter() - t0
    relres = harness.worst_relres(cell.n, cell.src, cell.dst,
                                  [(w, [(b, resp.x)])])
    return {"seed": int(seed), "fault": fault, **got, "max_relres": relres,
            "levels": [lev["n"] for lev in hier["levels"]],
            "build_solve_s": build_s, "judge_s": judge_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=sorted(
        set(faults.BUILD) - {"stale_build"}))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    manifest = Manifest.load(ROOT)
    cell = harness._Cell(manifest, args.workload, 0, 0.0, False,
                         args.device, time.perf_counter(), None, None)
    if cell.traffic["kind"] != "resparsify":
        raise SystemExit(f"{args.workload} builds no hierarchy a cycle")
    runs = [(seed, None) for seed in args.seeds]
    runs += [(seed, f) for f in args.faults for seed in args.fault_seeds]
    for seed, fault in runs:
        print(json.dumps({"workload": args.workload,
                          **reading(cell, seed, fault)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
