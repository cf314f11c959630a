"""The control of ``correct``: the plain reference in the program's place.

For a cell and some seeds, the inputs its window hands the program first
(the first request's right-hand sides; in ``resparsify`` the first
cycle's conductances) are solved by
:func:`gssbench.reference.refined_pcg`, with the configuration's
refinement (float64 residuals, up to ``max_refine`` passes), in float64
and one precision below the configuration's (float32 with TF32 off, so
TF32 inner solves), and judged by the call a run's check makes
(:func:`gssbench.harness.worst_relres`): the largest ``||b - L x|| /
||b||`` against the configuration's tolerance.  The control has to fail
it.  The benchmark's own runs do not run this::

    python3 gssbench/control.py --workload mesh2d-1024.solve-b32 \
        --seeds 11 12 13 [--device cuda] [--maxiter 10000]

The reference solver is Jacobi-preconditioned CG, so each of its solves
is given more iterations than the program's budget (``--maxiter``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gssbench import reference  # noqa: E402
from gssbench.harness import (RHS, WEIGHTS, Inputs,  # noqa: E402
                              worst_relres)
from gssbench.manifest import Manifest  # noqa: E402


def first_request(inputs: Inputs, traffic: dict):
    """``(weights, B)`` of the first request of a run of ``traffic``."""
    k = int(traffic["columns"])
    w = (inputs.weights(WEIGHTS, 0) if traffic["kind"] == "resparsify"
         else inputs.w0)
    return w, inputs.columns(k, RHS, 0)


def readings(config: dict, traffic: dict, seed: int, device: str = "cpu",
             maxiter: int = 10000) -> dict:
    """The check's number for the reference in float64 and in TF32."""
    inputs = Inputs(config, seed, device)
    w, B = first_request(inputs, traffic)
    L = reference.laplacian(inputs.n, inputs.src, inputs.dst, w)
    s = config["solver"]
    tol = float(s["tol"])
    out = {"limit": tol}
    for precision in ("float64", "tf32"):
        t0 = time.perf_counter()
        X = reference.refined_pcg(L, B, tol, maxiter, int(s["max_refine"]),
                                  precision, device)
        out[precision] = worst_relres(inputs.n, inputs.src, inputs.dst,
                                      [(w, [(B, X)])])
        out[precision + "_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--maxiter", type=int, default=10000)
    args = ap.parse_args(argv)
    manifest = Manifest.load(ROOT)
    entry = manifest.workload(args.workload)
    config = manifest.config(entry["config"])
    traffic = manifest.traffic(entry["traffic"])
    failed = True
    for seed in args.seeds:
        r = readings(config, traffic, seed, args.device, args.maxiter)
        failed &= r["tf32"] > r["limit"]
        print(json.dumps({"workload": args.workload, "seed": seed, **r}),
              flush=True)
    return 0 if failed else 1


if __name__ == "__main__":
    sys.exit(main())
