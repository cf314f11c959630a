#!/usr/bin/env python3
"""How far the batched PCG gets at tight tolerances, per column.

Builds the pdGRASS hierarchy of ``mesh2d(s, s, seed=0)`` (alpha 0.05,
chunk 512) and solves 8 right-hand sides from ``np.random.default_rng(1)``
with the V-cycle preconditioner, for every size, tolerance and iteration
cap asked for.  A column that misses the tolerance stops at the cap, so
the true relative residuals at growing caps trace its course: falling,
flat or growing.

The port (``repro_torch``) runs on ``--device``.  With ``--device cpu``
and JAX importable, the JAX reference (``repro``, ``matvec_impl="ref"``)
solves the same graph and right-hand sides beside it.  ``--torch-sum``
adds a run of the port whose column sums are ``torch.sum`` instead of its
fixed pairwise fold: how far the summation order alone moves the
iteration counts.

    PYTHONPATH=src python tools/tol_witness.py --sizes 64,128 --tols 1e-5
    python3 tools/tol_witness.py --device cuda --sizes 1024 \
        --tols 1e-3,1e-4,1e-5 --caps 500,1000,2000
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
K = 8


def _port(s, device, torch_sum=False):
    import torch
    from repro_torch.core.graph import mesh2d
    from repro_torch.pipeline import pdgrass_config
    from repro_torch.solver import build_hierarchy, ell_laplacian, make_solver
    g = mesh2d(s, s, seed=0)
    hier = build_hierarchy(g, config=pdgrass_config(alpha=0.05, chunk=512),
                           device=device)
    solve = make_solver(*ell_laplacian(g, device=device), hier,
                        device=device)

    def run(b, tol, cap):
        from repro_torch.solver import device_pcg
        fold = device_pcg.colsum
        if torch_sum:
            device_pcg.colsum = lambda v: torch.sum(v, dim=0)
        try:
            res = solve(torch.as_tensor(b, device=device), tol=tol,
                        maxiter=cap)
        finally:
            device_pcg.colsum = fold
        return res.iters.tolist(), res.relres.tolist()
    return g.n, hier.level_sizes, run


def _reference(s):
    import jax.numpy as jnp
    from repro.core.graph import mesh2d
    from repro.pipeline import pdgrass_config
    from repro.solver import device_pcg, hierarchy
    g = mesh2d(s, s, seed=0)
    hier = hierarchy.build_hierarchy(
        g, config=pdgrass_config(alpha=0.05, chunk=512))
    solve = device_pcg.make_solver(*device_pcg.ell_laplacian(g), hier,
                                   matvec_impl="ref")

    def run(b, tol, cap):
        res = solve(jnp.asarray(b), tol=tol, maxiter=cap)
        return (np.asarray(res.iters).tolist(),
                np.asarray(res.relres).tolist())
    return g.n, hier.level_sizes, run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="64")
    ap.add_argument("--tols", default="1e-5")
    ap.add_argument("--caps", default="2000")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--torch-sum", action="store_true")
    args = ap.parse_args()
    sizes = [int(v) for v in args.sizes.split(",")]
    tols = [float(v) for v in args.tols.split(",")]
    caps = [int(v) for v in args.caps.split(",")]
    builders = [("port", lambda s: _port(s, args.device))]
    if args.torch_sum:
        builders.append(("port-torch.sum",
                         lambda s: _port(s, args.device, torch_sum=True)))
    if args.device == "cpu":
        try:
            import jax  # noqa: F401
            builders.append(("jax", _reference))
        except ImportError:
            print("jax is not importable: the port alone", flush=True)
    for s in sizes:
        b = np.random.default_rng(1).standard_normal((s * s, K)).astype(
            np.float32)
        for name, build in builders:
            t0 = time.perf_counter()
            n, sizes_, run = build(s)
            print(f"{name} mesh2d({s}, {s}) n={n} levels {sizes_} "
                  f"({time.perf_counter() - t0:.1f} s build)", flush=True)
            for tol in tols:
                for cap in caps:
                    t0 = time.perf_counter()
                    iters, relres = run(b, tol, cap)
                    ok = sum(r <= tol for r in relres)
                    print(f"  {name} tol {tol:g} maxiter {cap}: {ok}/{K} "
                          f"converged, iters {iters}, true relres "
                          f"{[f'{r:.3e}' for r in relres]} "
                          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
