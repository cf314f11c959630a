#!/usr/bin/env python3
"""K2 (the Chebyshev smoother) on the card, level by level: both sweeps
against the forms they replaced; then the fused solve's PCG trip.

    python3 tools/k2_probe.py [--rows 1024] [--reps 50]
    python3 tools/k2_probe.py --trip-only [--src DIR]
    python3 tools/k2_probe.py --ab PARENT_SRC

The default run builds the main path's hierarchy (``build_hierarchy`` on
``mesh2d(rows, rows, seed=0)``, alpha 0.05, chunk 512, device contraction)
and the fused solver, and at every level, on the level's slabs, ``agg`` and
the solver's rho with r, z and zc from ``torch.Generator("cuda")`` (k = 8):

  * holds every form below bitwise against the plain sweep;
  * times, as device ms a sweep (CUDA events over ``--reps`` calls queued
    behind a device sleep), in turns (the list in order, then reversed):
    the pre-smooth as one zero-start launch (``pre``) and as the two step
    launches it replaced (``pre_steps``); the post-smooth as its two
    launches, the prolongation folded in (``post``), and as the gather, the
    add and two step launches it replaced (``post_steps``);
  * prints one JSON line a level with the sweeps' byte bounds.

``--trip-only`` runs the main path's 8-column solve (tol 1e-3) and
profiles 30 PCG trips (``torch.profiler``): solve ms, iterations, each
kernel's launches, wall and device ms a trip, device ops a trip, the
gather kernels' and K2's device ms, the top kernels.  ``--src`` takes the
package from another tree (a parent commit unpacked beside this one).
``--ab PARENT_SRC`` runs ``--trip-only`` four times, one process each, in
turns: the parent, this tree, this tree, the parent; and prints each run's
line.  Card only.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.normpath(os.path.join(HERE, "..", "src"))
SLEEP_CYCLES_PER_S = 2e9      # at most the H100's SM clock: sleeps run long
TOL, MAXITER, K = 1e-3, 2000, 8


def time_ms(torch, fn, reps):
    """Mean device ms per call over ``reps`` calls queued behind a device
    sleep longer than their dispatch, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * reps * call_s, 0.5) * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    return smi[0] if smi else torch.cuda.get_device_name(0)


def main_path(torch, rows):
    import numpy as np

    from repro_torch.core.graph import mesh2d
    from repro_torch.solver import build_hierarchy, ell_laplacian, make_solver

    g = mesh2d(rows, rows, seed=0)
    hier = build_hierarchy(g, alpha=0.05, chunk=512, contraction="device",
                           device="cuda")
    idx, val = ell_laplacian(g, device="cuda")
    solver = make_solver(idx, val, hier, matvec_impl="fused", device="cuda")
    b = np.random.default_rng(1).standard_normal((g.n, K)).astype(np.float32)
    return hier, solver, torch.as_tensor(b, device="cuda")


def trip_only(torch, args):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops as kops

    hier, solver, b = main_path(torch, args.rows)
    solver(b, tol=TOL, maxiter=MAXITER)           # warm-up
    kops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver(b, tol=TOL, maxiter=MAXITER)
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in kops.launch_counts().items() if v}
    trips = 30
    solver(b, tol=TOL, maxiter=trips)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver(b, tol=TOL, maxiter=trips)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / trips
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver(b, tol=TOL, maxiter=trips)
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    names = {}
    for e in evs:
        names[e.name] = names.get(e.name, 0.0) + e.time_range.elapsed_us()
    per = lambda us: us / 1e3 / trips  # noqa: E731
    row = dict(
        src=args.src, card=card(torch), solve_ms=solve_ms,
        iters=res.iters.tolist(), relres=res.relres.tolist(),
        level_sizes=hier.level_sizes, launches=launches,
        trip_wall_ms=wall, trip_device_ms=per(sum(names.values())),
        device_ops=len(evs) / trips,
        gather_ms=per(sum(us for n, us in names.items() if "gather" in n)),
        k2_ms=per(sum(us for n, us in names.items() if "cheby" in n)),
        top=[[n[:60], per(us)] for n, us in
             sorted(names.items(), key=lambda kv: -kv[1])[:8]])
    print(json.dumps(row), flush=True)


def probe(torch, args):
    from repro_torch.kernels import ref
    from repro_torch.kernels import vcycle_fused as vf
    from repro_torch.launch import roofline as rf

    hier, solver, _ = main_path(torch, args.rows)
    rhos = solver.msolve.rhos
    gen = torch.Generator(device="cuda").manual_seed(2)
    print(f"card: {card(torch)}; levels {hier.level_sizes}", flush=True)
    for i, lv in enumerate(hier.levels):
        n, L = lv.idx.shape
        nc = lv.n_coarse
        r, z = (torch.randn((n, K), generator=gen, device="cuda")
                for _ in range(2))
        zc = torch.randn((nc, K), generator=gen, device="cuda")
        inv_d = 1.0 / lv.diag
        agg_l = lv.agg.long()
        theta, delta, sigma = vf.cheby_coeffs(rhos[i])
        ((c1, c2),) = vf.cheby_step_coeffs(delta, sigma, 2)
        smooth = vf.make_fused_chebyshev(lv.idx, lv.val, lv.diag, rhos[i],
                                         degree=2, agg=lv.agg)

        def steps(zs):
            p, z1 = vf.cheby_step(lv.idx, lv.val, inv_d, r, zs,
                                  torch.empty_like(r), torch.empty_like(r),
                                  first=True, theta=theta)
            return vf.cheby_step(lv.idx, lv.val, inv_d, r, z1, p,
                                 torch.empty_like(r), first=False,
                                 theta=theta, c1=c1, c2=c2)[1]

        forms = {
            "pre_steps": lambda: steps(None),
            "pre": lambda: smooth(r),
            "post_steps": lambda: steps(z + zc[agg_l]),
            "post": lambda: smooth(r, z, zc),
        }
        args2 = (lv.idx, lv.val, inv_d, r)
        p1, z1 = ref.cheby_prolong_step_ref(*args2, z, zc, lv.agg,
                                            theta=theta)
        want = {"pre": ref.cheby_smooth_zero_ref(*args2, theta=theta, c1=c1,
                                                 c2=c2)[1],
                "post": ref.cheby_step_ref(*args2, z1, p1, first=False,
                                           theta=theta, c1=c1, c2=c2)[1]}
        for name, fn in forms.items():
            if not torch.equal(fn(), want[name.split("_")[0]]):
                sys.exit(f"level {i}: {name} is not bitwise equal to the "
                         f"plain sweep")
        times = {name: [] for name in forms}
        for order in (list(forms), list(forms)[::-1]):
            for name in order:
                times[name].append(time_ms(torch, forms[name], args.reps))
        pre_b = rf.bound_ms(*rf.cheby_smooth_zero_launch(n, L, K))[0]
        post_b = rf.bound_ms(*rf.cheby_post_smooth_sweep(n, L, K, nc))[0]
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        row = dict(level=i, n=n, L=L, n_coarse=nc, pre_bound_ms=pre_b,
                   post_bound_ms=post_b, ms=ms, runs=times)
        print(json.dumps(row), flush=True)


def ab(args):
    here = os.path.abspath(__file__)
    for src in (args.ab, SRC, SRC, args.ab):
        out = subprocess.run([sys.executable, here, "--trip-only", "--src",
                              os.path.abspath(src), "--rows",
                              str(args.rows)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            sys.exit(f"--trip-only from {src} failed:\n{out.stdout}\n"
                     f"{out.stderr[-4000:]}")
        print(out.stdout.strip().splitlines()[-1], flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--src", default=SRC)
    ap.add_argument("--trip-only", action="store_true")
    ap.add_argument("--ab", metavar="PARENT_SRC")
    args = ap.parse_args()
    if args.ab:
        return ab(args)
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.trip_only:
        return trip_only(torch, args)
    return probe(torch, args)


if __name__ == "__main__":
    sys.exit(main())
