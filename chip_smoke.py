#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

  1. build the CUDA kernels K1-K3 from ``src/repro_torch/kernels/csrc``;
  2. hold each kernel against its plain PyTorch version on the card at
     edge sizes (n = 31, 100, 257; k = 1, 3, 8, 16; x with more rows than
     the slab for K1): K1 bitwise, K2 and K3 within rtol 1e-5 and
     atol 1e-5 * max|input| (the kernels round every operation on its own,
     so they are expected bitwise too);
  3. the main path: ``build_hierarchy`` on ``mesh2d(1024, 1024, seed=0)``
     (n = 1,048,576, m = 3,141,633; the scale of the paper's NACA0015 FEM
     mesh), then ``make_solver(matvec_impl="fused")`` and one solve of 8
     right-hand sides (tol 1e-3, maxiter 2000), with every kernel's launch
     count read over that run.  tol 1e-3 is the tightest power of ten the
     float32 PCG reaches on all 8 columns at this size; the JAX reference
     misses tighter targets too (``tools/tol_witness.py`` and PERF.md).
     A second build of the same graph with the tracer on prints the
     per-stage seconds (the first build is untraced and cold);
  4. the same solve through the plain versions (``matvec_impl="ref"``) on
     the same hierarchy (iterations within +-1 per column, re-based x
     allclose) and a second fused solve (bitwise equal x and iterations);
  5. each kernel timed at the main path's shapes beside its plain version,
     its byte/operation bound and, for K1, ``torch.sparse.mm`` on a CSR copy.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
MAIN_ROWS = 1024
TOL, MAXITER, K = 1e-3, 2000, 8


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(torch, fn, reps: int = 20) -> float:
    """Mean device ms per call over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_close(torch, name, got, want, scale):
    err = float((got - want).abs().max()) if got.numel() else 0.0
    tol = 1e-5 * float(want.abs().max()) + 1e-5 * scale
    if not torch.isfinite(got).all() or err > tol:
        fail(f"{name}: max abs err {err:.3e} > {tol:.3e}")
    return err


def edge_checks(torch, vf, ref):
    """K1-K3 against their plain versions at the regression sizes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    n_checked = 0
    for n in (31, 100, 257):
        for k in (1, 3, 8, 16):
            L = 5
            nx = n + 7
            idx = torch.randint(0, nx, (n, L), generator=gen, device=dev,
                                dtype=torch.int32)
            val = torch.randn((n, L), generator=gen, device=dev)
            x = torch.randn((nx, k), generator=gen, device=dev)
            if not torch.equal(vf.spmv_ell_batched(idx, val, x),
                               ref.spmv_ell_batched_ref(idx, val, x)):
                fail(f"K1 not bitwise equal at n={n} k={k} nx={nx}")
            # K2 / K3 work on square slabs
            idx_sq = idx % n
            inv_d = torch.rand((n,), generator=gen, device=dev) + 0.5
            r = torch.randn((n, k), generator=gen, device=dev)
            z = torch.randn((n, k), generator=gen, device=dev)
            p0 = torch.randn((n, k), generator=gen, device=dev)
            scale = max(float(r.abs().max()), float(z.abs().max()),
                        float(val.abs().max()))
            for first, zp in ((True, None), (True, z), (False, z)):
                kw = dict(first=first, theta=1.37, c1=0.61, c2=0.93)
                p_k, z_k = vf.cheby_step(idx_sq, val, inv_d, r, zp, p0.clone(),
                                         torch.empty_like(r), **kw)
                p_r, z_r = ref.cheby_step_ref(idx_sq, val, inv_d, r, zp,
                                              p0.clone(), **kw)
                check_close(torch, f"K2 p n={n} k={k}", p_k, p_r, scale)
                check_close(torch, f"K2 z n={n} k={k}", z_k, z_r, scale)
            nc = max(1, n // 3)
            agg = torch.randint(0, nc, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
            agg[:nc] = torch.arange(nc, device=dev, dtype=torch.int32)
            from repro_torch.solver.hierarchy import aggregate_csr
            perm, ptr, amax = aggregate_csr(agg, nc)
            got = vf.restrict_residual(idx_sq, val, perm, ptr, amax, r, z)
            want = ref.restrict_residual_ref(idx_sq, val, perm, ptr, amax,
                                             r, z)
            check_close(torch, f"K3 n={n} k={k}", got, want, scale)
            n_checked += 1
    torch.cuda.synchronize()
    return n_checked


def kernel_records(torch, vf, ref, hier, idx, val, counts):
    """Each kernel at the main path's shapes: error against its plain
    version, device ms beside the plain version's, its bound and (K1) the
    ``torch.sparse.mm`` yardstick."""
    lev = hier.levels[0]
    n, L = lev.idx.shape
    nc = lev.n_coarse
    gen = torch.Generator(device="cuda").manual_seed(1)
    r = torch.randn((n, K), generator=gen, device="cuda")
    z = torch.randn((n, K), generator=gen, device="cuda")
    p0 = torch.randn((n, K), generator=gen, device="cuda")
    inv_d = 1.0 / lev.diag
    records = []

    # K1 on the top-level operator (the PCG matvec)
    tn, tL = idx.shape
    x = torch.randn((tn, K), generator=gen, device="cuda")
    y_k = vf.spmv_ell_batched(idx, val, x)
    y_r = ref.spmv_ell_batched_ref(idx, val, x)
    err1 = float((y_k - y_r).abs().max())
    if not torch.equal(y_k, y_r):
        fail(f"K1 is not bitwise equal to its plain version at the main "
             f"path's shape (max abs err {err1:.3e})")
    # the same operator as a valid CSR (sorted, unique columns per row; the
    # ELL padding entries are zeros on the diagonal and merge into it)
    rows = torch.arange(tn, device="cuda").repeat_interleave(tL)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        A = torch.sparse_coo_tensor(
            torch.stack([rows, idx.flatten().long()]), val.flatten(),
            (tn, tn), check_invariants=True).coalesce().to_sparse_csr()
    nbytes = tn * tL * 8 + tn * K * 4 * 2
    bms, by = bound_ms(nbytes, 2.0 * tn * tL * K)
    records.append(dict(
        name="spmv_ell_batched", route="cuda",
        source="src/repro_torch/kernels/csrc/spmv_ell_batched.cu",
        replaces="src/repro/kernels/vcycle_fused.py:123",
        launches=counts["spmv_ell_batched"], max_abs_err=err1,
        ms=time_ms(torch, lambda: vf.spmv_ell_batched(idx, val, x)),
        plain_ms=time_ms(torch,
                         lambda: ref.spmv_ell_batched_ref(idx, val, x)),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lambda: torch.sparse.mm(A, x))))

    # K2: one recurrence step with its matvec, on level 0
    kw = dict(first=False, theta=1.37, c1=0.61, c2=0.93)
    pk, zk = vf.cheby_step(lev.idx, lev.val, inv_d, r, z, p0.clone(),
                           torch.empty_like(r), **kw)
    pr, zr = ref.cheby_step_ref(lev.idx, lev.val, inv_d, r, z, p0.clone(),
                                **kw)
    err2 = max(float((pk - pr).abs().max()), float((zk - zr).abs().max()))
    check_close(torch, "K2 main-path p", pk, pr, float(r.abs().max()))
    check_close(torch, "K2 main-path z", zk, zr, float(r.abs().max()))
    p_buf, z_out = p0.clone(), torch.empty_like(r)
    # slabs and inv_d once; r, z_prev and p read, p and z written
    nbytes = n * L * 8 + n * 4 + n * K * 4 * 5
    bms, by = bound_ms(nbytes, n * K * (2.0 * L + 6))
    records.append(dict(
        name="cheby_step", route="cuda",
        source="src/repro_torch/kernels/csrc/cheby_step.cu",
        replaces="src/repro/kernels/vcycle_fused.py:160",
        launches=counts["cheby_step"], max_abs_err=err2,
        ms=time_ms(torch, lambda: vf.cheby_step(
            lev.idx, lev.val, inv_d, r, z, p_buf, z_out, **kw)),
        plain_ms=time_ms(torch, lambda: ref.cheby_step_ref(
            lev.idx, lev.val, inv_d, r, z, p_buf, **kw)),
        bound_ms=bms, bound_by=by, library_ms=None))

    # K3: restrict + residual on level 0
    args3 = (lev.idx, lev.val, lev.perm, lev.agg_ptr, lev.agg_max, r, z)
    rk = vf.restrict_residual(*args3)
    rr = ref.restrict_residual_ref(*args3)
    err3 = check_close(torch, "K3 main-path", rk, rr,
                       float(r.abs().max()))
    nbytes = n * L * 8 + n * 4 + (nc + 1) * 4 + n * K * 4 * 2 + nc * K * 4
    bms, by = bound_ms(nbytes, n * K * (2.0 * L + 2))
    records.append(dict(
        name="restrict_residual", route="cuda",
        source="src/repro_torch/kernels/csrc/restrict_residual.cu",
        replaces="src/repro/kernels/vcycle_fused.py:195",
        launches=counts["restrict_residual"], max_abs_err=err3,
        ms=time_ms(torch, lambda: vf.restrict_residual(*args3)),
        plain_ms=time_ms(torch, lambda: ref.restrict_residual_ref(*args3)),
        bound_ms=bms, bound_by=by, library_ms=None))
    print(f"shapes: top level n={tn} L={tL} k={K}; level 0 n={n} L={L} "
          f"n_coarse={nc} agg_max={lev.agg_max}", flush=True)

    return records


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this script needs "
              "a CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.core.graph import mesh2d
        from repro_torch.kernels import _build, ref
        from repro_torch.kernels import vcycle_fused as vf
        from repro_torch.obs import get_tracer
        from repro_torch.solver import (build_hierarchy, ell_laplacian,
                                        make_solver)
    except ImportError as exc:
        print(f"FAIL: the repro_torch package is not beside this script "
              f"({exc})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(f"nvidia-smi: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- phase 1: build -----------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_info.get('seconds', 0.0):.2f} s, "
          f"cached={_build.build_info.get('cached')})", flush=True)
    for line in _build.build_info.get("log", "").splitlines():
        if "registers" in line or line.startswith("=="):
            print(f"  {line.strip()}")

    # ---- phase 2: kernels against their plain versions at edge sizes ------
    n_checked = edge_checks(torch, vf, ref)
    print(f"edge sizes: {n_checked} (n, k) cases, K1 bitwise, K2/K3 "
          f"allclose", flush=True)

    # ---- phase 3: the main path -----------------------------------------
    t0 = time.perf_counter()
    g = mesh2d(MAIN_ROWS, MAIN_ROWS, seed=0)
    print(f"graph: mesh2d({MAIN_ROWS}, {MAIN_ROWS}) n={g.n} m={g.m} "
          f"({time.perf_counter() - t0:.2f} s on the host)", flush=True)
    b = np.random.default_rng(1).standard_normal((g.n, K)).astype(np.float32)
    # the main path, untraced: launch counts are read over exactly this run
    vf.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hier = build_hierarchy(g, alpha=0.05, chunk=512, contraction="device",
                           device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    idx, val = ell_laplacian(g, device="cuda")
    b_dev = torch.as_tensor(b, device="cuda")
    t0 = time.perf_counter()
    solver = make_solver(idx, val, hier, matvec_impl="fused", device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solver(b_dev, tol=TOL, maxiter=MAXITER)
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(vf.launches)

    # a second, traced build gives the per-stage seconds
    tracer = get_tracer()
    tracer.enable()
    tracer.clear()
    t0 = time.perf_counter()
    build_hierarchy(g, alpha=0.05, chunk=512, contraction="device",
                    device="cuda")
    torch.cuda.synchronize()
    traced_build_s = time.perf_counter() - t0
    tracer.disable()
    stage_s = {}
    for ev in tracer.events():
        stage_s[ev["name"]] = stage_s.get(ev["name"], 0.0) + ev["dur_ns"] / 1e9
    iters = res.iters.tolist()
    relres = res.relres.tolist()
    print(f"hierarchy: depth {hier.depth}, level sizes {hier.level_sizes}, "
          f"build {build_s:.3f} s (traced build {traced_build_s:.3f} s)",
          flush=True)
    print("traced build stages (s, host spans): " + json.dumps(
        {k: round(v, 4) for k, v in sorted(stage_s.items())}), flush=True)
    print(f"solver setup {setup_s:.3f} s, rho per level "
          f"{[round(x, 6) for x in solver.msolve.rhos]}", flush=True)
    print(f"fused solve: {solve_ms:.2f} ms, iters {iters}, true relres "
          f"{[f'{x:.3e}' for x in relres]}", flush=True)
    print(f"main-path launches: {json.dumps(counts)}", flush=True)
    if not all(res.converged.tolist()):
        fail(f"not every column converged: relres {relres}")
    if not torch.isfinite(res.x).all() or tuple(res.x.shape) != (g.n, K):
        fail("solution is not finite or has the wrong shape")
    for name, c in counts.items():
        if c <= 0:
            fail(f"kernel {name} was not launched on the main path")

    # ---- phase 4: plain path on the same hierarchy; repeat run ------------
    solver_ref = make_solver(idx, val, hier, matvec_impl="ref",
                             device="cuda")
    if solver_ref.msolve.rhos != solver.msolve.rhos:
        fail("the plain path baked in other spectral radius estimates")
    t0 = time.perf_counter()
    res_ref = solver_ref(b_dev, tol=TOL, maxiter=MAXITER)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    it_ref = res_ref.iters.tolist()
    print(f"plain solve: {ref_ms:.2f} ms, iters {it_ref}", flush=True)
    if any(abs(a - c) > 1 for a, c in zip(iters, it_ref)):
        fail(f"fused iterations {iters} vs plain {it_ref} differ by > 1")
    xf = (res.x - res.x[:1]).double()
    xr = (res_ref.x - res_ref.x[:1]).double()
    rel = float((xf - xr).abs().max() / xr.abs().max())
    print(f"fused vs plain re-based x: max rel err {rel:.3e}", flush=True)
    if rel > 1e-3:
        fail(f"fused and plain solutions differ: {rel:.3e}")
    res2 = solver(b_dev, tol=TOL, maxiter=MAXITER)
    if not (torch.equal(res2.x, res.x) and torch.equal(res2.iters,
                                                       res.iters)):
        fail("a second fused solve is not bitwise equal to the first")
    print("second fused solve: bitwise equal x and iters", flush=True)

    # ---- phase 5: kernels at the main path's shapes ----------------------
    records = kernel_records(torch, vf, ref, hier, idx, val, counts)

    print(f"nvidia-smi: {card}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
