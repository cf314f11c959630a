"""The CUDA kernels K1-K6, K6b (K6's gradient) and K7 (the refinement's
float64 residual) against their plain versions, and the port's service,
sharded planes, the production dry run, LM serving paths (every family),
training and the LM dry run's card cells, on the card.

Every ``gpu``-marked test needs a CUDA device and skips without one
(decided in a fixture).  The file imports no JAX, so it runs on a machine
with only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Two tests here run on the CPU as well: the port and ``chip_smoke.py``
import neither ``jax`` nor the JAX package ``repro``, and
``chip_smoke.py`` takes its kernel bounds from
``repro_torch.launch.roofline`` and computes none inline.
"""
import ast
import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import recovery  # noqa: E402
from repro_torch.core.distributed import recover_mixed  # noqa: E402
from repro_torch.core.graph import (barabasi_albert, col_mean,  # noqa: E402
                                    col_norm, grid2d, mesh2d, star_hub)
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import similarity as ksim  # noqa: E402
from repro_torch.kernels.ssm_scan import run_length  # noqa: E402
from repro_torch.kernels import vcycle_fused as tvf  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.pipeline import Pipeline, pdgrass_config  # noqa: E402
from repro_torch.solver import (SolveRequest, SolverService,  # noqa: E402
                                build_hierarchy, ell_laplacian, make_solver)
from repro_torch.solver.device_pcg import (  # noqa: E402
    make_chebyshev_smoother, make_matvec)
from repro_torch.solver.hierarchy import aggregate_csr  # noqa: E402
from repro_torch.solver.sharded import shard_ell_slabs  # noqa: E402

from repro_torch.analysis import cuda_check, dispatch_audit  # noqa: E402
from repro_torch.analysis.findings import SEV_ERROR  # noqa: E402
from repro_torch.analysis.registry import HOT_ENTRIES  # noqa: E402

from _k4_layouts import K4_LAYOUTS, k4_layout  # noqa: E402

V_CYCLE_KERNELS = ("spmv_ell_batched", "cheby_step", "restrict_residual")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [31, 100, 257])
@pytest.mark.parametrize("k", [1, 3, 8, 16])
def test_gpu_kernels_match_plain(cuda, n, k):
    """K1, K2's step and K3 bitwise on the card, and each wrapper counts
    its launch."""
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    L, nx = 5, n + 7
    idx = torch.randint(0, nx, (n, L), generator=gen, device=cuda,
                        dtype=torch.int32)
    val = torch.randn((n, L), generator=gen, device=cuda)
    x = torch.randn((nx, k), generator=gen, device=cuda)
    before = kops.launch_counts()
    assert torch.equal(tvf.spmv_ell_batched(idx, val, x),
                       kref.spmv_ell_batched_ref(idx, val, x))
    idx = idx % n
    inv_d = torch.rand((n,), generator=gen, device=cuda) + 0.5
    r, z, p = (torch.randn((n, k), generator=gen, device=cuda)
               for _ in range(3))
    kw = dict(first=False, theta=1.3, c1=0.7, c2=0.4)
    pk, zk = tvf.cheby_step(idx, val, inv_d, r, z, p.clone(),
                            torch.empty_like(r), **kw)
    pr, zr = kref.cheby_step_ref(idx, val, inv_d, r, z, p.clone(), **kw)
    assert torch.equal(pk, pr) and torch.equal(zk, zr)
    agg = torch.arange(n, device=cuda, dtype=torch.int32) % max(1, n // 3)
    perm, ptr, amax = aggregate_csr(agg, max(1, n // 3))
    assert torch.equal(
        tvf.restrict_residual(idx, val, perm, ptr, amax, r, z),
        kref.restrict_residual_ref(idx, val, perm, ptr, amax, r, z))
    after = kops.launch_counts()
    assert all(after[name] == before[name] + 1 for name in V_CYCLE_KERNELS)


K2_SWEEPS = ("cheby_smooth_zero", "cheby_prolong_step")


def _k2_problem(gen, device, n, k, L=5):
    idx = torch.randint(0, n, (n, L), generator=gen, device=device,
                        dtype=torch.int32)
    val = torch.randn((n, L), generator=gen, device=device)
    inv_d = torch.rand((n,), generator=gen, device=device) + 0.5
    r, z = (torch.randn((n, k), generator=gen, device=device)
            for _ in range(2))
    return idx, val, inv_d, r, z


def _k2_aggregates(gen, device, n, k, nc):
    """``(zc, agg)`` with ``nc`` aggregates: one of every row, or ragged
    ones with every coarse vertex used."""
    agg = torch.randint(0, nc, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    agg[:nc] = torch.arange(nc, device=device, dtype=torch.int32)
    return torch.randn((nc, k), generator=gen, device=device), agg


def _k2_sweeps_bitwise(args, z, zc, agg, kw):
    """Each of K2's sweep launches against its plain version, the zero
    start with and without p written, the prolongation step with and
    without the prolongation: how many launches of each it made."""
    made = dict.fromkeys(K2_SWEEPS, 0)
    for want_p in (False, True):
        p, zk = tvf.cheby_smooth_zero(*args, want_p=want_p, **kw)
        pr, zr = kref.cheby_smooth_zero_ref(*args, **kw)
        assert torch.equal(zk, zr)
        assert torch.equal(p, pr) if want_p else p is None
        made["cheby_smooth_zero"] += 1
    for zc_agg in ((None, None), (zc, agg)):
        p, z1 = tvf.cheby_prolong_step(*args, z, *zc_agg, theta=kw["theta"])
        pr, zr = kref.cheby_prolong_step_ref(*args, z, *zc_agg,
                                             theta=kw["theta"])
        assert torch.equal(p, pr) and torch.equal(z1, zr)
        made["cheby_prolong_step"] += 1
    return made


@pytest.mark.gpu
@pytest.mark.parametrize("n", [31, 100, 257])
@pytest.mark.parametrize("k", [1, 3, 8, 16])
def test_gpu_k2_sweeps_match_plain(cuda, n, k):
    """K2's sweep launches bitwise against their plain versions on one
    aggregate and on ragged aggregates, each counted once a launch; and
    the factory at degrees 2 and 3 bitwise against the plain smoother
    (``make_chebyshev_smoother`` over the plain matvec, from zero and from
    ``z + zc[agg]``)."""
    gen = torch.Generator(device=cuda).manual_seed(10 * n + k)
    idx, val, inv_d, r, z = _k2_problem(gen, cuda, n, k)
    args = (idx, val, inv_d, r)
    diag = 1.0 / inv_d
    for nc in (1, max(2, n // 3)):
        zc, agg = _k2_aggregates(gen, cuda, n, k, nc)
        before = kops.launch_counts()
        made = _k2_sweeps_bitwise(args, z, zc, agg,
                                  dict(theta=1.37, c1=0.61, c2=0.93))
        after = kops.launch_counts()
        assert all(after[name] - before[name] == made[name]
                   for name in K2_SWEEPS)
        for degree in (2, 3):
            plain = make_chebyshev_smoother(make_matvec(idx, val, "ref"),
                                            diag, 1.9, degree=degree)
            want_zero = plain(r)
            want_warm = plain(r, z + zc[agg.long()])
            smooth = tvf.make_fused_chebyshev(idx, val, diag, 1.9,
                                              degree=degree, agg=agg)
            assert torch.equal(smooth(r), want_zero)
            assert torch.equal(smooth(r, z, zc), want_warm)


def _k3_case(case, device):
    """A level-like K3 problem: ``(idx, val, agg, n_coarse)``."""
    n, L = {"hub": (200, 7), "L3": (150, 3), "L12": (150, 12),
            "L17": (150, 17), "one_aggregate": (100, 7)}[case]
    rng = np.random.default_rng(len(case) * 100 + n + L)
    idx = rng.integers(0, n, size=(n, L)).astype(np.int32)
    val = rng.standard_normal((n, L)).astype(np.float32)
    if case == "hub":          # rows 0..63 in aggregate 0, the rest pairs
        agg = np.concatenate([np.zeros(64, np.int64),
                              1 + np.arange(n - 64) // 2])
    elif case == "one_aggregate":
        agg = np.zeros(n, np.int64)
    else:
        agg = rng.permutation(np.arange(n) // 3)
    nc = int(agg.max()) + 1
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(val, device=device),
            torch.as_tensor(agg.astype(np.int32), device=device), nc)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["hub", "L3", "L12", "L17",
                                  "one_aggregate"])
@pytest.mark.parametrize("k", [3, 8, 16])
def test_gpu_k3_bitwise_edge_cases(cuda, case, k):
    """K3 bitwise against its plain version on a hub aggregate (64
    members), slab widths other than 7 (17: past the template instances),
    and one aggregate of every row; k = 3 takes the per-column kernel, 8
    and 16 the 4-column one, with and without the aggregate-order copy
    and through the V-cycle's factory."""
    idx, val, agg, nc = _k3_case(case, cuda)
    perm, ptr, amax = aggregate_csr(agg, nc)
    if case == "hub":
        assert amax == 64
    gen = torch.Generator(device=cuda).manual_seed(k)
    r, z = (torch.randn((idx.shape[0], k), generator=gen, device=cuda)
            for _ in range(2))
    want = kref.restrict_residual_ref(idx, val, perm, ptr, amax, r, z)
    copy = tvf.aggregate_slabs(idx, val, perm)
    before = kops.launch_counts()["restrict_residual"]
    for got in (tvf.restrict_residual(idx, val, perm, ptr, amax, r, z),
                tvf.restrict_residual(idx, val, perm, ptr, amax, r, z,
                                      agg_slabs=copy),
                tvf.make_fused_restrict_residual(idx, val, perm, ptr,
                                                 amax)(r, z)):
        assert got.shape == (nc, k)
        assert torch.equal(got, want)
    assert kops.launch_counts()["restrict_residual"] == before + 3


@pytest.mark.gpu
def test_gpu_wrapper_rejects_bad_operands(cuda):
    idx = torch.zeros((4, 2), dtype=torch.int64, device=cuda)
    val = torch.zeros((4, 2), device=cuda)
    x = torch.zeros((4, 1), device=cuda)
    with pytest.raises(TypeError):
        tvf.spmv_ell_batched(idx, val, x)
    with pytest.raises(ValueError):
        tvf.spmv_ell_batched(idx.int(), val, x.cpu())


@pytest.mark.gpu
def test_gpu_slice_matches_cpu_and_plain(cuda):
    """The whole slice on the card: the hierarchy built there equals the
    CPU build (agg and sizes), the default solve runs the kernels, and it
    matches the plain route in iterations and, bitwise, in x."""
    g = mesh2d(24, 24, seed=3)
    hier = build_hierarchy(g, alpha=0.05, device=cuda)
    host = build_hierarchy(g, alpha=0.05, device="cpu")
    assert hier.level_sizes == host.level_sizes
    for a, b in zip(hier.levels, host.levels):
        assert torch.equal(a.agg.cpu(), b.agg)
    idx, val = ell_laplacian(g, device=cuda)
    b = np.random.default_rng(0).standard_normal((g.n, 4)).astype(np.float32)
    before = kops.launch_counts()
    fused = make_solver(idx, val, hier, device=cuda)(b)
    after = kops.launch_counts()
    # a V-cycle launches at every level one zero-start sweep, one
    # prolongation step and one later step (degree 2)
    assert after["spmv_ell_batched"] > before["spmv_ell_batched"]
    made = {k: after[k] - before[k] for k in (
        "cheby_smooth_zero", "cheby_prolong_step", "cheby_step",
        "restrict_residual")}
    assert made["restrict_residual"] > 0
    assert len(set(made.values())) == 1, made
    plain = make_solver(idx, val, hier, matvec_impl="ref", device=cuda)(b)
    assert bool(fused.converged.all())
    assert torch.equal(fused.iters, plain.iters)
    assert torch.equal(fused.x, plain.x)


def _sim_problem(rng, K, m, c1, device, n_seg=5):
    sig = lambda r: rng.integers(0, 30, size=(r, c1)).astype(np.int32)
    csu, csv = sig(K), sig(K)
    esu, esv = sig(m), sig(m)
    cbeta = rng.integers(-1, c1, size=K).astype(np.int32)
    cseg = rng.integers(0, n_seg, size=K).astype(np.int32)
    eseg = rng.integers(0, n_seg, size=m).astype(np.int32)
    eseg[rng.random(m) < 0.1] = -1
    return [torch.as_tensor(a, device=device)
            for a in (csu, csv, cbeta, cseg, esu, esv, eseg)]


@pytest.mark.gpu
@pytest.mark.parametrize("K,m,c1", [(8, 64, 9), (16, 512, 9), (128, 1024, 9),
                                    (4, 100, 5), (32, 96, 13), (1, 32, 3),
                                    (33, 200, 9), (300, 5000, 16)])
def test_gpu_k4_bitwise_equal_to_plain(cuda, K, m, c1):
    args = _sim_problem(np.random.default_rng(K * m), K, m, c1, cuda)
    before = kops.launch_counts()["similarity_mark"]
    got = kops.similarity_mark(*args)
    assert got.device.type == "cuda" and got.dtype == torch.bool
    assert torch.equal(got, kref.similarity_mark_ref(*args))
    assert kops.launch_counts()["similarity_mark"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("layout", K4_LAYOUTS)
def test_gpu_k4_bitwise_on_kernel_layouts(cuda, layout):
    """K4 on the layouts that reach each part of the kernel, bitwise equal
    to its plain version, one launch each; and again with the rows as
    views one row into larger tensors (not 16-byte aligned: the scalar
    loads and stores)."""
    args = [torch.as_tensor(a, device=cuda) for a in k4_layout(layout)]
    before = kops.launch_counts()["similarity_mark"]
    got = kops.similarity_mark(*args)
    assert torch.equal(got, kref.similarity_mark_ref(*args))
    assert kops.launch_counts()["similarity_mark"] == before + 1
    rows = [torch.cat([t[:1], t])[1:] for t in args[4:]]
    assert rows[2].data_ptr() % 16 != 0
    assert torch.equal(kops.similarity_mark(*args[:4], *rows), got)


@pytest.mark.gpu
@pytest.mark.parametrize("capacity", [37, None])
def test_gpu_k4_row_list_full_and_reused(cuda, monkeypatch, capacity):
    """The layouts with thousands of (row, candidate) pairs in one block
    send their rows to K4's second kernel through a list in device
    memory.  With room for only 37 rows, the warps that find it full walk
    their rows in the first kernel.  Each layout runs three times in a
    row, bitwise equal to the plain version every time: each launch leaves
    the next one an empty list."""
    if capacity is not None:
        monkeypatch.setattr(ksim, "ROW_CAPACITY", capacity)
    for layout in ("128_in_one_subtask", "warp_in_32_subtasks", "m1"):
        args = [torch.as_tensor(a, device=cuda) for a in k4_layout(layout)]
        want = kref.similarity_mark_ref(*args)
        for _ in range(3):
            assert torch.equal(kops.similarity_mark(*args), want), layout


@pytest.mark.gpu
def test_gpu_recover_rounds_default_route_is_k4(cuda):
    """On a CUDA problem the default route marks through K4, one launch a
    round, and equals the chunked route (``use_kernel=False``) bitwise."""
    prob = Pipeline(pdgrass_config(alpha=0.05, chunk=256)).prepare(
        mesh2d(32, 32, seed=1), device=cuda).problem
    kw = dict(target=52, stop_at_target=True, chunk=256)
    before = kops.launch_counts()["similarity_mark"]
    st, stats = recovery.recover_rounds(prob, **kw)
    assert kops.launch_counts()["similarity_mark"] == before + stats.rounds
    st_c, stats_c = recovery.recover_rounds(prob, use_kernel=False, **kw)
    assert kops.launch_counts()["similarity_mark"] == before + stats.rounds
    assert torch.equal(st, st_c) and stats == stats_c


@pytest.mark.gpu
def test_gpu_build_hierarchy_routes_agree(cuda, monkeypatch):
    """``build_hierarchy`` on the card marks through K4 at every level, and
    the chunked route forced on gives the same hierarchy: agg and level
    sizes."""
    g = mesh2d(64, 64, seed=0)
    rounds = []
    engine = recovery.recover_rounds

    def counted(*args, **kw):
        out = engine(*args, **kw)
        rounds.append(out[1].rounds)
        return out

    monkeypatch.setattr(recovery, "recover_rounds", counted)
    before = kops.launch_counts()["similarity_mark"]
    k4 = build_hierarchy(g, alpha=0.05, device=cuda)
    assert kops.launch_counts()["similarity_mark"] - before == sum(rounds) > 0
    monkeypatch.setattr(recovery, "recover_rounds",
                        functools.partial(engine, use_kernel=False))
    chunked = build_hierarchy(g, alpha=0.05, device=cuda)
    assert kops.launch_counts()["similarity_mark"] - before == sum(rounds)
    assert k4.level_sizes == chunked.level_sizes
    for a, b in zip(k4.levels, chunked.levels):
        assert torch.equal(a.agg, b.agg)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [31, 100, 257])
def test_gpu_k5_bitwise_equal_to_plain_and_k1(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    idx = torch.randint(0, n + 3, (n, 6), generator=gen, device=cuda,
                        dtype=torch.int32)
    val = torch.randn((n, 6), generator=gen, device=cuda)
    x = torch.randn((n + 3,), generator=gen, device=cuda)
    before = kops.launch_counts()["spmv_ell"]
    y = kops.spmv(idx, val, x)
    assert torch.equal(y, kref.spmv_ell_ref(idx, val, x))
    assert torch.equal(y, kops.spmv_batched(idx, val,
                                            x[:, None].contiguous())[:, 0])
    assert kops.launch_counts()["spmv_ell"] == before + 1
    with pytest.raises(ValueError):
        kops.spmv(idx, val, x[:n - 1])


@pytest.mark.gpu
def test_gpu_service_matches_cpu_service(cuda):
    """The service on the card against the service on the CPU, same graph
    and requests: the same aggregation, iterations within +-1 and x within
    the parity tolerance (re-based, rtol 1e-3); on the card the K5 route
    equals the fused route bitwise and launches K5.

    The two devices reduce in other orders (the power iteration's norms,
    the coarse Cholesky factor and solve), so the solves are not bitwise
    equal; column 0 of this graph sits on a near-tie at tol 1e-5, where
    one ULP of one level's spectral radius estimate moves it between 52
    and 53 iterations (ROADMAP queue 3)."""
    g = mesh2d(24, 24, seed=3)
    b = np.random.default_rng(0).standard_normal((g.n, 3)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        svc = SolverService(alpha=0.05, device=dev)
        h = svc.register(g)
        tickets = [svc.submit(SolveRequest(graph=h, b=b[:, :1])),
                   svc.submit(SolveRequest(graph=h, b=b[:, 1:]))]
        svc.flush()
        _, (_, _, hier), _ = svc.artifacts(h)
        out[str(dev)] = ([t.result() for t in tickets], hier, svc)
    (cpu_rs, cpu_h, _), (gpu_rs, gpu_h, gpu_svc) = out["cpu"], out["cuda"]
    assert cpu_h.level_sizes == gpu_h.level_sizes
    for a, c in zip(gpu_h.levels, cpu_h.levels):
        assert a.agg.device.type == "cuda"
        assert torch.equal(a.agg.cpu(), c.agg)
    for rg, rc in zip(gpu_rs, cpu_rs):
        assert np.all(np.abs(rg.iters.astype(int) - rc.iters) <= 1)
        xg, xc = rg.x - rg.x[0], rc.x - rc.x[0]
        np.testing.assert_allclose(xg, xc, rtol=1e-3,
                                   atol=1e-3 * np.abs(xc).max())
        assert rg.converged
    kern = SolverService(alpha=0.05, device=cuda, matvec_impl="kernel",
                         store=gpu_svc.store)
    kern.warmup(g)
    before = kops.launch_counts()["spmv_ell"]
    rk = kern.solve(g, b[:, 1:])
    assert kops.launch_counts()["spmv_ell"] > before
    rf = gpu_svc.solve(g, b[:, 1:])
    np.testing.assert_array_equal(rk.x, rf.x)
    np.testing.assert_array_equal(rk.iters, rf.iters)



def _same_hierarchy(a, b) -> bool:
    """Level sizes, and every level's agg, ELL slabs and diagonal, bitwise."""
    return a.level_sizes == b.level_sizes and all(
        torch.equal(x, y) for la, lb in zip(a.levels, b.levels)
        for x, y in ((la.agg, lb.agg), (la.idx, lb.idx), (la.val, lb.val),
                     (la.diag, lb.diag)))


@pytest.mark.gpu
def test_gpu_concurrent_builds_equal_serial_builds(cuda, monkeypatch):
    """Two threads build different graphs on one CUDA service at once, one
    through a daemon's ``miss`` and one through a synchronous flush: each
    hierarchy is bitwise equal to its serial build, and K4 launched once a
    round of the two builds (its row list is shared by the launches of one
    stream, numbered and enqueued under one lock)."""
    from repro_torch.serve import SolverDaemon

    graphs = [mesh2d(64, 64, seed=0), mesh2d(48, 48, seed=1)]
    svc = SolverService(alpha=0.05, device=cuda)
    serial = [build_hierarchy(g, config=svc.pipeline, coarse_n=svc.coarse_n,
                              contraction=svc.contraction, device=cuda)
              for g in graphs]
    rounds = []
    engine = recovery.recover_rounds

    def counted(*args, **kw):
        out = engine(*args, **kw)
        rounds.append(out[1].rounds)
        return out

    monkeypatch.setattr(recovery, "recover_rounds", counted)
    handles = [svc.register(g) for g in graphs]
    b = [np.random.default_rng(i).standard_normal(g.n).astype(np.float32)
         for i, g in enumerate(graphs)]
    before = kops.launch_counts()["similarity_mark"]
    with SolverDaemon(svc, max_batch_delay_ms=1.0) as d:
        t0 = d.submit(SolveRequest(graph=handles[0], b=b[0], tol=1e-4))
        t1 = svc.submit(SolveRequest(graph=handles[1], b=b[1], tol=1e-4))
        svc.flush()
        r0 = t0.result(timeout=300.0)
    r1 = t1.result()
    assert r0.cache == r1.cache == "miss"
    assert r0.converged and r1.converged
    assert kops.launch_counts()["similarity_mark"] - before == sum(rounds) > 0
    for h, want in zip(handles, serial):
        _, (_, _, hier), source = svc.artifacts(h)
        assert source == "mem"
        assert _same_hierarchy(hier, want)


@pytest.mark.gpu
def test_gpu_batched_columns_match_single_solves(cuda):
    """On the card too, each column of a batched solve equals its solo
    solve bitwise, x and iterations: the kernels treat every column alike,
    and the coarse solve takes one batched route at every width."""
    g = mesh2d(64, 64, seed=2)
    hier = build_hierarchy(g, alpha=0.05, device=cuda)
    solve = make_solver(*ell_laplacian(g, device=cuda), hier, device=cuda)
    b = np.random.default_rng(3).standard_normal((g.n, 5)).astype(np.float32)
    b -= b.mean(axis=0)
    res = solve(b, tol=1e-5, maxiter=2000)
    for j in range(b.shape[1]):
        one = solve(b[:, j:j + 1], tol=1e-5, maxiter=2000)
        assert torch.equal(res.x[:, j], one.x[:, 0])
        assert int(res.iters[j]) == int(one.iters[0])


def _k7_graph(name):
    """A mesh, a 5-point grid and a graph of uneven degrees (hubs of
    degree in the hundreds beside leaves of degree 3), each over several
    of K7's 256-row blocks."""
    return {"mesh2d": lambda: mesh2d(48, 48, seed=1),
            "grid2d": lambda: grid2d(70, 70, seed=2),
            "uneven": lambda: barabasi_albert(5000, 3, seed=3)}[name]()


def _csr_order_laplacian(g, x):
    """``L x`` on the host in float64 with each row's weighted degree and
    neighbour sum taken in CSR order, one rounded product and add a term,
    as K7 sums (numpy's ``add.reduceat`` in ``Graph.laplacian_matvec``
    groups a row's terms in its own order)."""
    x = np.asarray(x, dtype=np.float64)
    xs = x.reshape(g.n, -1)
    deg = np.diff(g.indptr)
    w = g.adj_w.astype(np.float64)
    wdeg, nbr = np.zeros(g.n), np.zeros(xs.shape)
    for t in range(int(deg.max())):
        rows = np.nonzero(deg > t)[0]
        j = g.indptr[rows] + t
        wdeg[rows] = wdeg[rows] + w[j]
        nbr[rows] = nbr[rows] + w[j][:, None] * xs[g.adj[j]]
    return (wdeg[:, None] * xs - nbr).reshape(x.shape)


def _k7_launches():
    c = kops.launch_counts()
    return c["laplacian_residual"], c["laplacian_residual_fold"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mesh2d", "grid2d", "uneven"])
@pytest.mark.parametrize("k", [1, 3, 8, 32, 40])
def test_gpu_k7_matches_host_residual(cuda, name, k):
    """K7 against the host's float64 residual (``Graph.laplacian_matvec``,
    the service's CPU path): r within 1e-12 of each entry's |b| + |w x|
    sum, and bitwise equal to the host's sums in CSR order; the norms
    within rtol 1e-13, the means within 1e-12 of the columns' mean of
    that sum; every column bitwise equal to its own 1-wide call; one
    launch and one fold a call."""
    g = _k7_graph(name)
    rng = np.random.default_rng(k)
    b = rng.standard_normal((g.n, k)).astype(np.float32)
    x = rng.standard_normal((g.n, k))
    csr = kops.upload_csr(g, device=cuda)
    b_d, x_d = torch.as_tensor(b, device=cuda), torch.as_tensor(x, device=cuda)
    before = _k7_launches()
    r, mean, norm, b_norm = kops.laplacian_residual(*csr, b_d, x_d,
                                                    with_b_norm=True)
    torch.cuda.synchronize()
    assert _k7_launches() == (before[0] + 1, before[1] + 1)
    b64 = b.astype(np.float64)
    want = b64 - g.laplacian_matvec(x)
    w = g.adj_w.astype(np.float64)
    scale = (np.abs(b64) + np.add.reduceat(w, g.indptr[:-1])[:, None]
             * np.abs(x) + np.add.reduceat(w[:, None] * np.abs(x)[g.adj],
                                           g.indptr[:-1], axis=0))
    assert np.all(np.abs(r.cpu().numpy() - want) <= 1e-12 * scale)
    assert np.array_equal(r.cpu().numpy(), b64 - _csr_order_laplacian(g, x))
    np.testing.assert_allclose(norm.cpu().numpy(), col_norm(want),
                               rtol=1e-13)
    np.testing.assert_allclose(b_norm.cpu().numpy(), col_norm(b64),
                               rtol=1e-13)
    assert np.all(np.abs(mean.cpu().numpy() - col_mean(want))
                  <= 1e-12 * scale.mean(axis=0))
    for j in range(k):
        one = kops.laplacian_residual(*csr, b_d[:, j:j + 1].contiguous(),
                                      x_d[:, j:j + 1].contiguous(),
                                      with_b_norm=True)
        assert torch.equal(one[0][:, 0], r[:, j])
        for got, wide in zip(one[1:], (mean, norm, b_norm)):
            assert torch.equal(got[0], wide[j])
    # the later passes leave b's norms out
    assert kops.laplacian_residual(*csr, b_d, x_d)[3] is None


@pytest.mark.gpu
@pytest.mark.parametrize("tol,max_refine", [(1e-4, 3), (3e-6, 1)])
def test_gpu_request_batched_with_others_solves_as_it_does_alone(
        cuda, tol, max_refine):
    """On the card, as on the CPU: a request's x, iterations and relres do
    not depend on the width of the batch it rides in, K7 measuring each
    pass's residual (one launch and one fold a pass, every residual span
    on the card) and the reported relres that of a host float64
    recomputation (its sums in CSR order, as K7's) within 1e-10.  The refinement stops for the whole group
    once no column halves its residual, so a batch may take more passes
    than a column alone: the case that refines takes one pass."""
    from repro_torch.obs import get_tracer

    g = mesh2d(16, 16, seed=4)
    svc = SolverService(device=cuda, alpha=0.05, max_refine=max_refine)
    rng = np.random.default_rng(8)
    bs = [rng.standard_normal(g.n).astype(np.float32) + 3.0
          for _ in range(6)]
    tracer = get_tracer()
    was = tracer.enabled
    tracer.clear()
    tracer.enable()
    try:
        before = _k7_launches()
        tickets = [svc.submit(SolveRequest(graph=g, b=b, tol=tol))
                   for b in bs]
        svc.flush()
        passes = 1 + tickets[0].result().refinements
        assert _k7_launches() == (before[0] + passes, before[1] + passes)
        for t, b in zip(tickets, bs):
            alone = svc.solve(g, b, tol=tol)
            batched = t.result()
            np.testing.assert_array_equal(batched.x, alone.x)
            np.testing.assert_array_equal(batched.iters, alone.iters)
            np.testing.assert_array_equal(batched.relres, alone.relres)
            bc = (b - col_mean(b[:, None])[0]).astype(np.float64)
            r = bc - _csr_order_laplacian(g, batched.x)
            np.testing.assert_allclose(
                batched.relres, np.linalg.norm(r) / np.linalg.norm(bc),
                rtol=1e-10)
            assert batched.converged
        if tol < 5e-6:      # below what the float32 solve is asked for
            assert passes > 1
        resid = [e for e in tracer.events()
                 if e["name"] == "solver.residual" and "dur_ns" in e]
        assert len(resid) >= 7 and {e["args"]["on"] for e in resid} == {
            "cuda"}
    finally:
        tracer.clear()
        tracer.enabled = was


@pytest.mark.gpu
def test_gpu_k4_launches_from_threads(cuda):
    """Eight threads launch K4 on their own problems on one stream: every
    result bitwise equal to the plain version, and the launch count exact."""
    import threading

    problems = [[torch.as_tensor(a, device=cuda) for a in k4_layout(name)]
                for name in K4_LAYOUTS]
    wants = [kref.similarity_mark_ref(*args) for args in problems]
    bad, per = [], 25
    before = kops.launch_counts()["similarity_mark"]

    def worker(tid):
        for i in range(per):
            j = (tid + i) % len(problems)
            if not torch.equal(kops.similarity_mark(*problems[j]), wants[j]):
                bad.append((tid, i))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120.0)
    assert not any(th.is_alive() for th in threads)
    assert not bad, bad
    assert kops.launch_counts()["similarity_mark"] - before == 8 * per


@pytest.mark.gpu
def test_gpu_daemon_resolves_without_flush(cuda):
    from repro_torch.serve import SolverDaemon

    svc = SolverService(alpha=0.05, device=cuda)
    g = mesh2d(24, 24, seed=3)
    h = svc.register(g)
    b = np.random.default_rng(0).standard_normal((g.n, 3)).astype(np.float32)
    with SolverDaemon(svc, max_batch_delay_ms=5.0) as d:
        assert d.device.type == "cuda"
        tickets = [d.submit(SolveRequest(graph=h, b=b[:, j]))
                   for j in range(3)]
        rs = [t.result(timeout=300.0) for t in tickets]
    assert svc.stats()["scheduler"]["flushes"] == 0
    assert all(r.converged and r.relres.max() <= 1e-5 for r in rs)
    assert svc.stats()["solves_by_config"][svc.pipeline.digest()] == 3


@pytest.mark.gpu
def test_gpu_er_sample_bits_equal_cpu(cuda):
    from repro_torch.pipeline import stages

    for seed in (0, 7, 2 ** 31 + 3):
        for n in (1, 4097, 300_001):
            assert torch.equal(stages.random_bits(seed, n, cuda).cpu(),
                               stages.random_bits(seed, n, "cpu"))
            torch.testing.assert_close(stages.gumbel(seed, n, cuda).cpu(),
                                       stages.gumbel(seed, n, "cpu"),
                                       rtol=0, atol=2.0 ** -20)
    g = mesh2d(32, 32, seed=1)
    cfg = pdgrass_config(alpha=0.05, score_mode="er_sample", seed=3)
    masks = [Pipeline(cfg).run(g, device=dev).recovered_mask
             for dev in (cuda, "cpu")]
    np.testing.assert_array_equal(*masks)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("S", [1, 16, 37])
@pytest.mark.parametrize("di", [8, 100, 8192])
@pytest.mark.parametrize("state", [4, 8, 16])
def test_gpu_k6_bitwise_equal_to_plain(cuda, B, S, di, state):
    """K6 against its plain version on the card, float32 and bf16 inputs,
    non-zero h0, di not a multiple of the block; each launch counted."""
    gen = torch.Generator(device=cuda).manual_seed(B * 1000 + S * 10 + di)
    x1 = torch.randn((B, S, di), generator=gen, device=cuda)
    dt = 0.1 * torch.rand((B, S, di), generator=gen, device=cuda)
    Bm = torch.randn((B, S, state), generator=gen, device=cuda)
    Cm = torch.randn((B, S, state), generator=gen, device=cuda)
    A = -torch.rand((di, state), generator=gen, device=cuda) - 0.1
    h0 = torch.randn((B, di, state), generator=gen, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.to(dtype) for t in (x1, dt, Bm, Cm)] + [A, h0]
        before = kops.launch_counts()["ssm_scan"]
        y, hT = kops.ssm_scan(*args)
        assert kops.launch_counts()["ssm_scan"] == before + 1
        y_r, h_r = kref.ssm_scan_ref(*args)
        assert y.device.type == "cuda" and y.dtype == torch.float32
        assert torch.equal(y, y_r) and torch.equal(hT, h_r)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 37])
@pytest.mark.parametrize("rank", [5, 8])
def test_gpu_k6_strided_b_c_views(cuda, dtype, S, rank):
    """B and C as the model slices them, strided views of one x_proj
    output (``models/layers.py`` ``_ssm_inputs``): read in place through
    their row strides, bitwise equal to the plain version on contiguous
    copies.  Rank 8 with di = 96 puts every row on a 16-byte boundary
    (the kernel's asynchronous copies), rank 5 with di = 100 does not."""
    B, state = 3, 16
    di = 96 if rank == 8 else 100
    dtype = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(S)
    x1 = torch.randn((B, S, di), generator=gen, device=cuda).to(dtype)
    dt = (0.1 * torch.rand((B, S, di), generator=gen, device=cuda)).to(dtype)
    xdbc = torch.randn((B, S, rank + 2 * state), generator=gen,
                       device=cuda).to(dtype)
    Bm, Cm = xdbc[..., rank:rank + state], xdbc[..., rank + state:]
    assert not Bm.is_contiguous()
    A = -torch.rand((di, state), generator=gen, device=cuda) - 0.1
    h0 = torch.randn((B, di, state), generator=gen, device=cuda)
    y, hT = kops.ssm_scan(x1, dt, Bm, Cm, A, h0)
    y_r, h_r = kref.ssm_scan_ref(x1, dt, Bm.contiguous(), Cm.contiguous(),
                                 A, h0)
    assert torch.equal(y, y_r) and torch.equal(hT, h_r)


@pytest.mark.gpu
def test_gpu_k6_rejects_what_it_cannot_take(cuda):
    x = torch.zeros((1, 4, 8), device=cuda)
    with pytest.raises(ValueError):   # no instance for state 5
        kops.ssm_scan(x, x, torch.zeros((1, 4, 5), device=cuda),
                      torch.zeros((1, 4, 5), device=cuda),
                      torch.zeros((8, 5), device=cuda),
                      torch.zeros((1, 8, 5), device=cuda))
    with pytest.raises(ValueError):   # Cm of another length
        kops.ssm_scan(x, x, torch.zeros((1, 4, 4), device=cuda),
                      torch.zeros((1, 3, 4), device=cuda),
                      torch.zeros((8, 4), device=cuda),
                      torch.zeros((1, 8, 4), device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_reduced_model_matches_cpu(cuda, dtype):
    """Reduced falcon-mamba, the same weights on the card (K6 in every
    layer's prefill) and on the CPU (the plain scan): prefill logits and
    states, then two decode steps, within the float32 bar (rtol, atol
    1e-5) or the bf16 bar (2e-2); the devices' matmuls sum in other
    orders."""
    import dataclasses

    cfg = dataclasses.replace(reduced(get_config("falcon-mamba-7b")),
                              dtype=dtype)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    host = tmodel.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 32)), dtype=torch.int32)
    out = {}
    for dev in ("cpu", cuda):
        model = tmodel.cast_for_compute(host, cfg, device=dev)
        before = kops.launch_counts()["ssm_scan"]
        logits, caches = tmodel.prefill(model, cfg, toks.to(dev), 32)
        launched = kops.launch_counts()["ssm_scan"] - before
        steps = [logits]
        for t in range(2):
            logits, caches = tmodel.decode_step(
                model, cfg, caches, toks[:, t:t + 1].to(dev), 32 + t)
            steps.append(logits)
        out[str(dev)] = (launched, [s.cpu() for s in steps],
                         [c["h"].cpu() for c in caches])
    assert out["cpu"][0] == 0 and out["cuda"][0] == cfg.n_layers
    for a, b in zip(out["cuda"][1] + out["cuda"][2],
                    out["cpu"][1] + out["cpu"][2]):
        torch.testing.assert_close(a, b, **tol)

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen3-4b", "gemma2-2b"])
def test_gpu_attention_families_match_cpu(cuda, arch, dtype):
    """Reduced hymba (4 layers: a windowed layer), qwen3-4b and gemma2-2b,
    the same weights on the card and on the CPU: prefill logits and every
    cache leaf, then two decode steps, within the float32 bar (1e-5) or
    the bf16 bar (2e-2).  On the card hymba launches K6 once a layer in
    prefill and nothing else; a dense model launches no kernel at all."""
    import dataclasses

    cfg = reduced(get_config(arch))
    if arch == "hymba-1.5b":
        cfg = dataclasses.replace(cfg, n_layers=4)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    host = tmodel.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (3, 34)), dtype=torch.int32)
    out = {}
    for dev in ("cpu", cuda):
        model = tmodel.cast_for_compute(host, cfg, device=dev)
        kops.reset_launches()
        logits, caches = tmodel.prefill(model, cfg, toks[:, :32].to(dev), 40)
        launched = kops.launch_counts()
        steps = [logits]
        for t in range(2):
            logits, caches = tmodel.decode_step(
                model, cfg, caches, toks[:, 32 + t:33 + t].to(dev), 32 + t)
            steps.append(logits)
        out[str(dev)] = (launched, [s.cpu() for s in steps],
                         [{k: v.cpu() for k, v in c.items()} for c in caches])
    assert not any(out["cpu"][0].values())
    want = cfg.n_layers if cfg.family == "hybrid" else 0
    assert out["cuda"][0] == dict.fromkeys(out["cuda"][0], 0) | {
        "ssm_scan": want}
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, **tol)
    for ca, cb in zip(out["cuda"][2], out["cpu"][2]):
        assert set(ca) == set(cb)
        for name in ca:
            if name == "pos":
                assert torch.equal(ca[name], cb[name])
            else:
                torch.testing.assert_close(ca[name], cb[name], **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dtype,impl", [
    ("mixtral-8x22b", "float32", "onehot"),
    ("mixtral-8x22b", "float32", "gather"),
    ("arctic-480b", "float32", "onehot"),
    ("phi-3-vision-4.2b", "float32", "onehot"),
    ("phi-3-vision-4.2b", "bfloat16", "onehot"),
    ("seamless-m4t-medium", "float32", "onehot"),
    ("seamless-m4t-medium", "bfloat16", "onehot")])
def test_gpu_other_families_match_cpu(cuda, arch, dtype, impl):
    """Reduced mixtral (both dispatch forms) and arctic (dense residual),
    phi-3-vision with its 4-patch prefix and seamless with 8 source
    frames, the same weights on the card and on the CPU: prefill logits
    and every cache leaf, then two decode steps, within the float32 bar
    (1e-5) or the bf16 bar (2e-2); no kernel launched.  The MoE models in
    float32 only: bf16 logits tie more often than the devices' products
    keep the same order."""
    import dataclasses

    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype,
                              moe_impl=impl)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    host = tmodel.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 18)),
                           dtype=torch.int32)
    front = src = None
    if cfg.frontend and not cfg.enc_layers:
        front = torch.as_tensor(rng.standard_normal(
            (3, cfg.frontend_len, cfg.frontend_dim)), dtype=torch.float32)
    if cfg.enc_layers:
        src = torch.as_tensor(rng.standard_normal((3, 8, cfg.frontend_dim)),
                              dtype=torch.float32)
    start = 16 + (cfg.frontend_len if front is not None else 0)
    out = {}
    for dev in ("cpu", cuda):
        model = tmodel.cast_for_compute(host, cfg, device=dev)
        kops.reset_launches()
        logits, caches = tmodel.prefill(
            model, cfg, toks[:, :16].to(dev), 32,
            frontend=None if front is None else front.to(dev),
            src=None if src is None else src.to(dev))
        steps = [logits]
        for t in range(2):
            logits, caches = tmodel.decode_step(
                model, cfg, caches, toks[:, 16 + t:17 + t].to(dev), start + t)
            steps.append(logits)
        out[str(dev)] = (kops.launch_counts(), [s.cpu() for s in steps],
                         [{k: v.cpu() for k, v in c.items()} for c in caches])
    assert not any(out["cpu"][0].values())
    assert not any(out["cuda"][0].values())
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, **tol)
    for ca, cb in zip(out["cuda"][2], out["cpu"][2]):
        assert set(ca) == set(cb)
        for name in ca:
            if name == "pos":
                assert torch.equal(ca[name], cb[name])
            else:
                torch.testing.assert_close(ca[name], cb[name], **tol)


@pytest.mark.gpu
def test_gpu_dryrun_matches_cpu(cuda):
    """The production dry run at the small config (mesh2d(45, 45) padded
    to 2^12 rows): two rounds on the production mesh and the run to the
    end on 8 shards, on the card (K4 marks every shard) and on the CPU,
    bitwise; the card's row has its device fields."""
    from repro_torch.launch import dryrun_pdgrass as dry
    from repro_torch.launch import make_mesh_for, make_production_mesh

    cfg, side = dry.SMALL
    g = mesh2d(*side, seed=0)
    out = {}
    for dev in ("cpu", cuda):
        rows = dry.production_rows(cfg, g, device=dev)
        kops.reset_launches()
        row, two = dry.dry_run(rows, make_production_mesh(device=dev), cfg,
                               rounds=2)
        _, end = dry.dry_run(rows, make_mesh_for(8, device=dev), cfg,
                             rounds=None)
        out[str(dev)] = (row, two.cpu(), end.cpu(),
                         kops.launch_counts()["similarity_mark"])
    assert out["cpu"][3] == 0 and out["cuda"][3] > 0
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert torch.equal(out["cuda"][2], out["cpu"][2])
    row = out["cuda"][0]
    assert row["round_ms"] is not None and row["temp_gb"] is not None
    assert row["coll_bytes_per_dev"] == out["cpu"][0]["coll_bytes_per_dev"]


@pytest.mark.gpu
@pytest.mark.parametrize("n_sh", [1, 8])
def test_gpu_sharded_fused_matches_ref(cuda, n_sh):
    """The sharded plane on the card: K1 on every shard's halo-extended x
    against its plain version, +-0 iterations and x bitwise; a lone column
    equals its column in the batch."""
    g = mesh2d(48, 48, seed=4)
    mesh = make_mesh((n_sh,), ("data",), device=cuda)
    hier = build_hierarchy(g, alpha=0.05, contraction="sharded", mesh=mesh,
                           device=cuda)
    idx, val = ell_laplacian(g, device=cuda)
    b = np.random.default_rng(6).standard_normal((g.n, 3)).astype(np.float32)
    kops.reset_launches()
    fused = make_solver(idx, val, hier, matvec_impl="fused", mesh=mesh,
                        device=cuda)
    res = fused(b, tol=1e-5, maxiter=2000)
    assert kops.launch_counts()["spmv_ell_batched"] > 0
    ref = make_solver(idx, val, hier, matvec_impl="ref", mesh=mesh,
                      device=cuda)(b, tol=1e-5, maxiter=2000)
    assert torch.equal(res.iters, ref.iters)
    assert torch.equal(res.x, ref.x)
    assert bool(res.converged.all())
    one = fused(b[:, 1:2], tol=1e-5, maxiter=2000)
    assert torch.equal(one.x[:, 0], res.x[:, 1])
    assert int(one.iters[0]) == int(res.iters[1])


@pytest.mark.gpu
def test_gpu_recover_mixed_matches_cpu(cuda):
    """The distributed recovery on the card (K4 in every shard's rounds and
    in the inner engine's marking) equals its CPU run bitwise."""
    g = star_hub(600, extra=500, seed=5)
    out = {}
    for dev in ("cpu", cuda):
        prep = Pipeline(pdgrass_config(chunk=256)).prepare(g, device=dev)
        mesh = make_mesh((8,), ("data",), device=dev)
        kops.reset_launches()
        out[str(dev)] = (recover_mixed(prep, mesh, chunk=256, cutoff=50),
                         kops.launch_counts()["similarity_mark"])
    assert out["cpu"][1] == 0 and out["cuda"][1] > 0
    assert torch.equal(out["cuda"][0].cpu(), out["cpu"][0])


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 8])
def test_gpu_k1_on_halo_extended_x(cuda, k):
    """K1 on a shard's x_ext = [x_loc; x[halo]], which has more rows than
    the shard's slab, bitwise equal to its plain version."""
    g = mesh2d(64, 64, seed=1)
    idx, val = ell_laplacian(g, device=cuda)
    slab, meta = shard_ell_slabs(idx, val, 8)
    gen = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randn((meta.n_pad, k), generator=gen, device=cuda)
    halo = slab.halo.view(8, meta.halo).long()
    for s in range(8):
        rows = slice(s * meta.n_loc, (s + 1) * meta.n_loc)
        x_ext = torch.cat([x[rows], x[halo[s]]])
        assert x_ext.shape[0] > meta.n_loc
        assert torch.equal(
            tvf.spmv_ell_batched(slab.idx[rows], slab.val[rows], x_ext),
            kref.spmv_ell_batched_ref(slab.idx[rows], slab.val[rows], x_ext))


def test_port_and_chip_smoke_import_no_jax():
    """Importing every module of repro_torch leaves neither ``jax`` nor
    ``repro`` in ``sys.modules`` (nothing blocked: a stray import would
    load them), and ``chip_smoke.py`` imports neither at any level."""
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    src = os.path.join(root, "src")
    code = (
        "import sys, pkgutil, importlib\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=src, timeout=120,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 51
    with open(os.path.join(root, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    assert "repro_torch" in roots


@pytest.mark.gpu
@pytest.mark.parametrize("entry", HOT_ENTRIES, ids=lambda e: e.name)
def test_gpu_registry_entry_audits_clean(cuda, entry):
    """Each hot entry on the card, under the dispatch mode and the CUDA
    sync debug mode: no unallowed transfer, float64 or structure finding;
    a PCG entry syncs once every 8 trips."""
    rep = dispatch_audit.audit_entry(entry, cuda)
    assert rep.findings == [], [f.format() for f in rep.findings]
    if entry.trips_arg is not None:
        assert rep.transfers_per_trip == 1 / 8
    if entry.name == "batched_pcg":
        # the trip caps' copy to the card (seen by the sync warnings'
        # hook alone), the trip cap read once, and the designated test at
        # 8 and 16 of the 16 trips
        assert rep.transfers == 4


@pytest.mark.gpu
def test_gpu_audit_sees_a_host_to_device_copy(cuda):
    """A positive control of the sync warnings' hook: a host-to-device
    copy that the dispatch mode does not see is a host transfer."""
    rep = dispatch_audit.audit_callable(
        "planted_h2d", lambda x: x + torch.tensor(1.0, device=cuda),
        (torch.ones(4, device=cuda),))
    assert [f.rule for f in rep.findings] == ["audit-host-transfer"]
    assert "a CUDA sync warning" in rep.findings[0].message


@pytest.mark.gpu
def test_gpu_cuda_check_over_the_built_library(cuda):
    """The ptxas rules over the log of the library built here, the launch
    limits and the shard layout: no error finding, every kernel read."""
    report = cuda_check.check_suite(device=cuda)
    assert [f.format() for f in report.findings
            if f.severity == SEV_ERROR] == []
    assert report.not_run == []
    kernels = report.kernels
    names = {k.name for k in kernels}
    assert {"spmv_ell_batched_kernel", "cheby_step_kernel",
            "cheby_smooth_zero_kernel", "cheby_prolong_step_kernel",
            "restrict_residual_any", "restrict_residual_vec",
            "spmv_ell_kernel", "stream_kernel", "rows_kernel",
            "ssm_scan_kernel", "ssm_scan_ckpt_kernel", "ssm_scan_bwd_kernel",
            "ssm_scan_bwd_reduce_kernel"} <= names
    assert all(k.registers > 0 for k in kernels)


# -- K6b and training ------------------------------------------------------

def _k6b_inputs(gen, cuda, B, S, di, state, dtype, rank=None):
    """K6b's operands: x, dt, B, C (of ``dtype``; B and C strided views of
    one x_proj-like output when ``rank`` is given), A, h0, dy, dhT."""
    x1 = torch.randn((B, S, di), generator=gen, device=cuda).to(dtype)
    dt = (0.1 * torch.rand((B, S, di), generator=gen, device=cuda)
          ).to(dtype)
    if rank is None:
        Bm, Cm = (torch.randn((B, S, state), generator=gen, device=cuda)
                  .to(dtype) for _ in range(2))
    else:
        xdbc = torch.randn((B, S, rank + 2 * state), generator=gen,
                           device=cuda).to(dtype)
        Bm, Cm = xdbc[..., rank:rank + state], xdbc[..., rank + state:]
    A = -torch.rand((di, state), generator=gen, device=cuda) - 0.1
    h0 = torch.randn((B, di, state), generator=gen, device=cuda)
    dy = torch.randn((B, S, di), generator=gen, device=cuda)
    dhT = torch.randn((B, di, state), generator=gen, device=cuda)
    return x1, dt, Bm, Cm, A, h0, dy, dhT


def _steps(S):
    """S as a test names it: a count of steps, or one about K6b's run
    length R ("R-1", "2R+3"), which the library gives."""
    if isinstance(S, int):
        return S
    m = re.fullmatch(r"(\d*)R([+-]\d+)?", S)
    return int(m.group(1) or 1) * run_length() + int(m.group(2) or 0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,di", [(1, 1, 8), (3, 37, 37), (2, 16, 100),
                                    (1, 5, 300), (2, "R-1", 37),
                                    (1, "R", 100), (2, "R+1", 45),
                                    (1, "2R+3", 100)])
@pytest.mark.parametrize("state", [4, 8, 16])
def test_gpu_k6b_bitwise_equal_to_plain(cuda, B, S, di, state):
    """K6b against its plain version on the card: every output bitwise,
    the reduced ones (dB, dC over the channels, dA over rows and steps)
    too, since the plain version sums in the kernel's order; float32 and
    bf16 inputs, nonzero h0 and dhT, odd di and di not a multiple of the
    block's 32 channels, S = 1 and S not a multiple of 16; S about the run
    length R (a run cut short, one run, a checkpoint read back, two); two
    launches bitwise equal; each launch counted."""
    S = _steps(S)
    gen = torch.Generator(device=cuda).manual_seed(B * 100 + S + di + state)
    for dtype in (torch.float32, torch.bfloat16):
        args = _k6b_inputs(gen, cuda, B, S, di, state, dtype)
        before = kops.launch_counts()["ssm_scan_bwd"]
        got = kops.ssm_scan_bwd(*args)
        again = kops.ssm_scan_bwd(*args)
        assert kops.launch_counts()["ssm_scan_bwd"] == before + 2
        want = kref.ssm_scan_bwd_ref(*args)
        for g, a, w in zip(got, again, want):
            assert g.dtype == torch.float32 and g.shape == w.shape
            assert torch.equal(g, w) and torch.equal(g, a)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [5, 8])
def test_gpu_k6b_strided_views_and_function(cuda, dtype, rank):
    """B and C as strided views of one x_proj output: K6b reads them in
    place, bitwise equal to the plain version on contiguous copies; through
    ``SsmScan`` the gradients come back in each input's dtype, B's and C's
    scattered into the output's columns, with one K6 and one K6b
    launch."""
    from repro_torch.kernels.ssm_scan import SsmScan

    gen = torch.Generator(device=cuda).manual_seed(rank)
    dtype = getattr(torch, dtype)
    x1, dt, Bm, Cm, A, h0, dy, dhT = _k6b_inputs(gen, cuda, 2, 37, 100, 16,
                                                 dtype, rank=rank)
    assert not Bm.is_contiguous()
    got = kops.ssm_scan_bwd(x1, dt, Bm, Cm, A, h0, dy, dhT)
    want = kref.ssm_scan_bwd_ref(x1, dt, Bm.contiguous(), Cm.contiguous(),
                                 A, h0, dy, dhT)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x1, dt, Bm._base, A, h0)]
    xb = leaves[2]
    before = kops.launch_counts()
    y, hT = SsmScan.apply(leaves[0], leaves[1], xb[..., rank:rank + 16],
                          xb[..., rank + 16:], leaves[3], leaves[4])
    ((y * dy).sum() + (hT * dhT).sum()).backward()
    after = kops.launch_counts()
    assert after["ssm_scan"] == before["ssm_scan"] + 1
    assert after["ssm_scan_bwd"] == before["ssm_scan_bwd"] + 1
    assert leaves[0].grad.dtype == dtype and xb.grad.dtype == dtype
    assert torch.equal(leaves[0].grad, want[0].to(dtype))
    assert torch.equal(xb.grad[..., rank:rank + 16], want[2].to(dtype))
    assert torch.equal(xb.grad[..., rank + 16:], want[3].to(dtype))
    assert not xb.grad[..., :rank].any()
    assert torch.equal(leaves[3].grad, want[4])


@pytest.mark.gpu
def test_gpu_k6b_allocates_checkpoints_not_a_state_stack(cuda):
    """One K6b call at B = 2, S = 4096, di = 512, state 16 allocates no
    more than its outputs plus its checkpoints and partial sums (their
    closed forms in ``launch/roofline.py``) plus 10%: a stack of every
    state would be 268 MB more."""
    from repro_torch.launch import roofline as rf

    B, S, di, state = 2, 4096, 512, 16
    gen = torch.Generator(device=cuda).manual_seed(3)
    args = _k6b_inputs(gen, cuda, B, S, di, state, torch.bfloat16, rank=32)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = kops.ssm_scan_bwd(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    outputs = sum(t.numel() * t.element_size() for t in got)
    scratch = (rf.ssm_scan_bwd_checkpoint_bytes(B, S, di, state,
                                                run_length())
               + rf.ssm_scan_bwd_partial_bytes(B, S, di, state))
    assert outputs + scratch <= peak <= 1.1 * (outputs + scratch)
    assert peak < 4 * B * S * di * state


@pytest.mark.gpu
def test_gpu_k6b_rejects_what_it_cannot_take(cuda):
    x = torch.zeros((1, 4, 8), device=cuda)
    s5 = torch.zeros((1, 4, 5), device=cuda)
    with pytest.raises(ValueError):   # no instance for state 5
        kops.ssm_scan_bwd(x, x, s5, s5, torch.zeros((8, 5), device=cuda),
                          torch.zeros((1, 8, 5), device=cuda), x)
    s4 = torch.zeros((1, 4, 4), device=cuda)
    with pytest.raises(ValueError):   # dy of another length
        kops.ssm_scan_bwd(x, x, s4, s4, torch.zeros((8, 4), device=cuda),
                          torch.zeros((1, 8, 4), device=cuda),
                          torch.zeros((1, 3, 8), device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_train_step_matches_cpu(cuda, dtype):
    """Reduced hymba (attention and Mamba; 4 layers for a windowed layer),
    the same weights and batch: one ``make_train_step`` on the card (K6
    forward and in the recompute, K6b backward) and on the CPU (their
    plain versions): the loss, every gradient by relative norm and the
    parameters after the step, within the float32 bar 1e-4 (the devices'
    matmuls sum in other orders, and Adam's update is lr-sized whatever
    the gradient) or the bf16 bar 2e-2."""
    import dataclasses

    from repro_torch.train import (AdamWConfig, TrainConfig, init_opt_state,
                                   make_batch, make_train_step)
    from repro_torch.train.trainer import loss_and_grads

    cfg = dataclasses.replace(reduced(get_config("hymba-1.5b")), n_layers=4,
                              dtype=dtype)
    bar = 1e-4 if dtype == "float32" else 2e-2
    host = tmodel.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    batch = make_batch(cfg, 2, 32, step=0, seed=1)
    tc = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1), remat=True)
    out = {}
    for dev in ("cpu", cuda):
        model = tmodel.LM(cfg, device="meta")
        model.load_state_dict({k: v.to(dev, copy=True) for k, v in
                               host.state_dict().items()}, assign=True)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        before = kops.launch_counts()
        loss, _, grads = loss_and_grads(model, cfg, tc, b)
        launched = {k: v - before[k] for k, v in kops.launch_counts().items()}
        make_train_step(cfg, tc)(model, init_opt_state(model, tc.opt), {}, b)
        out[str(dev)] = (float(loss), {k: g.cpu() for k, g in grads.items()},
                         {k: p.detach().cpu() for k, p in
                          model.named_parameters()}, launched)
    (lc, gc, pc, nc), (lg, gg, pg, ng) = out["cpu"], out["cuda"]
    assert not any(nc.values())
    assert ng == dict.fromkeys(ng, 0) | {"ssm_scan": 2 * cfg.n_layers,
                                         "ssm_scan_bwd": cfg.n_layers}
    assert abs(lg - lc) <= bar * abs(lc)
    for k in gc:
        assert float((gg[k] - gc[k]).norm()) <= bar * float(
            gc[k].norm()) + 1e-12, k
        torch.testing.assert_close(pg[k], pc[k], rtol=bar, atol=bar)


@pytest.mark.gpu
def test_gpu_restart_bit_identical_under_deterministic_algorithms(cuda,
                                                                  tmp_path):
    """Reduced hymba on the card: a crash at step 3 and a restart from the
    step-2 checkpoint give the uninterrupted run's losses and parameters
    bit for bit.  Run with ``torch.use_deterministic_algorithms(True)``
    (the embedding's backward otherwise adds with atomics); it needs
    ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts, so the test runs
    in a child process."""
    code = f"""
import os, sys
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
import dataclasses, torch
sys.path.insert(0, {os.path.join(os.path.dirname(__file__), os.pardir, "src")!r})
from repro_torch.configs import get_config, reduced
from repro_torch.train import (AdamWConfig, ResilientTrainer, TrainConfig,
                               batches)
torch.use_deterministic_algorithms(True)
cfg = dataclasses.replace(reduced(get_config("hymba-1.5b")), n_layers=4)
tc = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=6))
data = lambda s: batches(cfg, 2, 32, seed=5, start_step=s)
root = {str(tmp_path)!r}
def run(d, **kw):
    return ResilientTrainer(cfg, tc, ckpt_dir=os.path.join(root, d),
                            ckpt_every=2, device="cuda").run(
        data, steps=6, seed=3, **kw)
m1, _, l1 = run("a", resume=False)
try:
    run("b", resume=False, fail_at=3)
    raise SystemExit("no simulated failure")
except RuntimeError:
    pass
m3, _, l3 = run("b", resume=True)
assert l3 == l1[2:], (l1, l3)
for (n, a), (_, b) in zip(m1.named_parameters(), m3.named_parameters()):
    assert torch.equal(a, b), n
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]


def test_chip_smoke_takes_its_bounds_from_the_roofline_module():
    """``chip_smoke.py`` imports ``repro_torch.launch.roofline`` and
    defines no bound or peak of its own: no ``bound_ms``/``k4_bound``
    function, no HBM or FLOP/s constant."""
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    with open(os.path.join(root, "chip_smoke.py")) as f:
        src = f.read()
    tree = ast.parse(src)
    imported = {(node.module, a.name) for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom)
                for a in node.names}
    assert ("repro_torch.launch", "roofline") in imported
    defs = {node.name for node in ast.walk(tree)
            if isinstance(node, ast.FunctionDef)}
    assert not defs & {"bound_ms", "k4_bound"}
    assigned = {t.id for node in ast.walk(tree)
                if isinstance(node, ast.Assign) for t in node.targets
                if isinstance(t, ast.Name)}
    assert not {n for n in assigned if "HBM" in n or "FLOPS" in n}
    assert "3.35e12" not in src and "67e12" not in src


@pytest.mark.gpu
def test_gpu_k6_and_k6b_ops_launch_only_their_kernels(cuda):
    """K6 and K6b as operators (``torch.ops.repro_torch``) add no copy on
    the card: on hymba's training layout (bf16, B and C strided views of
    ``x_proj``'s output) one K6 call runs one device kernel and one K6b
    call its three (checkpoints, reverse scan, reduction)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(7)
    B, S, di, state, rank = 2, 64, 96, 16, 8
    x1 = torch.randn((B, S, di), generator=gen, device=cuda).bfloat16()
    dt = torch.rand((B, S, di), generator=gen, device=cuda).bfloat16()
    xp = torch.randn((B, S, rank + 2 * state), generator=gen,
                     device=cuda).bfloat16()
    Bm, Cm = xp[..., rank:rank + state], xp[..., rank + state:]
    A = -torch.rand((di, state), generator=gen, device=cuda) - 0.1
    h0 = torch.zeros((B, di, state), device=cuda)
    dy = torch.randn((B, S, di), generator=gen, device=cuda)
    dhT = torch.zeros_like(h0)
    kops.ssm_scan(x1, dt, Bm, Cm, A, h0)
    kops.ssm_scan_bwd(x1, dt, Bm, Cm, A, h0, dy, dhT)
    torch.cuda.synchronize()
    for fn, n in ((lambda: kops.ssm_scan(x1, dt, Bm, Cm, A, h0), 1),
                  (lambda: kops.ssm_scan_bwd(x1, dt, Bm, Cm, A, h0, dy,
                                             dhT), 3)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == n and all("ssm_scan" in k for k in names), names


@pytest.mark.gpu
@pytest.mark.parametrize("shape,want", [("train_4k", (4, 2)),
                                        ("prefill_32k", (2, 0)),
                                        ("decode_32k", (0, 0))])
def test_gpu_run_cell_launches_equal_the_count(cuda, shape, want):
    """A reduced hymba-1.5b cell run on the card by the dry run: K6 and
    K6b launch as often as the cost counter counts their calls on
    ``meta`` (2 Mamba layers: K6 forward and in the recompute, K6b once
    each), the loss or logits finite, the record's numbers set."""
    import dataclasses

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cfg, r = get_config("hymba-1.5b"), reduced(get_config("hymba-1.5b"))
    ov = {f.name: getattr(r, f.name) for f in dataclasses.fields(cfg)
          if getattr(r, f.name) != getattr(cfg, f.name)}
    row = dryrun.run_cell("hymba-1.5b", shape, make_production_mesh(
        device="meta"), "16x16", verbose=False, cfg_overrides=ov,
        device="cuda", run_batch=2, run_seq=64, run_calls=2)
    rec = row["card"]
    assert rec["launches"] == rec["counted"]
    assert tuple(rec["launches"].values()) == want
    assert rec["finite"] and rec["step_ms"] > 0 and rec["bound_ms"] > 0
    assert rec["peak_bytes"] >= rec["arg_bytes"] > 0
