"""The port's kernels K1-K6 (repro_torch.kernels) against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version; these are
held against the reference's jnp path and against its Pallas kernels in
interpret mode, with rtol 1e-5 and atol 1e-5 * max|input| (the two
frameworks sum in different orders).  The ELL slab layout and K4's boolean
marks must be bit-identical.  The CUDA kernels themselves are tested on the card by
``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import graph as jgraph  # noqa: E402
from repro.core.device_graph import DeviceGraph as JDeviceGraph  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import vcycle_fused as jvf  # noqa: E402
from repro.kernels.spmv_ell import to_ell as jto_ell  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan as jssm_scan  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan_ref as jssm_scan_ref  # noqa: E402
from repro.pipeline import pdgrass_config as jconfig  # noqa: E402
from repro.solver import device_pcg as jpcg  # noqa: E402
from repro.solver.hierarchy import build_hierarchy as jbuild  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core.device_graph import DeviceGraph  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import vcycle_fused as tvf  # noqa: E402
from repro_torch.kernels.spmv_ell import to_ell  # noqa: E402
from repro_torch.solver.hierarchy import aggregate_csr  # noqa: E402

from _k4_layouts import K4_LAYOUTS, k4_layout  # noqa: E402

def _suites():
    j, t = dict(jgraph.suite("tiny")), dict(tgraph.suite("tiny"))
    j["mesh12"], t["mesh12"] = jgraph.mesh2d(12, 12), tgraph.mesh2d(12, 12)
    return j, t


JG, TG = _suites()


def _close(got, want, *inputs):
    scale = max(float(np.abs(np.asarray(a)).max()) for a in inputs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * scale)


def _rhs(n, k, seed):
    r = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    return r - r.mean(axis=0)


@pytest.fixture(scope="module")
def level0():
    """Level 0 of the reference's mesh12 hierarchy: slabs, diag, agg."""
    h = jbuild(JG["mesh12"], config=jconfig(alpha=0.05, chunk=256))
    lev = h.levels[0]
    return {k: np.array(getattr(lev, k)) for k in
            ("idx", "val", "diag", "agg")} | {"n_coarse": lev.n_coarse}


# -- ELL layout ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["ba", "star", "mesh12"])
def test_to_ell_host_and_device_bit_identical(name):
    ji, jv = jto_ell(JG[name])
    ti, tv = to_ell(TG[name], device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jdg = JDeviceGraph.from_graph(JG[name])
    tdg = DeviceGraph.from_graph(TG[name], device="cpu")
    np.testing.assert_array_equal(tdg.diag.numpy(), np.asarray(jdg.diag))
    for a, b in zip(tdg.to_ell(), jdg.to_ell()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = _rhs(TG[name].n, 3, seed=1)
    _close(tdg.laplacian_matvec(torch.as_tensor(x)),
           jdg.laplacian_matvec(jnp.asarray(x)), x, tv.numpy())


# -- K1 ------------------------------------------------------------------------

@pytest.mark.parametrize("n", [31, 100, 257])
@pytest.mark.parametrize("k", [1, 3, 8, 16])
def test_k1_plain_matches_reference_edge_sizes(n, k):
    """Random slabs, x with more rows than the slab (nx > n)."""
    rng = np.random.default_rng(n * 17 + k)
    L, nx = 5, n + 9
    idx = rng.integers(0, nx, (n, L)).astype(np.int32)
    val = rng.standard_normal((n, L)).astype(np.float32)
    x = rng.standard_normal((nx, k)).astype(np.float32)
    got = tvf.spmv_ell_batched(torch.as_tensor(idx), torch.as_tensor(val),
                               torch.as_tensor(x))
    assert got.shape == (n, k)
    want_ref = jnp.einsum("nl,nlk->nk", jnp.asarray(val), jnp.asarray(x)[idx])
    _close(got, want_ref, val, x)
    if k in (1, 8):  # the Pallas kernel itself, in interpret mode
        want_k = jvf.spmv_ell_batched(jnp.asarray(idx), jnp.asarray(val),
                                      jnp.asarray(x), tile_n=32,
                                      interpret=True)
        _close(got, want_k, val, x)


def test_k1_on_cpu_runs_plain_and_counts_nothing():
    before = tops.launch_counts()
    idx, val = to_ell(TG["mesh12"], device="cpu")
    x = torch.as_tensor(_rhs(TG["mesh12"].n, 4, seed=2))
    y = tvf.spmv_ell_batched(idx, val, x)
    assert y.device.type == "cpu"
    assert torch.equal(y, kref.spmv_ell_batched_ref(idx, val, x))
    assert tops.launch_counts() == before


# -- K2 ------------------------------------------------------------------------

@pytest.mark.parametrize("degree", [2, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_k2_smoother_matches_reference(level0, degree, warm):
    lv = level0
    idx, val, diag = (jnp.asarray(lv[k]) for k in ("idx", "val", "diag"))
    rho = jpcg.estimate_dinv_rho(jpcg.make_matvec(idx, val, "ref"), diag)
    r = _rhs(lv["idx"].shape[0], 4, seed=degree)
    z = _rhs(lv["idx"].shape[0], 4, seed=degree + 10) * 0.1 if warm else None
    jz = None if z is None else jnp.asarray(z)
    want_ref = jpcg.make_chebyshev_smoother(
        jpcg.make_matvec(idx, val, "ref"), diag, rho, degree=degree)(
        jnp.asarray(r), jz)
    want_k = jvf.make_fused_chebyshev(idx, val, diag, rho, degree=degree,
                                      interpret=True)(jnp.asarray(r), jz)
    ts = tvf.make_fused_chebyshev(*(torch.as_tensor(lv[k]) for k in
                                    ("idx", "val", "diag")), rho,
                                  degree=degree)
    got = ts(torch.as_tensor(r), None if z is None else torch.as_tensor(z))
    _close(got, want_ref, r, lv["val"])
    _close(got, want_k, r, lv["val"])


@pytest.mark.parametrize("first,warm", [(True, False), (True, True),
                                        (False, True)])
def test_k2_step_composes_the_recurrence(first, warm):
    """One step through the wrapper equals the plain step (CPU route)."""
    rng = np.random.default_rng(5)
    n, L, k = 100, 4, 3
    idx = torch.as_tensor(rng.integers(0, n, (n, L)).astype(np.int32))
    val = torch.as_tensor(rng.standard_normal((n, L)).astype(np.float32))
    inv_d = torch.as_tensor(rng.random(n).astype(np.float32) + 0.5)
    r, z, p = (torch.as_tensor(rng.standard_normal((n, k)).astype(np.float32))
               for _ in range(3))
    zp = z if warm else None
    kw = dict(first=first, theta=1.3, c1=0.7, c2=0.4)
    pw, zw = tvf.cheby_step(idx, val, inv_d, r, zp, p.clone(),
                            torch.empty_like(r), **kw)
    pr, zr = kref.cheby_step_ref(idx, val, inv_d, r, zp, p.clone(), **kw)
    assert torch.equal(pw, pr) and torch.equal(zw, zr)


# -- K3 ------------------------------------------------------------------------

def test_k3_restrict_matches_reference(level0):
    lv = level0
    n = lv["idx"].shape[0]
    r, z = _rhs(n, 4, seed=3), _rhs(n, 4, seed=4) * 0.1
    idx, val, agg = (jnp.asarray(lv[k]) for k in ("idx", "val", "agg"))
    mv = jpcg.make_matvec(idx, val, "ref")
    want_ref = jax.ops.segment_sum(jnp.asarray(r) - mv(jnp.asarray(z)), agg,
                                   num_segments=lv["n_coarse"])
    want_k = jvf.make_fused_restrict_residual(
        idx, val, agg, lv["n_coarse"], interpret=True)(jnp.asarray(r),
                                                        jnp.asarray(z))
    perm, ptr, amax = aggregate_csr(torch.as_tensor(lv["agg"]),
                                    lv["n_coarse"])
    got = tvf.restrict_residual(torch.as_tensor(lv["idx"]),
                                torch.as_tensor(lv["val"]), perm, ptr, amax,
                                torch.as_tensor(r), torch.as_tensor(z))
    _close(got, want_ref, r, lv["val"])
    _close(got, want_k, r, lv["val"])


@pytest.mark.parametrize("L", [3, 7, 8])
def test_k3_aggregate_slabs_hold_rows_in_aggregate_order(L):
    """K3's aggregate-order copy: row m is slab row perm[m], padded with
    zero columns to a multiple of 4; on the CPU the wrapper ignores it and
    gives the plain result."""
    rng = np.random.default_rng(L)
    n, nc = 40, 13
    idx = torch.as_tensor(rng.integers(0, n, size=(n, L)).astype(np.int32))
    val = torch.as_tensor(rng.standard_normal((n, L)).astype(np.float32))
    agg = torch.as_tensor(rng.integers(0, nc, size=n).astype(np.int32))
    agg[:nc] = torch.arange(nc, dtype=torch.int32)
    perm, ptr, amax = aggregate_csr(agg, nc)
    idx_agg, val_agg = tvf.aggregate_slabs(idx, val, perm)
    width = -(-L // 4) * 4
    assert idx_agg.shape == val_agg.shape == (n, width)
    assert idx_agg.dtype == torch.int32 and val_agg.dtype == torch.float32
    for m in range(n):
        i = int(perm[m])
        assert torch.equal(idx_agg[m, :L], idx[i])
        assert torch.equal(val_agg[m, :L], val[i])
    assert not idx_agg[:, L:].any() and not val_agg[:, L:].any()
    r, z = (torch.as_tensor(rng.standard_normal((n, 8)).astype(np.float32))
            for _ in range(2))
    want = kref.restrict_residual_ref(idx, val, perm, ptr, amax, r, z)
    assert torch.equal(tvf.restrict_residual(idx, val, perm, ptr, amax, r, z,
                                             agg_slabs=(idx_agg, val_agg)),
                       want)
    assert torch.equal(tvf.make_fused_restrict_residual(
        idx, val, perm, ptr, amax)(r, z), want)


def test_aggregate_csr_lists_members_ascending():
    agg = torch.as_tensor(np.array([2, 0, 1, 0, 2, 2, 1], np.int32))
    perm, ptr, amax = aggregate_csr(agg, 3)
    assert ptr.tolist() == [0, 2, 4, 7]
    assert perm.tolist() == [1, 3, 2, 6, 0, 4, 5]
    assert amax == 3


def test_cheby_coeffs_match_reference():
    for rho in (0.3, 1.0, 1.9481308):
        assert tvf.cheby_coeffs(rho) == jvf.cheby_coeffs(rho)


# -- K4 ------------------------------------------------------------------------

def _sim_problem(rng, K, m, c1, n_seg=5):
    """Drawn as the reference's kernel test draws them."""
    sig = lambda r: rng.integers(0, 30, size=(r, c1)).astype(np.int32)
    csu, csv = sig(K), sig(K)
    esu, esv = sig(m), sig(m)
    cbeta = rng.integers(-1, c1, size=K).astype(np.int32)
    cseg = rng.integers(0, n_seg, size=K).astype(np.int32)
    eseg = rng.integers(0, n_seg, size=m).astype(np.int32)
    eseg[rng.random(m) < 0.1] = -1  # padding rows
    return csu, csv, cbeta, cseg, esu, esv, eseg


def _k4_all_routes(args, tile_m, monkeypatch):
    """The port's ops entry point and plain version (one chunk, then chunks
    of 7 rows) against the reference's Pallas kernel (interpret mode) and
    its oracle."""
    t_args = [torch.as_tensor(a) for a in args]
    j_args = [jnp.asarray(a) for a in args]
    want = np.asarray(jops.similarity_mark(*j_args, tile_m=tile_m))
    np.testing.assert_array_equal(
        np.asarray(jops.similarity_mark_ref(*j_args)), want)
    got = tops.similarity_mark(*t_args, tile_m=tile_m)
    assert got.dtype == torch.bool and got.shape == (args[4].shape[0],)
    np.testing.assert_array_equal(got.numpy(), want)
    K, c1 = args[0].shape
    monkeypatch.setattr(kref, "_SIM_CHUNK_CELLS", 7 * K * c1 * c1)
    np.testing.assert_array_equal(
        kref.similarity_mark_ref(*t_args).numpy(), want)


@pytest.mark.parametrize("K,m,c1,tile_m", [
    (8, 64, 9, 32),
    (16, 512, 9, 512),
    (128, 1024, 9, 256),
    (4, 100, 5, 64),      # m not a multiple of tile_m
    (32, 96, 13, 32),     # larger c
])
def test_k4_plain_matches_reference(K, m, c1, tile_m, monkeypatch):
    rng = np.random.default_rng(K * m)
    _k4_all_routes(_sim_problem(rng, K, m, c1), tile_m, monkeypatch)


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("K", [1, 8, 33])
@pytest.mark.parametrize("m,c1", [(32, 3), (200, 9)])
def test_k4_plain_matches_reference_seeded(seed, K, m, c1, monkeypatch):
    rng = np.random.default_rng(seed * 1000 + K * m + c1)
    _k4_all_routes(_sim_problem(rng, K, m, c1), 32, monkeypatch)


@pytest.mark.parametrize("layout", K4_LAYOUTS)
def test_k4_plain_matches_reference_on_kernel_layouts(layout):
    """The layouts that reach each part of the CUDA kernel (many subtasks
    in a warp, 128 candidates in one subtask, K past a tile, ragged m, c1
    at both ends, no recovered candidate, padding beside invalid
    candidates): the port's plain version against the reference's Pallas
    kernel in interpret mode, bitwise."""
    args = k4_layout(layout)
    K, c1 = args[0].shape
    m = args[4].shape[0]
    # the reference runs on one shape per c1 (one compile): extra
    # candidates are disabled (cbeta -1) and extra rows are cut off
    K_pad, m_pad = 300, 8240
    pads = ((K_pad - K, 0), (K_pad - K, 0), (K_pad - K, -1), (K_pad - K, -2),
            (m_pad - m, 0), (m_pad - m, 0), (m_pad - m, -3))
    padded = [np.pad(a, [(0, n)] + [(0, 0)] * (a.ndim - 1),
                     constant_values=v) for a, (n, v) in zip(args, pads)]
    want = np.asarray(jops.similarity_mark(
        *[jnp.asarray(a) for a in padded], tile_m=m_pad))[:m]
    got = tops.similarity_mark(*[torch.as_tensor(a) for a in args])
    assert got.dtype == torch.bool and got.shape == (m,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_k4_static_skip_of_pairs_past_c():
    """A beta above c1 - 1 still tests only the pairs a + b <= c1 - 1, as
    the TPU kernel's static skip does (beta* never exceeds c)."""
    csu = np.array([[1, 2, 3]], np.int32)
    csv = np.array([[4, 5, 6]], np.int32)
    esu = np.array([[0, 0, 3], [0, 2, 0]], np.int32)
    esv = np.array([[0, 0, 6], [0, 5, 0]], np.int32)
    args = [torch.as_tensor(a) for a in
            (csu, csv, np.array([5], np.int32), np.array([0], np.int32),
             esu, esv, np.array([0, 0], np.int32))]
    # row 0 matches only at (a, b) = (2, 2): a + b = 4 > c1 - 1 = 2
    assert tops.similarity_mark(*args).tolist() == [False, True]
    want = jops.similarity_mark(*[jnp.asarray(a.numpy()) for a in args],
                                tile_m=2)
    assert np.asarray(want).tolist() == [False, True]


def _threads(target, n_threads):
    """Run ``target(tid)`` on ``n_threads`` threads with a short switch
    interval; every thread must finish within 60 s."""
    import sys
    import threading

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=target, args=(tid,))
                   for tid in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60.0)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)


def test_k4_launch_numbers_reach_the_stream_in_order():
    """Launches on one (device, stream) share a row list whose counters
    hold only when launch ``n + 1`` is enqueued after launch ``n``: under
    16 threads, the enqueue callbacks see the numbers 1, 2, 3, ... in
    their own order, and the scratch is one per (device, stream)."""
    import time

    from repro_torch.kernels import similarity as ksim

    scratch = ksim._RowScratch("cpu")
    seen = []

    def enqueue(ptr, epoch):
        time.sleep(0)               # ctypes lets go of the GIL here
        seen.append(epoch)          # the launch reaches the stream
        return 0

    _threads(lambda tid: [scratch.launch(enqueue) for _ in range(200)], 16)
    assert seen == list(range(1, 16 * 200 + 1))
    a = ksim._row_scratch(torch.device("cpu"), 11)
    assert ksim._row_scratch(torch.device("cpu"), 11) is a
    assert ksim._row_scratch(torch.device("cpu"), 12) is not a
    for key in [(torch.device("cpu"), 11), (torch.device("cpu"), 12)]:
        del ksim._scratch[key]


def test_launch_counts_exact_under_threads():
    from repro_torch.kernels import _launch

    before = tops.launch_counts()["similarity_mark"]
    _threads(lambda tid: [_launch.count("similarity_mark")
                          for _ in range(2000)], 16)
    assert tops.launch_counts()["similarity_mark"] == before + 16 * 2000
    with _launch.launches_lock:
        _launch.launches["similarity_mark"] = before


def test_k4_on_cpu_counts_nothing():
    before = tops.launch_counts()
    args = [torch.as_tensor(a) for a in
            _sim_problem(np.random.default_rng(5), 8, 40, 9)]
    assert tops.similarity_mark(*args).device.type == "cpu"
    assert tops.launch_counts() == before


# -- K5 ------------------------------------------------------------------------

@pytest.mark.parametrize("n", [31, 100, 257])
def test_k5_plain_matches_reference(n):
    """Against the reference's oracle and its Pallas kernel (interpret
    mode) within rtol 1e-5; bitwise against one column of K1."""
    rng = np.random.default_rng(n * 31)
    L = 6
    idx = rng.integers(0, n, (n, L)).astype(np.int32)
    val = rng.standard_normal((n, L)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    ti, tv, tx = map(torch.as_tensor, (idx, val, x))
    before = tops.launch_counts()
    got = tops.spmv(ti, tv, tx)
    assert got.shape == (n,) and tops.launch_counts() == before
    assert torch.equal(got, kref.spmv_ell_ref(ti, tv, tx))
    assert torch.equal(got, tops.spmv_batched(ti, tv, tx[:, None])[:, 0])
    ji, jv, jx = map(jnp.asarray, (idx, val, x))
    _close(got, jops.spmv_ref(ji, jv, jx), val, x)
    _close(got, jops.spmv(ji, jv, jx, tile_n=32), val, x)


# -- K6 ------------------------------------------------------------------------

def _scan_inputs(seed, B, S, di, state):
    """Drawn as the reference's kernel test draws them (non-zero h0)."""
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = (0.1 * rng.random((B, S, di))).astype(np.float32)
    Bm = rng.standard_normal((B, S, state)).astype(np.float32)
    Cm = rng.standard_normal((B, S, state)).astype(np.float32)
    A = -np.abs(rng.standard_normal((di, state))).astype(np.float32)
    h0 = rng.standard_normal((B, di, state)).astype(np.float32)
    return x1, dt, Bm, Cm, A, h0


@pytest.mark.parametrize("B,S,di,state,blk", [
    (2, 16, 8, 4, 8),
    (1, 64, 32, 16, 16),
    (3, 32, 64, 8, 64),
])
def test_k6_plain_matches_reference(B, S, di, state, blk):
    """K6's plain version (the CPU route of ``ops.ssm_scan``) against the
    reference's Pallas kernel in interpret mode and its jnp oracle, at the
    reference kernel test's shapes, rtol 1e-5 and atol 1e-5."""
    args = _scan_inputs(B * S + di, B, S, di, state)
    before = tops.launch_counts()
    y, hT = tops.ssm_scan(*map(torch.as_tensor, args))
    assert tops.launch_counts() == before
    assert y.shape == (B, S, di) and hT.shape == (B, di, state)
    assert y.dtype == hT.dtype == torch.float32
    ja = list(map(jnp.asarray, args))
    for want_y, want_h in (jssm_scan(*ja, blk=blk), jssm_scan_ref(*ja)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(hT.numpy(), np.asarray(want_h), rtol=1e-5,
                                   atol=1e-5)


def test_k6_plain_casts_to_f32_and_sums_state_in_order():
    """bf16 inputs are cast to float32 first (the reference wrapper's
    casts), and y sums over the state in ascending order, one rounded
    product and add per term, so a hand-written loop gives the same bits."""
    args = [torch.as_tensor(a) for a in _scan_inputs(9, 2, 8, 12, 4)]
    bf = [a.to(torch.bfloat16) for a in args[:4]] + args[4:]
    y, hT = tops.ssm_scan(*bf)
    y32, h32 = kref.ssm_scan_ref(*[a.float() for a in bf])
    assert torch.equal(y, y32) and torch.equal(hT, h32)
    x1, dt, Bm, Cm, A, h = (a.float() for a in bf)
    for t in range(x1.shape[1]):
        da = torch.exp(dt[:, t, :, None] * A)
        h = da * h + (dt[:, t] * x1[:, t])[:, :, None] * Bm[:, t, None, :]
        acc = h[..., 0] * Cm[:, t, None, 0]
        for n in range(1, 4):
            acc = acc + h[..., n] * Cm[:, t, None, n]
        assert torch.equal(y[:, t], acc)
    assert torch.equal(hT, h)


# -- K7 ------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TG))
@pytest.mark.parametrize("k", [1, 3, 8])
def test_k7_plain_is_the_host_residual(name, k):
    """On the CPU K7's wrapper runs the host's float64 residual: ``b - L x``
    bitwise equal to the reference's ``Graph.laplacian_matvec`` over the
    same graph, each column's mean and norm those of numpy over the
    columns alone (a column's bits in a batch of any width), and no
    launch counted."""
    tg, jg = TG[name], JG[name]
    rng = np.random.default_rng(k)
    b = rng.standard_normal((tg.n, k)).astype(np.float32)
    x = rng.standard_normal((tg.n, k))
    before = tops.launch_counts()
    csr = tops.upload_csr(tg, device="cpu")
    r, mean, norm, b_norm = tops.laplacian_residual(
        *csr, torch.as_tensor(b), torch.as_tensor(x), with_b_norm=True)
    assert tops.launch_counts() == before
    want = b.astype(np.float64) - jg.laplacian_matvec(x)
    assert r.dtype == torch.float64 and np.array_equal(r.numpy(), want)
    assert np.array_equal(r.numpy(), b - tg.laplacian_matvec(x))
    for j in range(k):
        col = np.stack([want[:, j], 0 * want[:, j]], axis=1)
        bj = np.stack([b[:, j], 0 * b[:, j]], axis=1).astype(np.float64)
        assert mean[j].item() == col.mean(axis=0)[0]
        assert norm[j].item() == np.linalg.norm(col, axis=0)[0]
        assert b_norm[j].item() == np.linalg.norm(bj, axis=0)[0]
    assert tops.laplacian_residual(*csr, torch.as_tensor(b),
                                   torch.as_tensor(x))[3] is None
