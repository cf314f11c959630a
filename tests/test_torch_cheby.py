"""K2, the fused Chebyshev smoother, on the CPU: its sweeps' plain versions
against the recurrence step by step, its wrappers' CPU route, its factory
against the JAX package's fused smoother, and the V-cycle's two routes.

  * each sweep's plain version (``kernels/ref.py``) is ``torch.equal`` to
    composing :func:`cheby_step_ref` with the prolongation ``z + zc[agg]``;
  * each wrapper on CPU tensors returns its plain version and launches
    nothing;
  * the port's smoother with ``zc`` against the reference's
    ``make_fused_chebyshev(..., interpret=True)`` applied to ``z +
    zc[agg]``: rtol 1e-5, atol 1e-5 * max|input| (the two frameworks sum
    in different orders);
  * ``make_vcycle``'s fused and ``ref`` routes ``torch.equal`` on the
    suite's hierarchies.

The kernels themselves are held against these plain versions on the card
by ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import graph as jgraph  # noqa: E402
from repro.kernels import vcycle_fused as jvf  # noqa: E402
from repro.pipeline import pdgrass_config as jconfig  # noqa: E402
from repro.solver import device_pcg as jpcg  # noqa: E402
from repro.solver.hierarchy import build_hierarchy as jbuild  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import vcycle_fused as tvf  # noqa: E402
from repro_torch.pipeline import pdgrass_config as tconfig  # noqa: E402
from repro_torch.solver import device_pcg as tpcg  # noqa: E402
from repro_torch.solver import hierarchy as thier  # noqa: E402

THETA, C1, C2 = 1.37, 0.61, 0.93


def _problem(n, k, n_coarse, seed, L=5):
    """Random square slabs, inv_d, r, z, zc and agg (every coarse vertex
    used); ``n_coarse == 1`` is one aggregate of every row."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: torch.as_tensor(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, n, (n, L)).astype(np.int32))
    agg = rng.integers(0, n_coarse, n)
    agg[:n_coarse] = np.arange(n_coarse)
    return dict(idx=idx, val=f32(n, L),
                inv_d=torch.as_tensor(rng.random(n).astype(np.float32)
                                      + 0.5),
                r=f32(n, k), z=f32(n, k), zc=f32(n_coarse, k),
                agg=torch.as_tensor(rng.permutation(agg).astype(np.int32)))


def _recurrence(c, z, *, prolong, degree, theta=THETA):
    """The sweep composed of :func:`cheby_step_ref`, one step at a time,
    from zero (``z=None``) or from ``z`` (plus ``zc[agg]`` when
    ``prolong``), with the factory's step coefficients."""
    if z is not None and prolong:
        z = z + c["zc"][c["agg"].long()]
    args = (c["idx"], c["val"], c["inv_d"], c["r"])
    p, z = kref.cheby_step_ref(*args, z, None, first=True, theta=theta)
    for c1, c2 in [(C1, C2), (0.37, 1.21)][:degree - 1]:
        p, z = kref.cheby_step_ref(*args, z, p, first=False, theta=theta,
                                   c1=c1, c2=c2)
    return p, z


# -- the plain versions against the recurrence -----------------------------------

@pytest.mark.parametrize("n,k,nc", [(31, 1, 1), (100, 3, 33), (257, 8, 40),
                                    (100, 16, 7)])
def test_plain_sweeps_compose_the_recurrence(n, k, nc):
    c = _problem(n, k, nc, seed=n + k)
    args = (c["idx"], c["val"], c["inv_d"], c["r"])
    kw = dict(theta=THETA, c1=C1, c2=C2)
    p, z = kref.cheby_smooth_zero_ref(*args, **kw)
    pw, zw = _recurrence(c, None, prolong=False, degree=2)
    assert torch.equal(p, pw) and torch.equal(z, zw)
    for prolong in (False, True):
        zc_agg = (c["zc"], c["agg"]) if prolong else (None, None)
        pw, zw = _recurrence(c, c["z"], prolong=prolong, degree=1)
        p, z = kref.cheby_prolong_step_ref(*args, c["z"], *zc_agg,
                                           theta=THETA)
        assert torch.equal(p, pw) and torch.equal(z, zw)


def _factory_case(degree, n_coarse=17, seed=3):
    """A square problem with the factory's own coefficients: the problem,
    rho, and the factory's ``[(c1, c2)]`` and theta."""
    c = _problem(120, 4, n_coarse, seed=seed)
    rho = 1.9
    theta, delta, sigma = tvf.cheby_coeffs(rho)
    return c, rho, theta, tvf.cheby_step_coeffs(delta, sigma, degree)


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("start", ["zero", "warm", "prolong"])
@pytest.mark.parametrize("n_coarse", [1, 17])
def test_factory_equals_the_recurrence(degree, start, n_coarse):
    """``make_fused_chebyshev`` on the CPU, on one aggregate and on ragged
    ones, is ``torch.equal`` to the recurrence composed of
    ``cheby_step_ref``."""
    c, rho, theta, steps = _factory_case(degree, n_coarse)
    diag = 1.0 / c["inv_d"]
    smooth = tvf.make_fused_chebyshev(c["idx"], c["val"], diag, rho,
                                      degree=degree, agg=c["agg"])
    args = (c["idx"], c["val"], 1.0 / diag, c["r"])
    z = None if start == "zero" else c["z"]
    if start == "prolong":
        z = z + c["zc"][c["agg"].long()]
    p, want = kref.cheby_step_ref(*args, z, None, first=True, theta=theta)
    for c1, c2 in steps:
        p, want = kref.cheby_step_ref(*args, want, p, first=False,
                                      theta=theta, c1=c1, c2=c2)
    if start == "zero":
        got = smooth(c["r"])
    elif start == "warm":
        got = smooth(c["r"], c["z"])
    else:
        got = smooth(c["r"], c["z"], c["zc"])
    assert torch.equal(got, want)


def test_factory_refuses_misuse():
    c, rho, _, _ = _factory_case(2)
    diag = 1.0 / c["inv_d"]
    make = lambda **kw: tvf.make_fused_chebyshev(  # noqa: E731
        c["idx"], c["val"], diag, rho, degree=2, **kw)
    with pytest.raises(ValueError, match="degree"):
        tvf.make_fused_chebyshev(c["idx"], c["val"], diag, rho, degree=0)
    with pytest.raises(ValueError, match="agg"):
        make()(c["r"], c["z"], c["zc"])          # no agg given
    with pytest.raises(ValueError, match="warm start"):
        make(agg=c["agg"])(c["r"], None, c["zc"])


# -- the wrappers' CPU route -------------------------------------------------------

@pytest.mark.parametrize("want_p", [False, True])
def test_wrappers_on_cpu_return_the_plain_versions(want_p):
    c = _problem(100, 3, 9, seed=11)
    args = (c["idx"], c["val"], c["inv_d"], c["r"])
    kw = dict(theta=THETA, c1=C1, c2=C2)
    before = tops.launch_counts()
    p, z = tvf.cheby_smooth_zero(*args, want_p=want_p, **kw)
    pr, zr = kref.cheby_smooth_zero_ref(*args, **kw)
    assert torch.equal(z, zr)
    assert (p is None) if not want_p else torch.equal(p, pr)
    for zc_agg in ((None, None), (c["zc"], c["agg"])):
        p, z1 = tvf.cheby_prolong_step(*args, c["z"], *zc_agg, theta=THETA)
        pr, zr = kref.cheby_prolong_step_ref(*args, c["z"], *zc_agg,
                                             theta=THETA)
        assert torch.equal(p, pr) and torch.equal(z1, zr)
    assert z1.device.type == "cpu"
    assert tops.launch_counts() == before


# -- against the JAX package --------------------------------------------------------

@pytest.fixture(scope="module")
def level0():
    """Level 0 of the reference's mesh12 hierarchy and its rho."""
    h = jbuild(jgraph.mesh2d(12, 12), config=jconfig(alpha=0.05, chunk=256))
    lev = h.levels[0]
    out = {k: np.array(getattr(lev, k)) for k in ("idx", "val", "diag",
                                                   "agg")}
    out["n_coarse"] = lev.n_coarse
    out["rho"] = jpcg.estimate_dinv_rho(
        jpcg.make_matvec(lev.idx, lev.val, "ref"), lev.diag)
    return out


@pytest.mark.parametrize("degree", [2, 3])
@pytest.mark.parametrize("k", [1, 4])
def test_smoother_with_prolongation_matches_reference(level0, degree, k):
    """The port's post-smooth from ``(z, zc)`` against the reference's
    fused smoother (interpret mode) and its plain smoother, each applied
    to ``z + zc[agg]``, within the tolerance of
    ``test_k2_smoother_matches_reference``."""
    lv = level0
    n = lv["idx"].shape[0]
    rng = np.random.default_rng(degree + 10 * k)
    r = rng.standard_normal((n, k)).astype(np.float32)
    r -= r.mean(axis=0)
    z = 0.1 * rng.standard_normal((n, k)).astype(np.float32)
    zc = 0.1 * rng.standard_normal((lv["n_coarse"], k)).astype(np.float32)
    warm = jnp.asarray(z) + jnp.asarray(zc)[jnp.asarray(lv["agg"])]
    idx, val, diag = (jnp.asarray(lv[k]) for k in ("idx", "val", "diag"))
    want_k = jvf.make_fused_chebyshev(idx, val, diag, lv["rho"],
                                      degree=degree, interpret=True)(
        jnp.asarray(r), warm)
    want_ref = jpcg.make_chebyshev_smoother(
        jpcg.make_matvec(idx, val, "ref"), diag, lv["rho"],
        degree=degree)(jnp.asarray(r), warm)
    ts = tvf.make_fused_chebyshev(
        *(torch.as_tensor(lv[k]) for k in ("idx", "val", "diag")), lv["rho"],
        degree=degree, agg=torch.as_tensor(lv["agg"]))
    got = ts(torch.as_tensor(r), torch.as_tensor(z), torch.as_tensor(zc))
    scale = max(float(np.abs(a).max()) for a in (r, lv["val"]))
    for want in (want_k, want_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * scale)


# -- the V-cycle's two routes ---------------------------------------------------------

NAMES = ["grid", "mesh", "ba", "ws", "star", "mesh12"]


@pytest.fixture(scope="module")
def hierarchies():
    graphs = dict(tgraph.suite("tiny"))
    graphs["mesh12"] = tgraph.mesh2d(12, 12)
    return {name: (graphs[name].n, thier.build_hierarchy(
        graphs[name], config=tconfig(alpha=0.05, chunk=256), device="cpu"))
        for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("k", [1, 3])
def test_vcycle_fused_equals_ref(hierarchies, name, k):
    """``make_vcycle``'s fused route (the prolongation inside K2's
    post-smooth) is ``torch.equal`` to the ``ref`` route (the gather and
    add, then the plain smoother)."""
    n, h = hierarchies[name]
    r = np.random.default_rng(len(name) + k).standard_normal((n, k))
    r = torch.as_tensor((r - r.mean(axis=0)).astype(np.float32))
    fused = tpcg.make_vcycle(h, matvec_impl="fused")
    plain = tpcg.make_vcycle(h, matvec_impl="ref")
    assert fused.rhos == plain.rhos
    assert torch.equal(fused(r), plain(r))
