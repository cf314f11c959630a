"""The port's solver (repro_torch.solver) held against the JAX package.

  * ``build_hierarchy``: ``agg`` and level sizes bit-identical, ``rho``
    rtol 1e-5.
  * ``make_solver`` on a hierarchy carried across with
    ``hierarchy_from_arrays`` and on the port's own hierarchy, against the
    reference's ``ref`` solver: per-column iterations within +-2 (the
    tolerance the reference uses between its planes), re-based x allclose
    (rtol 1e-3), relres <= tol.
  * ``matvec_impl="kernel"`` (K5 per column) against the reference's
    kernel route (+-2 iterations, re-based x rtol 1e-3) and against the
    port's ``"ref"`` route (+-0 iterations, bitwise x).
  * the batched-columns property (a column solved in a batch equals it
    solved alone, +-0 iterations), asserted on the port by itself.
  * the roofline's level shapes (``hierarchy_level_triples``,
    ``hierarchy_level_shapes``) of the port's hierarchy equal the
    reference's of its own.
Graphs: the tiny suite plus mesh2d(12, 12); both packages on the CPU.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import graph as jgraph  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.pipeline import pdgrass_config as jconfig  # noqa: E402
from repro.solver import device_pcg as jpcg  # noqa: E402
from repro.solver import hierarchy as jhier  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.pipeline import pdgrass_config as tconfig  # noqa: E402
from repro_torch.solver import device_pcg as tpcg  # noqa: E402
from repro_torch.solver import hierarchy as thier  # noqa: E402

NAMES = ["grid", "mesh", "ba", "ws", "star", "mesh12"]
TOL = 1e-5


def _suite(mod):
    g = dict(mod.suite("tiny"))
    g["mesh12"] = mod.mesh2d(12, 12)
    return g


JG, TG = _suite(jgraph), _suite(tgraph)


@pytest.fixture(scope="module")
def hierarchies():
    out = {}
    for name in NAMES:
        jh = jhier.build_hierarchy(JG[name],
                                   config=jconfig(alpha=0.05, chunk=256))
        th = thier.build_hierarchy(TG[name],
                                   config=tconfig(alpha=0.05, chunk=256),
                                   device="cpu")
        out[name] = (jh, th)
    return out


@pytest.fixture(scope="module")
def ref_solves(hierarchies):
    """The reference's ``ref`` solver on every graph: (b, result)."""
    out = {}
    for name in NAMES:
        jh, _ = hierarchies[name]
        b = _rhs(JG[name].n, 3, seed=7)
        idx, val = jpcg.ell_laplacian(JG[name])
        res = jpcg.make_solver(idx, val, hierarchy=jh, matvec_impl="ref")(
            jnp.asarray(b), tol=TOL)
        out[name] = (b, res)
    return out


def _rhs(n, k, seed):
    b = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    return b - b.mean(axis=0)


def _rebase(x):
    x = np.asarray(x.cpu() if torch.is_tensor(x) else x, dtype=np.float64)
    return x - x[0]


def _carry(jh):
    levels = [dict(n=lev.n, idx=np.asarray(lev.idx), val=np.asarray(lev.val),
                   diag=np.asarray(lev.diag), agg=np.asarray(lev.agg),
                   n_coarse=lev.n_coarse) for lev in jh.levels]
    return thier.hierarchy_from_arrays(levels, jh.coarse_n,
                                       np.asarray(jh.coarse_chol),
                                       device="cpu")


def _check_against_ref(res, want):
    it, it_ref = res.iters.numpy(), np.asarray(want.iters)
    assert np.all(np.abs(it.astype(int) - it_ref) <= 2), (it, it_ref)
    np.testing.assert_allclose(_rebase(res.x), _rebase(want.x), rtol=1e-3,
                               atol=1e-3 * np.abs(_rebase(want.x)).max())
    assert float(res.relres.max()) <= TOL
    assert bool(res.converged.all())


# -- hierarchy ---------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_hierarchy_agg_and_sizes_bit_identical(hierarchies, name):
    jh, th = hierarchies[name]
    assert th.level_sizes == jh.level_sizes
    for jl, tl in zip(jh.levels, th.levels):
        np.testing.assert_array_equal(tl.agg.numpy(), np.asarray(jl.agg))
        np.testing.assert_array_equal(tl.idx.numpy(), np.asarray(jl.idx))
        np.testing.assert_allclose(tl.val.numpy(), np.asarray(jl.val),
                                   rtol=1e-6)
        # the K3 CSR lists each aggregate's members in ascending order
        members = tl.perm.numpy()[tl.agg_ptr.numpy()[:-1]]
        assert np.all(tl.agg.numpy()[members] == np.arange(tl.n_coarse))


@pytest.mark.parametrize("name,coarse_n",
                         [(n, None) for n in NAMES] + [("mesh12", 16)])
def test_hierarchy_level_triples_equal_the_reference(hierarchies, name,
                                                     coarse_n):
    if coarse_n is None:
        jh, th = hierarchies[name]
    else:       # mesh2d(12, 12) down to 16 vertices: several levels
        jh = jhier.build_hierarchy(JG[name], coarse_n=coarse_n,
                                   config=jconfig(alpha=0.05, chunk=256))
        th = thier.build_hierarchy(TG[name], coarse_n=coarse_n,
                                   config=tconfig(alpha=0.05, chunk=256),
                                   device="cpu")
        assert len(th.levels) >= 2
    triples = troof.hierarchy_level_triples(th)
    assert triples == jroof.hierarchy_level_triples(jh)
    assert troof.hierarchy_level_shapes(th) == \
        jroof.hierarchy_level_shapes(jh)
    assert triples and all(isinstance(v, int) for t in triples for v in t)


def test_host_contraction_matches_device():
    g = TG["ba"]
    a = thier.build_hierarchy(g, config=tconfig(alpha=0.05, chunk=256),
                              device="cpu")
    b = thier.build_hierarchy(g, config=tconfig(alpha=0.05, chunk=256),
                              contraction="host", device="cpu")
    assert a.level_sizes == b.level_sizes
    for la, lb in zip(a.levels, b.levels):
        assert torch.equal(la.agg, lb.agg)


@pytest.mark.parametrize("name", NAMES)
def test_rho_matches_reference(hierarchies, name):
    jh, th = hierarchies[name]
    for jl, tl in zip(jh.levels, th.levels):
        want = jpcg.estimate_dinv_rho(jpcg.make_matvec(jl.idx, jl.val, "ref"),
                                      jl.diag)
        got = tpcg.estimate_dinv_rho(tpcg.make_matvec(tl.idx, tl.val, "ref"),
                                     tl.diag)
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_sharded_paths_raise():
    """The sharded paths are ported; they raise where the reference does:
    ``"sharded"`` without a mesh, the ``"kernel"`` route and the Jacobi
    preconditioner on a mesh."""
    with pytest.raises(ValueError, match="needs a mesh"):
        thier.build_hierarchy(TG["mesh12"], contraction="sharded",
                              device="cpu")
    idx, val = tpcg.ell_laplacian(TG["mesh12"], device="cpu")
    mesh = make_mesh((3,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="'ref' or 'fused'"):
        tpcg.make_solver(idx, val, precond="none", mesh=mesh,
                         matvec_impl="kernel", device="cpu")
    with pytest.raises(NotImplementedError, match="jacobi"):
        tpcg.make_solver(idx, val, precond="jacobi", mesh=mesh,
                         device="cpu")


# -- solves ------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_solver_on_carried_hierarchy_matches_reference(hierarchies,
                                                       ref_solves, name):
    jh, _ = hierarchies[name]
    b, want = ref_solves[name]
    idx, val = tpcg.ell_laplacian(TG[name], device="cpu")
    res = tpcg.make_solver(idx, val, _carry(jh), device="cpu")(b, tol=TOL)
    _check_against_ref(res, want)


@pytest.mark.parametrize("name", NAMES)
def test_slice_end_to_end_matches_reference(hierarchies, ref_solves, name):
    """The whole slice: the port's own hierarchy and solver, through both
    the plain route and the kernel route (plain versions on the CPU)."""
    _, th = hierarchies[name]
    b, want = ref_solves[name]
    idx, val = tpcg.ell_laplacian(TG[name], device="cpu")
    res = tpcg.make_solver(idx, val, th, device="cpu")(b, tol=TOL)
    _check_against_ref(res, want)
    fused = tpcg.make_solver(idx, val, th, matvec_impl="fused",
                             device="cpu")(b, tol=TOL)
    assert torch.equal(fused.iters, res.iters)
    assert torch.equal(fused.x, res.x)


@pytest.mark.parametrize("name", ["grid", "ba", "mesh12"])
def test_kernel_route_matches_reference_kernel_route(hierarchies, name):
    """``matvec_impl="kernel"`` (K5 per column; its plain version on the
    CPU) against the reference's kernel route (its Pallas spmv per column,
    interpret mode) on each package's own hierarchy: +-2 iterations,
    re-based x rtol 1e-3; and against the port's ``"ref"`` route: +-0
    iterations and bitwise x."""
    jh, th = hierarchies[name]
    b = _rhs(JG[name].n, 2, seed=9)
    jidx, jval = jpcg.ell_laplacian(JG[name])
    want = jpcg.make_solver(jidx, jval, hierarchy=jh, matvec_impl="kernel")(
        jnp.asarray(b), tol=TOL)
    idx, val = tpcg.ell_laplacian(TG[name], device="cpu")
    res = tpcg.make_solver(idx, val, th, matvec_impl="kernel",
                           device="cpu")(b, tol=TOL)
    _check_against_ref(res, want)
    plain = tpcg.make_solver(idx, val, th, matvec_impl="ref",
                             device="cpu")(b, tol=TOL)
    assert torch.equal(res.iters, plain.iters)
    assert torch.equal(res.x, plain.x)


def test_kernel_matvec_stacks_one_column_at_a_time():
    idx, val = tpcg.ell_laplacian(TG["ba"], device="cpu")
    x = torch.as_tensor(_rhs(TG["ba"].n, 3, seed=2))
    y = tpcg.make_matvec(idx, val, "kernel")(x)
    assert torch.equal(y, tpcg.make_matvec(idx, val, "fused")(x))
    assert torch.equal(y, tpcg.make_matvec(idx, val, "ref")(x))
    with pytest.raises(ValueError, match="unknown matvec impl"):
        tpcg.make_matvec(idx, val, "pallas")


@pytest.mark.parametrize("precond", ["none", "hierarchy"])
def test_batched_columns_match_single_solves(precond):
    """Each column of a batched solve equals its solo solve (x and +-0
    iterations): column sums fold rows in a fixed order, whatever k is."""
    g = tgraph.mesh2d(13, 13, seed=5)
    idx, val = tpcg.ell_laplacian(g, device="cpu")
    hier = (thier.build_hierarchy(g, alpha=0.05, device="cpu")
            if precond == "hierarchy" else None)
    solve = tpcg.make_solver(idx, val, hier, precond=precond, device="cpu")
    B = _rhs(g.n, 5, seed=6)
    res = solve(B, tol=1e-5, maxiter=5000)
    for j in range(B.shape[1]):
        one = solve(B[:, j:j + 1], tol=1e-5, maxiter=5000)
        np.testing.assert_allclose(_rebase(res.x[:, j]),
                                   _rebase(one.x[:, 0]), atol=1e-3)
        assert int(res.iters[j]) == int(one.iters[0])


def test_jacobi_and_plain_pcg_converge():
    g = TG["mesh12"]
    idx, val = tpcg.ell_laplacian(g, device="cpu")
    b = _rhs(g.n, 2, seed=3)
    for precond in ("jacobi", "none"):
        res = tpcg.make_solver(idx, val, precond=precond, device="cpu")(
            b, tol=TOL, maxiter=5000)
        assert bool(res.converged.all())


# -- devices -----------------------------------------------------------------

def test_entry_points_default_to_cuda():
    for fn in (thier.build_hierarchy, thier.hierarchy_from_arrays,
               tpcg.make_solver, tpcg.ell_laplacian):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert tpcg.default_matvec_impl("cuda") == "fused"
    assert tpcg.default_matvec_impl("cpu") == "ref"


def test_cpu_run_stays_on_cpu(hierarchies):
    _, th = hierarchies["mesh12"]
    tensors = [th.coarse_chol] + [t for lev in th.levels for t in
                                  (lev.idx, lev.val, lev.diag, lev.agg,
                                   lev.perm, lev.agg_ptr)]
    assert all(t.device.type == "cpu" for t in tensors)
    idx, val = tpcg.ell_laplacian(TG["mesh12"], device="cpu")
    res = tpcg.make_solver(idx, val, th, device="cpu")(
        _rhs(TG["mesh12"].n, 2, seed=1))
    assert all(t.device.type == "cpu" for t in res)
