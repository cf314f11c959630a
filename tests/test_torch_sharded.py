"""The port's sharded planes (repro_torch.solver.sharded, the sharded
contraction, ``SolverService(mesh=...)``) held against the JAX package.

The reference's own sharded plane does not run with this container's JAX
(``shard_map``'s ``check_vma``, ROADMAP queue 3), so the port is held
against the reference's single-device paths, the equalities the
reference's sharded tests assert:

  * ``shard_ell_slabs`` bitwise equal to the reference's at 1, 3 and 8
    shards (the reference function is host numpy);
  * the sharded contraction's ``agg`` and level sizes bitwise equal to the
    reference's ``device_contract`` at every level, on mesh2d(16, 16) and
    barabasi_albert(300, 3);
  * the sharded solve against the reference's single-device
    ``make_solver``: +-2 iterations, re-based x within atol 1e-4; also
    with ``precond="none"`` on mesh2d(12, 12).
On the port alone: a batched column equals its solo solve, a 1-shard mesh
gives the single-device bits, the service over a mesh keys apart from a
single-device one, and the reference's refusals.  All on the CPU, with an
8-shard mesh.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import graph as jgraph  # noqa: E402
from repro.pipeline import pdgrass_config as jconfig  # noqa: E402
from repro.solver import device_pcg as jpcg  # noqa: E402
from repro.solver import hierarchy as jhier  # noqa: E402
from repro.solver import sharded as jsharded  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.pipeline import pdgrass_config as tconfig  # noqa: E402
from repro_torch.serve import SolverDaemon  # noqa: E402
from repro_torch.solver import (SolveRequest, SolverService,  # noqa: E402
                                build_hierarchy, ell_laplacian, make_solver)
from repro_torch.solver import sharded as tsharded  # noqa: E402

CHUNK = 256
MESH8 = make_mesh((8,), ("data",), device="cpu")
GRAPHS = {
    "mesh2d-16": ("mesh2d", (16, 16), {"seed": 0}),
    "ba-300": ("barabasi_albert", (300, 3), {"seed": 1}),
}


def _graph(mod, name):
    fn, args, kw = GRAPHS[name]
    return getattr(mod, fn)(*args, **kw)


def _rhs(n, k, seed):
    b = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    return b - b.mean(axis=0)


def _rebase(x):
    x = np.asarray(x.cpu() if torch.is_tensor(x) else x, dtype=np.float64)
    return x - x[0]


@pytest.fixture(scope="module")
def built():
    """name -> (reference device-contracted hierarchy, port hierarchy
    contracted over the 8-shard mesh)."""
    out = {}
    for name in GRAPHS:
        jh = jhier.build_hierarchy(_graph(jgraph, name),
                                   config=jconfig(alpha=0.05, chunk=CHUNK),
                                   contraction="device")
        th = build_hierarchy(_graph(tgraph, name),
                             config=tconfig(alpha=0.05, chunk=CHUNK),
                             contraction="sharded", mesh=MESH8, device="cpu")
        out[name] = (jh, th)
    return out


@pytest.mark.parametrize("n_sh", [1, 3, 8])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_shard_ell_slabs_matches_reference(n_sh, name):
    idx, val = ell_laplacian(_graph(tgraph, name), device="cpu")
    got, got_meta = tsharded.shard_ell_slabs(idx, val, n_sh)
    want, want_meta = jsharded.shard_ell_slabs(idx.numpy(), val.numpy(),
                                               n_sh)
    assert tuple(got_meta) == tuple(want_meta)
    for field in ("idx", "val", "halo"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_sharded_contraction_matches_reference_device(built, name):
    jh, th = built[name]
    assert th.level_sizes == jh.level_sizes
    for jl, tl in zip(jh.levels, th.levels):
        np.testing.assert_array_equal(tl.agg.numpy(), np.asarray(jl.agg))
        assert tl.stats["contraction"] == "sharded"


@pytest.mark.parametrize("name", list(GRAPHS))
def test_sharded_solve_matches_reference_single_device(built, name):
    jh, th = built[name]
    g = _graph(tgraph, name)
    b = _rhs(g.n, 4, seed=7)
    idx, val = ell_laplacian(g, device="cpu")
    got = make_solver(idx, val, th, mesh=MESH8, device="cpu")(b, tol=1e-5)
    jidx, jval = jpcg.ell_laplacian(_graph(jgraph, name))
    want = jpcg.make_solver(jidx, jval, hierarchy=jh, matvec_impl="ref")(
        jnp.asarray(b), tol=1e-5)
    d_it = np.abs(got.iters.numpy().astype(int) - np.asarray(want.iters))
    assert d_it.max() <= 2, (got.iters, want.iters)
    np.testing.assert_allclose(_rebase(got.x), _rebase(want.x), atol=1e-4)
    assert bool(got.converged.all()) and float(got.relres.max()) <= 1e-5


def test_sharded_unpreconditioned_matches_reference():
    g = tgraph.mesh2d(12, 12, seed=3)
    b = _rhs(g.n, 2, seed=9)
    idx, val = ell_laplacian(g, device="cpu")
    got = make_solver(idx, val, precond="none", mesh=MESH8,
                      device="cpu")(b, tol=1e-5)
    jidx, jval = jpcg.ell_laplacian(jgraph.mesh2d(12, 12, seed=3))
    want = jpcg.make_solver(jidx, jval, precond="none", matvec_impl="ref")(
        jnp.asarray(b), tol=1e-5)
    d_it = np.abs(got.iters.numpy().astype(int) - np.asarray(want.iters))
    assert d_it.max() <= 2, (got.iters, want.iters)
    np.testing.assert_allclose(_rebase(got.x), _rebase(want.x), atol=1e-4)


def test_sharded_batched_column_equals_solo(built):
    _, th = built["mesh2d-16"]
    g = _graph(tgraph, "mesh2d-16")
    idx, val = ell_laplacian(g, device="cpu")
    solve = make_solver(idx, val, th, mesh=MESH8, device="cpu")
    b = _rhs(g.n, 3, seed=11)
    batch = solve(b, tol=1e-5)
    for j in range(3):
        solo = solve(b[:, j:j + 1], tol=1e-5)
        assert torch.equal(solo.x[:, 0], batch.x[:, j])
        assert int(solo.iters[0]) == int(batch.iters[j])


def test_one_shard_gives_the_single_device_bits(built):
    _, th = built["ba-300"]
    g = _graph(tgraph, "ba-300")
    idx, val = ell_laplacian(g, device="cpu")
    b = _rhs(g.n, 2, seed=5)
    one = make_solver(idx, val, th, mesh=make_mesh((1,), ("data",), "cpu"),
                      device="cpu")(b, tol=1e-5)
    single = make_solver(idx, val, th, matvec_impl="ref",
                         device="cpu")(b, tol=1e-5)
    assert torch.equal(one.x, single.x)
    assert torch.equal(one.iters, single.iters)


def test_service_over_a_mesh_end_to_end():
    cfg = tconfig(alpha=0.05, chunk=CHUNK)
    g = _graph(tgraph, "mesh2d-16")
    svc = SolverService(pipeline=cfg, mesh=MESH8, device="cpu")
    single = SolverService(pipeline=cfg, device="cpu")
    h = svc.register(g)
    single.register(h)
    assert svc.contraction == "sharded"
    assert svc._key(h, cfg) != single._key(h, cfg)
    stats = svc.stats()
    assert stats["mesh"]["descriptor"] == ("mesh", "data", 8)
    assert stats["hierarchy"]["contraction"] == "sharded"
    b = _rhs(g.n, 4, seed=7)
    first = svc.solve(h, b)
    assert first.cache == "miss" and first.converged
    assert svc.solve(h, b).cache == "mem"
    want = single.solve(h, b)
    assert np.abs(np.asarray(first.iters, int)
                  - np.asarray(want.iters, int)).max() <= 2
    np.testing.assert_allclose(_rebase(first.x), _rebase(want.x), atol=1e-4)
    # the daemon runs over a mesh service unchanged
    with SolverDaemon(svc, max_batch_delay_ms=5.0) as d:
        res = d.submit(SolveRequest(graph=h, b=b[:, :1])).result(timeout=60)
    assert res.converged and res.cache == "mem"


def test_reference_refusals():
    g = tgraph.mesh2d(8, 8, seed=0)
    idx, val = ell_laplacian(g, device="cpu")
    with pytest.raises(ValueError, match="'ref' or 'fused'"):
        make_solver(idx, val, precond="none", mesh=MESH8,
                    matvec_impl="kernel", device="cpu")
    with pytest.raises(NotImplementedError, match="jacobi"):
        make_solver(idx, val, precond="jacobi", mesh=MESH8, device="cpu")
    with pytest.raises(NotImplementedError, match="jacobi"):
        SolverService(alpha=0.05, precond="jacobi", mesh=MESH8, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        build_hierarchy(g, contraction="sharded", device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        SolverService(alpha=0.05, contraction="sharded", device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        SolverService(alpha=0.05, mesh=make_mesh((8,), ("data",), "cuda"),
                      device="cpu")
