"""The port's build half (repro_torch core + pipeline) held against the JAX
package on the tiny suite plus mesh2d(12, 12).

Integer and boolean outputs must be bit-identical: graphs, the tree mask,
parent, depth, the lifting ``up`` table, ancestor signatures, subtask ids,
recovery status (both engines' routes, K4's included), the
recovered/sparsifier masks and the feGRASS masks; ``quality_iters`` equal.
Scores rtol 1e-6; the dense PCG +-2 iterations.
Both packages run on the CPU; inputs cross as numpy arrays.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import graph as jgraph  # noqa: E402
from repro.core import graph_ops as jops  # noqa: E402
from repro.core import pcg as jpcg  # noqa: E402
from repro.core import recovery as jrec  # noqa: E402
from repro.core.fegrass import fegrass as jfegrass  # noqa: E402
from repro.pipeline import Pipeline as JPipeline  # noqa: E402
from repro.pipeline import pdgrass_config as jconfig  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import graph_ops as tops  # noqa: E402
from repro_torch.core import pcg as tpcg  # noqa: E402
from repro_torch.core import recovery as trec  # noqa: E402
from repro_torch.core.fegrass import fegrass as tfegrass  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.pipeline import Pipeline as TPipeline  # noqa: E402
from repro_torch.pipeline import pdgrass_config as tconfig  # noqa: E402

NAMES = ["grid", "mesh", "ba", "ws", "star", "mesh12"]
CHUNK = 256


def _suite(mod):
    g = dict(mod.suite("tiny"))
    g["mesh12"] = mod.mesh2d(12, 12)
    return g


@pytest.fixture(scope="module")
def graphs():
    return _suite(jgraph), _suite(tgraph)


@pytest.fixture(scope="module")
def prepared(graphs):
    jg, tg = graphs
    out = {}
    for name in NAMES:
        jp = JPipeline(jconfig(alpha=0.05, chunk=CHUNK)).prepare(jg[name])
        tp = TPipeline(tconfig(alpha=0.05, chunk=CHUNK)).prepare(
            tg[name], device="cpu")
        out[name] = (jp, tp)
    return out


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("name", NAMES)
def test_graph_generators_are_array_identical(graphs, name):
    a, b = graphs[0][name], graphs[1][name]
    assert a.n == b.n
    for f in ("src", "dst", "weight", "indptr", "adj", "adj_w", "adj_edge"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("name", NAMES)
def test_tree_and_lifting_bit_identical(prepared, name):
    jp, tp = prepared[name]
    for f in ("in_tree", "parent", "depth", "parent_w"):
        np.testing.assert_array_equal(_np(getattr(tp.tree, f)),
                                      _np(getattr(jp.tree, f)), err_msg=f)
    np.testing.assert_array_equal(_np(tp.lift.up), _np(jp.lift.up))
    np.testing.assert_allclose(_np(tp.lift.rw), _np(jp.lift.rw), rtol=1e-6)
    for f in ("sig_u", "sig_v", "beta", "seg"):
        np.testing.assert_array_equal(_np(getattr(tp.problem, f)),
                                      _np(getattr(jp.problem, f)), err_msg=f)
    np.testing.assert_array_equal(tp.off_edge_id, jp.off_edge_id)
    np.testing.assert_allclose(_np(tp.problem.score), _np(jp.problem.score),
                               rtol=1e-6)
    assert tp.n_subtasks == jp.n_subtasks


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("stop", [False, True])
def test_recover_rounds_status_bit_identical(prepared, graphs, name, stop):
    jp, tp = prepared[name]
    target = int(np.ceil(0.05 * graphs[0][name].n)) if stop else 2**31 - 1
    js, jst = jrec.recover_rounds(jp.problem, target, stop_at_target=stop,
                                  chunk=CHUNK)
    ts, tst = trec.recover_rounds(tp.problem, target, stop_at_target=stop,
                                  chunk=CHUNK)
    np.testing.assert_array_equal(_np(ts), _np(js))
    assert (tst.rounds, tst.candidates, tst.killed_in_block) == (
        int(jst.rounds), int(jst.candidates), int(jst.killed_in_block))
    if not stop:  # the round engine equals the serial oracle
        np.testing.assert_array_equal(_np(ts), trec.recover_serial(tp.problem))


@pytest.mark.parametrize("name", NAMES)
def test_sparsifier_masks_bit_identical(graphs, prepared, name):
    jg, tg = graphs
    jp, tp = prepared[name]
    js = JPipeline(jconfig(alpha=0.05, chunk=CHUNK)).run(jg[name],
                                                         prepared=jp)
    ts = TPipeline(tconfig(alpha=0.05, chunk=CHUNK)).run(tg[name],
                                                         prepared=tp)
    np.testing.assert_array_equal(ts.tree_mask, js.tree_mask)
    np.testing.assert_array_equal(ts.recovered_mask, js.recovered_mask)
    np.testing.assert_array_equal(ts.edge_mask, js.edge_mask)
    assert ts.stats["rounds"] == js.stats["rounds"]


# -- the K4 route of the round engine ----------------------------------------

def test_k4_engine_matches_reference_and_serial():
    """The reference's kernel-route test graph (``test_recovery.py:148``):
    without a target, the K4 route equals the reference's K4 route (its
    Pallas kernel in interpret mode), the serial oracle and the default
    route, status and stats."""
    jp = JPipeline(jconfig(chunk=256)).prepare(
        jgraph.barabasi_albert(300, 3, seed=3))
    tp = TPipeline(tconfig(chunk=256)).prepare(
        tgraph.barabasi_albert(300, 3, seed=3), device="cpu")
    kw = dict(block_size=16, max_candidates=64, stop_at_target=False,
              chunk=256)
    js, jst = jrec.recover_rounds(jp.problem, use_kernel=True, **kw)
    ts, tst = trec.recover_rounds(tp.problem, use_kernel=True, **kw)
    td, tdst = trec.recover_rounds(tp.problem, **kw)
    np.testing.assert_array_equal(_np(ts), _np(js))
    np.testing.assert_array_equal(_np(ts), trec.recover_serial(tp.problem))
    assert torch.equal(ts, td) and tst == tdst
    assert (tst.rounds, tst.candidates, tst.killed_in_block) == (
        int(jst.rounds), int(jst.candidates), int(jst.killed_in_block))


def test_k4_engine_matches_reference_at_target(prepared, graphs):
    jp, tp = prepared["mesh12"]
    target = int(np.ceil(0.05 * graphs[0]["mesh12"].n))
    js, jst = jrec.recover_rounds(jp.problem, target, stop_at_target=True,
                                  chunk=CHUNK, use_kernel=True)
    ts, tst = trec.recover_rounds(tp.problem, target, stop_at_target=True,
                                  chunk=CHUNK, use_kernel=True)
    td, tdst = trec.recover_rounds(tp.problem, target, stop_at_target=True,
                                   chunk=CHUNK)
    np.testing.assert_array_equal(_np(ts), _np(js))
    assert torch.equal(ts, td) and tst == tdst
    assert tst.rounds == int(jst.rounds)


def test_default_route_on_cpu_is_the_chunked_pass(prepared, graphs,
                                                  monkeypatch):
    """On a CPU problem ``recover_rounds`` marks through the chunked pass
    unless asked: K4's entry point is not called (and counts no launch),
    and the status and stats equal ``use_kernel=False`` and the K4 route
    bit for bit."""
    _, tp = prepared["mesh12"]
    target = int(np.ceil(0.05 * graphs[1]["mesh12"].n))
    calls = []
    mark = kops.similarity_mark

    def spy(*args, **kw):
        calls.append(1)
        return mark(*args, **kw)

    monkeypatch.setattr(kops, "similarity_mark", spy)
    before = kops.launch_counts()
    run = lambda **kw: trec.recover_rounds(tp.problem, target,
                                           stop_at_target=True, chunk=CHUNK,
                                           **kw)
    td, tdst = run()
    assert calls == [] and kops.launch_counts() == before
    tc, tcst = run(use_kernel=False)
    assert calls == [] and torch.equal(td, tc) and tdst == tcst
    tk, tkst = run(use_kernel=True)
    assert len(calls) == tkst.rounds and torch.equal(td, tk) and tkst == tdst
    assert kops.launch_counts() == before


# -- feGRASS baseline and the quality metric ---------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_fegrass_masks_and_stats_bit_identical(graphs, prepared, name):
    jg, tg = graphs
    jp, tp = prepared[name]
    js = jfegrass(jg[name], alpha=0.05, prepared=jp)
    ts = tfegrass(tg[name], alpha=0.05, prepared=tp, device="cpu")
    np.testing.assert_array_equal(ts.tree_mask, js.tree_mask)
    np.testing.assert_array_equal(ts.recovered_mask, js.recovered_mask)
    assert ts.stats == js.stats


def test_fegrass_multipass_on_a_hub_graph_matches_reference():
    """The multi-pass pathology the paper removes: on a hub graph feGRASS
    needs several passes, pdGRASS one; the port counts the same."""
    jg = jgraph.star_hub(400, extra=300, seed=10)
    tg = tgraph.star_hub(400, extra=300, seed=10)
    js = jfegrass(jg, alpha=0.10)
    ts = tfegrass(tg, alpha=0.10, device="cpu")
    np.testing.assert_array_equal(ts.recovered_mask, js.recovered_mask)
    assert ts.stats == js.stats and ts.stats["passes"] > 3
    pd = TPipeline(tconfig(alpha=0.10)).run(tg, device="cpu")
    assert pd.stats["passes"] == 1
    assert pd.stats["n_recovered"] >= ts.stats["n_recovered"]


@pytest.mark.parametrize("name", ["mesh", "ba", "mesh12"])
def test_quality_iters_equal_reference(graphs, prepared, name):
    jg, tg = graphs
    jp, tp = prepared[name]
    js = JPipeline(jconfig(alpha=0.05, chunk=CHUNK)).run(jg[name],
                                                         prepared=jp)
    ts = TPipeline(tconfig(alpha=0.05, chunk=CHUNK)).run(tg[name],
                                                         prepared=tp)
    assert tpcg.quality_iters(tg[name], ts) == jpcg.quality_iters(jg[name],
                                                                  js)


@pytest.mark.parametrize("precond", [False, True])
def test_pcg_torch_matches_pcg_jax(graphs, prepared, precond):
    """Dense PCG on the grounded mesh12 Laplacian, float32 in both: +-2
    iterations, relres <= tol."""
    jg, tg = graphs
    g = tg["mesh12"]
    L = g.laplacian().toarray()[1:, 1:]
    b = np.random.default_rng(4).standard_normal(g.n - 1)
    chol = None
    if precond:
        sp = TPipeline(tconfig(alpha=0.10, chunk=CHUNK)).run(
            g, prepared=prepared["mesh12"][1])
        chol = np.linalg.cholesky(sp.laplacian().toarray()[1:, 1:])
    tx, tit, trel = tpcg.pcg_torch(
        torch.as_tensor(L, dtype=torch.float32),
        torch.as_tensor(b, dtype=torch.float32),
        None if chol is None else torch.as_tensor(chol, dtype=torch.float32),
        tol=1e-5, maxiter=2000)
    jx, jit, jrel = jpcg.pcg_jax(
        jnp.asarray(L, jnp.float32), jnp.asarray(b, jnp.float32),
        None if chol is None else jnp.asarray(chol, jnp.float32),
        tol=1e-5, maxiter=2000)
    assert abs(tit - int(jit)) <= 2
    assert float(trel) <= 1e-5 and float(jrel) <= 1e-5
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-3,
                               atol=1e-3 * float(np.abs(np.asarray(jx)).max()))


def test_pcg_host_is_the_reference_copy(graphs):
    g = graphs[1]["grid"]
    b = np.random.default_rng(0).standard_normal(g.n)
    b -= b.mean()
    t = tpcg.pcg_host(g.laplacian(), b, tol=1e-8, maxiter=5000)
    j = jpcg.pcg_host(graphs[0]["grid"].laplacian(), b, tol=1e-8,
                      maxiter=5000)
    assert t.converged and t.iters == j.iters
    np.testing.assert_array_equal(t.x, j.x)


@pytest.mark.parametrize("kind", ["er_sample", "er_exact"])
def test_unported_score_stages_raise(graphs, kind):
    """``er_sample`` and ``er_exact`` were the score stages left to port;
    they are ported, so neither raises: each runs on mesh12 and recovers
    the reference's edges (the full parity tests are in
    ``tests/test_torch_spectral.py``)."""
    got = TPipeline(tconfig(alpha=0.05, chunk=CHUNK, score_mode=kind)).run(
        graphs[1]["mesh12"], device="cpu")
    want = JPipeline(jconfig(alpha=0.05, chunk=CHUNK, score_mode=kind)).run(
        graphs[0]["mesh12"])
    assert got.stats["n_recovered"] > 0
    np.testing.assert_array_equal(got.recovered_mask,
                                  np.asarray(want.recovered_mask))


@pytest.mark.parametrize("engine", ["distributed"])
def test_unported_engines_raise(graphs, engine):
    """Every engine is ported now, so none raises: ``distributed`` without
    a mesh runs on a 1-shard mesh on the problem's device and recovers the
    reference engine's edges (the 8-shard parity tests are in
    ``tests/test_torch_distributed.py``); a mesh on another device than
    the problem's is refused."""
    cfg = tconfig(alpha=0.05, chunk=CHUNK, engine=engine)
    got = TPipeline(cfg).run(graphs[1]["mesh12"], device="cpu")
    want = JPipeline(jconfig(alpha=0.05, chunk=CHUNK, engine=engine)).run(
        graphs[0]["mesh12"])
    assert got.stats["n_shards"] == 1 and got.stats["n_recovered"] > 0
    np.testing.assert_array_equal(got.recovered_mask,
                                  np.asarray(want.recovered_mask))
    from repro_torch.launch import make_mesh
    with pytest.raises(ValueError, match="mesh"):
        TPipeline(cfg).run(graphs[1]["mesh12"], device="cpu",
                           mesh=make_mesh((2,), ("data",), device="cuda"))


def test_serial_engine_matches_rounds_without_target(graphs):
    g = graphs[1]["ba"]
    a = TPipeline(tconfig(alpha=0.05, chunk=CHUNK, engine="serial",
                          stop_at_target=False)).run(g, device="cpu")
    b = TPipeline(tconfig(alpha=0.05, chunk=CHUNK,
                          stop_at_target=False)).run(g, device="cpu")
    np.testing.assert_array_equal(a.edge_mask, b.edge_mask)


# -- graph_ops primitives ----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_argmax_matches_reference(seed):
    rng = np.random.default_rng(seed)
    k, ns = 400, 37
    vals = rng.integers(0, 6, k).astype(np.float32)  # many ties
    vals[rng.random(k) < 0.1] = -np.inf
    segs = rng.integers(-2, ns + 2, k).astype(np.int32)  # out-of-range too
    jp, jb = jops.segment_argmax(jnp.asarray(vals), jnp.asarray(segs), ns)
    tp, tb = tops.segment_argmax(torch.as_tensor(vals),
                                 torch.as_tensor(segs), ns)
    np.testing.assert_array_equal(_np(tp), _np(jp))
    np.testing.assert_array_equal(_np(tb), _np(jb))


@pytest.mark.parametrize("name", ["ba", "star", "mesh12"])
def test_matching_and_coalesce_match_reference(graphs, name):
    jg, tg = graphs[0][name], graphs[1][name]
    args = (jg.n, jnp.asarray(jg.src), jnp.asarray(jg.dst),
            jnp.asarray(jg.weight))
    targs = (tg.n, torch.as_tensor(tg.src), torch.as_tensor(tg.dst),
             torch.as_tensor(tg.weight))
    jm = jops.propose_accept_matching(*args)
    tm = tops.propose_accept_matching(*targs)
    np.testing.assert_array_equal(_np(tm), _np(jm))
    labels = np.where(_np(jm) >= 0, np.minimum(np.arange(jg.n), _np(jm)),
                      np.arange(jg.n)).astype(np.int32)
    jc = jops.coalesce_edges(*args[1:], jnp.asarray(labels), jg.n)
    tc = tops.coalesce_edges(*targs[1:], torch.as_tensor(labels), tg.n)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(_np(a), _np(b))
    jd, jk = jops.compact_labels(jnp.asarray(labels), jg.n)
    td, tk = tops.compact_labels(torch.as_tensor(labels), tg.n)
    np.testing.assert_array_equal(_np(td), _np(jd))
    assert int(tk) == int(jk)


def test_pointer_jump_matches_reference():
    rng = np.random.default_rng(3)
    n = 500
    parent = np.arange(n)
    for v in range(1, n):  # a random forest, parents below children
        if rng.random() < 0.9:
            parent[v] = rng.integers(0, v)
    parent = parent.astype(np.int32)
    np.testing.assert_array_equal(
        _np(tops.pointer_jump(torch.as_tensor(parent))),
        _np(jops.pointer_jump(jnp.asarray(parent))))


# -- the port stands alone ---------------------------------------------------

def test_port_imports_without_jax():
    """Every module of repro_torch imports with jax (and repro) blocked."""
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.')\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=src, timeout=120,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
