"""The port's spectral services (repro_torch.spectral) and the score stage
``er_sample``, against the JAX reference and exact host f64 oracles, on
the CPU.

At the reference tests' sizes (``tests/test_spectral.py``: mesh2d(8, 8),
grid2d(7, 6)) and bars:

  * effective resistances within 1e-4 relative of the dense pinv and of
    the reference's, in one scheduler group per (graph, config), replayed
    from the content-keyed cache;
  * the Fiedler pair and k = 3 embeddings against ``numpy.linalg.eigh``
    and the reference (eigenvalues rtol 1e-3, |cos| >= 1 - 1e-3, residual
    <= 1e-3);
  * harmonic interpolation within 1e-6 of the dense Schur-complement
    solve and of the reference, label propagation's classes equal;
  * ``er_sample``: the noise bits equal ``jax.random.bits`` exactly, the
    Gumbel values within the log ULP of ``jax.random.gumbel`` (2 ** -20
    absolute at these magnitudes), and the recovered masks equal on the
    suite graphs (``suite("tiny")``).

The ``er_exact`` stage has its own file, ``tests/test_torch_er_exact.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.pipeline import Pipeline as JPipeline  # noqa: E402
from repro.pipeline import pdgrass_config as jpdgrass_config  # noqa: E402
from repro.solver import SolverService as JSolverService  # noqa: E402
from repro import spectral as jspectral  # noqa: E402
from repro_torch.core import Graph, mesh2d, suite  # noqa: E402
from repro_torch.obs import get_metrics, get_tracer  # noqa: E402
from repro_torch.pipeline import (Pipeline, ScoreConfig,  # noqa: E402
                                  pdgrass_config)
from repro_torch.pipeline import stages  # noqa: E402
from repro_torch.serve import SolverDaemon  # noqa: E402
from repro_torch.solver import SolverService  # noqa: E402
from repro_torch.spectral import (ResistanceCache,  # noqa: E402
                                  effective_resistance, fiedler_vector,
                                  harmonic_interpolate, label_propagation,
                                  spectral_embedding)


def _dense_lap(g: Graph) -> np.ndarray:
    L = np.zeros((g.n, g.n))
    for s, d, w in zip(g.src, g.dst, g.weight):
        L[s, s] += w
        L[d, d] += w
        L[s, d] -= w
        L[d, s] -= w
    return L


def _pinv_resistances(L: np.ndarray, pairs: np.ndarray) -> np.ndarray:
    P = np.linalg.pinv(L)
    u, v = pairs[:, 0], pairs[:, 1]
    return P[u, u] + P[v, v] - 2 * P[u, v]


def _pairs(n: int, q: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, 3 * q)
    v = rng.integers(0, n, 3 * q)
    keep = u != v
    return np.stack([u[keep], v[keep]], axis=1)[:q]


@pytest.fixture(scope="module")
def svc():
    service = SolverService(alpha=0.1, device="cpu")
    g = mesh2d(8, 8, seed=0)
    return service, service.register(g), g


@pytest.fixture(scope="module")
def jsvc():
    service = JSolverService(alpha=0.1)
    g = jgraph.mesh2d(8, 8, seed=0)
    return service, service.register(g), g


# -- effective resistance ------------------------------------------------------

def test_resistance_matches_pinv_and_reference(svc, jsvc):
    service, h, g = svc
    pairs = _pairs(g.n, 24, seed=1)
    r = effective_resistance(service, h, pairs, tol=1e-7,
                             cache=ResistanceCache())
    r_exact = _pinv_resistances(_dense_lap(g), pairs)
    assert (np.abs(r - r_exact) / r_exact).max() <= 1e-4
    r_ref = jspectral.effective_resistance(
        jsvc[0], jsvc[1], pairs, tol=1e-7,
        cache=jspectral.ResistanceCache())
    np.testing.assert_allclose(r, r_ref, rtol=1e-4)


def test_batched_queries_use_one_flush_group_and_cache(svc):
    service, h, g = svc
    pairs = _pairs(g.n, 40, seed=2)
    cache = ResistanceCache()
    before = service.stats()["scheduler"]["groups"]
    solved0 = service.metrics.snapshot().get(
        "spectral.resistance.solved_columns", 0)
    r = effective_resistance(service, h, pairs, tol=1e-6, chunk=8,
                             cache=cache)
    assert service.stats()["scheduler"]["groups"] - before == 1
    assert cache.misses == len(pairs)
    solved = service.metrics.snapshot()["spectral.resistance.solved_columns"]
    assert solved - solved0 == len(np.unique(pairs.min(1) * g.n
                                             + pairs.max(1)))
    r2 = effective_resistance(service, h, pairs, tol=1e-6, cache=cache)
    assert np.array_equal(r, r2)
    assert cache.hits >= len(pairs)
    assert service.metrics.snapshot()[
        "spectral.resistance.solved_columns"] == solved
    r3 = effective_resistance(service, h, pairs[:, ::-1], tol=1e-6,
                              cache=cache)
    assert np.array_equal(r, r3)


def test_resistance_rejects_malformed_pairs(svc):
    service, h, _ = svc
    with pytest.raises(ValueError, match="pairs"):
        effective_resistance(service, h, np.zeros((3, 4)))
    with pytest.raises(ValueError, match="vertex ids"):
        effective_resistance(service, h, np.array([[0, h.n]]))


# -- spectral embeddings -------------------------------------------------------

def test_fiedler_matches_eigh_and_reference(svc, jsvc):
    service, h, g = svc
    lam2, vec = fiedler_vector(service, h, tol=1e-4)
    L = _dense_lap(g)
    w, V = np.linalg.eigh(L)
    assert abs(lam2 - w[1]) <= 1e-3 * abs(w[1])
    assert abs(float(vec @ V[:, 1])) >= 1 - 1e-3
    assert np.linalg.norm(L @ vec - lam2 * vec) / np.linalg.norm(vec) <= 1e-3
    assert abs(vec.mean()) <= 1e-5
    lam_ref, vec_ref = jspectral.fiedler_vector(jsvc[0], jsvc[1], tol=1e-4)
    assert abs(lam2 - lam_ref) <= 1e-3 * abs(lam_ref)
    assert abs(float(vec @ vec_ref)) >= 1 - 1e-3


def test_k3_embedding_matches_eigh_and_reference(svc, jsvc):
    service, h, g = svc
    emb = spectral_embedding(service, h, k=3, tol=1e-4)
    w = np.linalg.eigvalsh(_dense_lap(g))
    assert emb.converged
    np.testing.assert_allclose(emb.values, w[1:4], rtol=1e-3)
    np.testing.assert_allclose(emb.vectors.T @ emb.vectors, np.eye(3),
                               atol=1e-5)
    np.testing.assert_allclose(emb.vectors.mean(axis=0), 0, atol=1e-5)
    ref = jspectral.spectral_embedding(jsvc[0], jsvc[1], k=3, tol=1e-4)
    np.testing.assert_allclose(emb.values, ref.values, rtol=1e-3)


# -- harmonic interpolation ----------------------------------------------------

def _dense_harmonic(L, bmask, xb):
    interior = ~bmask
    x = np.zeros((L.shape[0],) + xb.shape[1:])
    x[bmask] = xb
    x[interior] = np.linalg.solve(L[np.ix_(interior, interior)],
                                  -L[np.ix_(interior, bmask)] @ xb)
    return x


def test_harmonic_matches_dense_schur_and_reference(svc, jsvc):
    g, jg = svc[2], jsvc[2]
    rng = np.random.default_rng(3)
    bmask = np.zeros(g.n, dtype=bool)
    bmask[rng.choice(g.n, size=g.n // 5, replace=False)] = True
    xb = rng.standard_normal((int(bmask.sum()), 2))
    res = harmonic_interpolate(g, np.flatnonzero(bmask), xb, tol=1e-8,
                               device="cpu")
    assert res.converged.all()
    assert np.abs(res.x - _dense_harmonic(_dense_lap(g), bmask, xb)).max() \
        <= 1e-6
    np.testing.assert_allclose(res.x[bmask], xb)
    ref = jspectral.harmonic_interpolate(jg, np.flatnonzero(bmask), xb,
                                         tol=1e-8)
    assert np.abs(res.x - ref.x).max() <= 1e-6
    # a bool mask with [n] values selects the same problem
    full = np.zeros((g.n, 2))
    full[bmask] = xb
    res2 = harmonic_interpolate(g, bmask, full, tol=1e-8, device="cpu")
    assert np.abs(res2.x - res.x).max() <= 1e-6


def test_label_propagation_matches_reference(svc, jsvc):
    g, jg = svc[2], jsvc[2]
    rng = np.random.default_rng(4)
    labeled = rng.choice(g.n, size=g.n // 4, replace=False)
    labels = rng.integers(0, 3, labeled.shape[0])
    pred, scores = label_propagation(g, labeled, labels, tol=1e-6,
                                     device="cpu")
    assert pred.shape == (g.n,) and scores.shape == (g.n, 3)
    np.testing.assert_allclose(scores.sum(axis=1), 1.0, atol=1e-4)
    np.testing.assert_array_equal(pred[labeled], labels)
    pred_ref, scores_ref = jspectral.label_propagation(jg, labeled, labels,
                                                       tol=1e-6)
    np.testing.assert_allclose(scores, scores_ref, atol=1e-5)
    np.testing.assert_array_equal(pred, pred_ref)


def test_harmonic_rejects_bad_boundaries(svc):
    g = svc[2]
    with pytest.raises(ValueError, match="nonempty"):
        harmonic_interpolate(g, np.zeros(g.n, dtype=bool), np.zeros(g.n),
                             device="cpu")
    with pytest.raises(ValueError, match="values rows"):
        harmonic_interpolate(g, np.array([0, 1]), np.zeros(5), device="cpu")


# -- the er_sample score stage -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 12345, -5, 2 ** 31 + 3])
@pytest.mark.parametrize("n", [1, 5, 1000, 4097])
def test_er_sample_bits_equal_jax(seed, n):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (n,),
                                      jnp.uint32)).astype(np.int64)
    assert np.array_equal(stages.random_bits(seed, n, "cpu").numpy(), want)
    g_ref = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (n,),
                                         jnp.float32))
    g = stages.gumbel(seed, n, "cpu").numpy()
    assert g.dtype == np.float32
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=2.0 ** -20)


JSUITE, TSUITE = jgraph.suite("tiny"), suite("tiny")


@pytest.mark.parametrize("name", sorted(TSUITE))
@pytest.mark.parametrize("noise_seed", [0, 3])
def test_er_sample_masks_match_reference(name, noise_seed):
    jg, g = JSUITE[name], TSUITE[name]
    sp = Pipeline(pdgrass_config(alpha=0.1, score_mode="er_sample",
                                 seed=noise_seed)).run(g, device="cpu")
    jsp = JPipeline(jpdgrass_config(alpha=0.1, score_mode="er_sample",
                                    seed=noise_seed)).run(jg)
    assert sp.stats["n_recovered"] == jsp.stats["n_recovered"] > 0
    assert np.array_equal(sp.recovered_mask, np.asarray(jsp.recovered_mask))


def test_er_sample_takes_float32_only():
    with pytest.raises(TypeError, match="float32"):
        stages.SCORE_STAGES["er_sample"](
            torch.ones(3, dtype=torch.float64),
            torch.ones(3, dtype=torch.float64), ScoreConfig(kind="er_sample"))


# -- daemon routing and telemetry ----------------------------------------------

def test_daemon_routed_spectral_queries(svc):
    service, h, g = svc
    pairs = _pairs(g.n, 12, seed=6)
    r_sync = effective_resistance(service, h, pairs, tol=1e-6,
                                  cache=ResistanceCache())
    with SolverDaemon(service, max_batch_delay_ms=10.0) as d:
        r_async = effective_resistance(d, h, pairs, tol=1e-6,
                                       cache=ResistanceCache(),
                                       result_timeout=60.0)
        lam2, _ = fiedler_vector(d, h, tol=1e-3, result_timeout=60.0)
    np.testing.assert_allclose(r_async, r_sync, rtol=1e-5, atol=1e-9)
    lam_sync, _ = fiedler_vector(service, h, tol=1e-3)
    assert abs(lam2 - lam_sync) <= max(1e-6, 1e-3 * abs(lam_sync))


def test_spectral_spans_and_metrics_surface(svc):
    service, h, g = svc
    tr = get_tracer()
    was = tr.enabled
    tr.enable()
    tr.clear()
    try:
        effective_resistance(service, h, _pairs(g.n, 6, seed=7),
                             cache=ResistanceCache())
        fiedler_vector(service, h, tol=1e-3)
        harmonic_interpolate(g, np.array([0, g.n - 1]),
                             np.array([0.0, 1.0]), device="cpu")
        names = set(tr.span_names())
    finally:
        tr.clear()
        tr.enabled = was
    assert {"spectral.resistance", "spectral.embedding",
            "spectral.harmonic", "solver.flush"} <= names
    m = service.stats()["metrics"]
    assert m["spectral.resistance.queries"] >= 6
    assert m["spectral.resistance.solved_columns"] >= 6
    assert m["spectral.embedding.runs"] >= 1
    assert get_metrics().snapshot()["spectral.harmonic.solves"] >= 1


def test_spectral_entry_points_default_to_cuda():
    import inspect

    from repro_torch.spectral import resistance

    for fn in (harmonic_interpolate, label_propagation,
               resistance.exact_offtree_resistances,
               resistance.tree_preconditioned_solver):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
