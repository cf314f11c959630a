"""The port's ``er_exact`` score stage against the JAX reference and an
exact host f64 oracle, on the CPU.

On every graph of the suite (``suite("tiny")``: grid, mesh,
Barabasi-Albert, Watts-Strogatz, star) the port's pipeline scores the
off-tree edges by ``w * R_G`` from batched solves on the
spanning-tree-preconditioned solver: the same edges in the same order,
scores allclose to the reference's (rtol 1e-3), and the same recovered
mask.  Its resistances are within 1e-4 of the dense pinv (the reference
test's bar, ``tests/test_spectral.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as jgraph  # noqa: E402
from repro.pipeline import Pipeline as JPipeline  # noqa: E402
from repro.pipeline import pdgrass_config as jpdgrass_config  # noqa: E402
from repro_torch.core import grid2d, suite  # noqa: E402
from repro_torch.pipeline import (Pipeline, PipelineConfig,  # noqa: E402
                                  ScoreConfig, pdgrass_config)
from repro_torch.pipeline import stages  # noqa: E402
from repro_torch.spectral import exact_offtree_resistances  # noqa: E402

JSUITE, TSUITE = jgraph.suite("tiny"), suite("tiny")


def test_er_exact_config_roundtrip_and_fingerprint():
    cfg = pdgrass_config(alpha=0.05, score_mode="er_exact")
    d = cfg.to_dict()
    assert d["score"]["kind"] == "er_exact"
    back = PipelineConfig.from_dict(d)
    assert back == cfg and back.fingerprint() == cfg.fingerprint()
    tighter = dataclasses.replace(
        cfg, score=dataclasses.replace(cfg.score, tol=1e-8))
    assert tighter.fingerprint() != cfg.fingerprint()


@pytest.mark.parametrize("name", sorted(TSUITE))
def test_er_exact_scores_and_mask_match_reference(name):
    jg, g = JSUITE[name], TSUITE[name]
    cfg = pdgrass_config(alpha=0.1, score_mode="er_exact")
    jcfg = jpdgrass_config(alpha=0.1, score_mode="er_exact")
    prep = Pipeline(cfg).prepare(g, device="cpu")
    jprep = JPipeline(jcfg).prepare(jg)
    assert np.array_equal(prep.off_edge_id, np.asarray(jprep.off_edge_id))
    m_off = prep.m_off
    np.testing.assert_allclose(prep.problem.score[:m_off].numpy(),
                               np.asarray(jprep.problem.score)[:m_off],
                               rtol=1e-3)
    sp = Pipeline(cfg).run(g, prepared=prep, device="cpu")
    jsp = JPipeline(jcfg).run(jg, prepared=jprep)
    assert sp.stats["n_recovered"] > 0
    assert np.array_equal(sp.recovered_mask, np.asarray(jsp.recovered_mask))


def _dense_lap(g) -> np.ndarray:
    L = np.zeros((g.n, g.n))
    for s, d, w in zip(g.src, g.dst, g.weight):
        L[s, s] += w
        L[d, d] += w
        L[s, d] -= w
        L[d, s] -= w
    return L


def test_er_exact_resistances_match_pinv():
    g = grid2d(7, 6, seed=5)
    sp = Pipeline(pdgrass_config(alpha=0.1, score_mode="er_exact")).run(
        g, device="cpu")
    in_tree = np.asarray(sp.tree_mask)
    off = ~in_tree
    u, v = g.src[off], g.dst[off]
    r = exact_offtree_resistances(g, in_tree, u, v, tol=1e-8, device="cpu")
    P = np.linalg.pinv(_dense_lap(g))
    r_exact = P[u, u] + P[v, v] - 2 * P[u, v]
    assert (np.abs(r - r_exact) / r_exact).max() <= 1e-4


def test_er_exact_without_graph_context_raises():
    with pytest.raises(ValueError, match="graph context"):
        stages.SCORE_STAGES["er_exact"](torch.ones(3), torch.ones(3),
                                        ScoreConfig(kind="er_exact"))
