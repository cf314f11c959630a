"""The reference of a build on small graphs: its pieces against hand-made
cases and the program's own, every number at zero on the program's
hierarchy, and each number moved by the fault it is for, planted in the
hierarchy's arrays."""
import numpy as np
import pytest
import torch

from gssbench import build_reference as br
from gssbench.graphs import grid2d, mesh2d

PARAMS = {"weight_low": 1.0, "weight_high": 10.0}


def _graph(family, rows, seed=0):
    from repro_torch.core.graph import build_graph

    gen = {"mesh2d": mesh2d, "grid2d": grid2d}[family]
    n, src, dst, w = gen.generate(dict(PARAMS, rows=rows, cols=rows), seed)
    return build_graph(n, src, dst, w)


def _hierarchy(g):
    from gssbench.harness import host_hierarchy
    from repro_torch.solver.hierarchy import build_hierarchy

    torch.set_num_threads(2)
    return host_hierarchy(build_hierarchy(g, alpha=0.05, chunk=512,
                                          coarse_n=64, device="cpu"))


@pytest.fixture(scope="module")
def built():
    g = _graph("mesh2d", 48, seed=3)
    return g, _hierarchy(g)


def _judge(g, h):
    return br.judge_hierarchy(g.n, g.src, g.dst, g.weight, h["levels"],
                              h["chol"], 0.05, 8)


def test_budget():
    assert br.budget(1000, 1998, 0.05) == 50
    assert br.budget(100, 105, 0.5) == 6


def test_hops_to_root():
    #   0 <- 1 <- 2 <- 3, 1 <- 4
    pred = np.array([0, 0, 1, 2, 1])
    np.testing.assert_array_equal(br.hops_to_root(pred, 0), [0, 1, 2, 3, 2])


def test_ell_edges_pairs_mirrors():
    # a path 0 - 1 - 2 with weights 2 and 3, slabs of width 3
    idx = np.array([[1, 0, 0], [0, 2, 1], [1, 2, 2]])
    val = np.array([[-2, 2, 0], [-2, -3, 5], [-3, 3, 0]], np.float32)
    keys, w, unpaired = br.ell_edges(3, idx, val)
    np.testing.assert_array_equal(keys, [0 * 3 + 1, 1 * 3 + 2])
    np.testing.assert_array_equal(w, [2.0, 3.0])
    assert unpaired == 0
    val[2, 0] = -4                    # the mirror of (1, 2) disagrees
    keys, w, unpaired = br.ell_edges(3, idx, val)
    np.testing.assert_array_equal(keys, [1])
    assert unpaired == 2


@pytest.mark.parametrize("family", ["mesh2d", "grid2d"])
def test_tree_and_scores_match_the_program(family):
    from repro_torch.core import lifting
    from repro_torch.core.spanning_tree import build_spanning_tree

    g = _graph(family, 24, seed=5)
    t = build_spanning_tree(g.n, torch.tensor(g.src), torch.tensor(g.dst),
                            torch.tensor(g.weight))
    u, v, w, _ = br.canonical(g.n, g.src, g.dst, g.weight)
    w32 = w.astype(np.float32)
    in_tree, root = br.feGRASS_tree(g.n, u, v, w32)
    np.testing.assert_array_equal(in_tree, t.in_tree.numpy())
    tree = br.RootedTree(g.n, u, v, w32, in_tree, root)
    np.testing.assert_array_equal(tree.parent, t.parent.numpy())
    np.testing.assert_array_equal(tree.depth, t.depth.numpy())
    lift = lifting.build_lifting(g.n, t.parent, t.parent_w, t.depth)
    np.testing.assert_array_equal(tree.rdist, lift.rdist_root.numpy())
    off = np.flatnonzero(~in_tree)
    got = tree.lca(u[off], v[off])
    want = lifting.lca(lift, torch.tensor(u[off]), torch.tensor(v[off]))
    np.testing.assert_array_equal(got, want.numpy())


def test_the_program_reads_zero(built):
    g, h = built
    got = _judge(g, h)
    assert all(got[k] == 0 for k in br.COUNTS)
    assert got["weight_gap"] < 1e-6
    assert len(h["levels"]) >= 3


def _swap_recovered(g, h, skip_for):
    """Level 0 with one recovered off-tree edge replaced by another."""
    lev = dict(h["levels"][0])
    keys, w, _ = br.ell_edges(g.n, lev["idx"], lev["val"])
    u, v, wg, gkeys = br.canonical(g.n, g.src, g.dst, g.weight)
    in_tree, _ = br.feGRASS_tree(g.n, u, v, wg.astype(np.float32))
    tree_keys = gkeys[in_tree]
    rec = np.setdiff1d(keys, tree_keys)
    outside = np.setdiff1d(gkeys, keys)
    drop, add = skip_for(rec, outside)
    keys = np.sort(np.concatenate([np.setdiff1d(keys, [drop]), [add]]))
    w = wg[np.searchsorted(gkeys, keys)]
    lev["idx"], lev["val"] = _slabs(g.n, keys, w)
    return dict(h, levels=[lev] + list(h["levels"][1:]))


def _slabs(n, keys, w):
    u, v = keys // n, keys % n
    deg = np.bincount(np.concatenate([u, v]), minlength=n)
    width = int(deg.max()) + 1
    idx = np.tile(np.arange(n)[:, None], (1, width))
    val = np.zeros((n, width), np.float32)
    fill = np.zeros(n, int)
    for a, b, x in zip(u, v, w):
        for p, q in ((a, b), (b, a)):
            idx[p, fill[p]], val[p, fill[p]] = q, -x
            fill[p] += 1
    return idx, val


def test_a_wrong_recovered_edge_is_caught(built):
    g, h = built
    # the first recovered edge out, the first edge outside the sparsifier in
    bad = _swap_recovered(g, h, lambda rec, outside: (rec[0], outside[0]))
    got = _judge(g, bad)
    assert got["recovered_marked"] + got["skipped_unmarked"] > 0
    assert got["foreign_entries"] == 0 and got["edges_over_budget"] == 0


def test_wrong_coarse_weights_and_factor_are_caught(built):
    g, h = built
    lev = dict(h["levels"][1], val=h["levels"][1]["val"] * 0.5)
    got = _judge(g, dict(h, levels=[h["levels"][0], lev]
                         + list(h["levels"][2:])))
    assert got["weight_gap"] >= 0.5
    got = _judge(g, dict(h, chol=h["chol"] * 1.01))
    assert got["weight_gap"] > 1e-3


def test_a_wrong_aggregation_is_caught(built):
    g, h = built
    agg = h["levels"][0]["agg"].copy()
    agg[:2] = agg[[1, 0]] if agg[0] != agg[1] else agg[:2]
    agg[0] = agg[-1]                  # a vertex joins a far aggregate
    lev = dict(h["levels"][0], agg=agg)
    got = _judge(g, dict(h, levels=[lev] + list(h["levels"][1:])))
    assert got["bad_aggregates"] > 0
