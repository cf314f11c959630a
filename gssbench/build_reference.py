"""The plain reference of a pdGRASS hierarchy: every level judged against
the graph it was built from.

NumPy and SciPy; the pair tests of the strict-similarity check run in
plain PyTorch on the device it is given.  It imports nothing of
``repro_torch`` and takes nothing the program made but the hierarchy it
judges: each level's sparsifier (ELL slabs), its aggregation map and the
coarsest level's Cholesky factor.  Level 0's graph is the benchmark's own;
every level below is worked out here from the level above it.

For each level, with ``G`` its graph and ``S`` its sparsifier:

* ``S`` is a connected subgraph of ``G`` with ``G``'s weights;
* ``S`` holds the feGRASS tree of ``G``: the maximum spanning tree over
  the effective weights ``w log(max(deg_u, deg_v, 2)) / max(d_u + d_v,
  1)`` (``d`` the hop distance from the highest-degree vertex), ties to
  the lower edge id;
* its other edges are what pdGRASS's greedy recovers.  Off-tree edges
  fall into subtasks by the tree LCA of their endpoints, in the order
  (LCA, score ``w R_T`` descending); an edge is recovered unless an
  earlier recovered edge of its subtask strictly-similarity marks it
  (Definition 5: both endpoints, in either pairing, within tree distance
  ``beta = min(d(u, lca), d(v, lca), c)`` of the marker's).  The program
  keeps at most ``ceil(alpha n)`` of them, the best by score: it may stop
  once it has that many, and then the check covers each subtask up to its
  last kept edge; with fewer it has run every subtask to its end, and the
  check covers every edge.  There no kept edge may be marked by an
  earlier kept one, and every edge left out must be.  Scores are float32 sums in the
  configuration's precision, in the order of binary lifting, so that
  near-equal scores fall in the program's order;
* the next level's graph is ``S`` contracted by the aggregation map,
  ``P^T L_S P`` (whose off-diagonal entries are the summed weights of the
  edges between two aggregates), each aggregate connected in ``S``; the
  coarsest graph's grounded Laplacian is ``C C^T`` (its relative gap counts
  in ``weight_gap``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import (breadth_first_order, connected_components,
                                  minimum_spanning_tree)

COUNTS = ("foreign_entries", "edges_over_budget", "extra_components",
          "tree_missing",
          "recovered_marked", "skipped_unmarked", "bad_aggregates")
GAPS = ("weight_gap",)
# pairs tested at once by the strict-similarity check
PAIR_CHUNK = 1 << 20


def budget(n: int, m: int, alpha: float) -> int:
    """The off-tree edges a pdGRASS sparsifier keeps at most:
    ``ceil(alpha n)``, or every off-tree edge if there are fewer."""
    return min(int(math.ceil(alpha * n)), m - (n - 1))


def canonical(n: int, src, dst, w) -> Tuple[np.ndarray, ...]:
    """Edges ``u < v`` sorted by ``(u, v)``, parallel edges summed, with
    their keys ``u n + v`` and float64 weights."""
    u = np.minimum(src, dst).astype(np.int64)
    v = np.maximum(src, dst).astype(np.int64)
    key = u * n + v
    keys, inv = np.unique(key, return_inverse=True)
    wsum = np.bincount(inv, weights=np.asarray(w, np.float64),
                       minlength=len(keys))
    return keys // n, keys % n, wsum, keys


def ell_edges(n: int, idx, val) -> Tuple[np.ndarray, ...]:
    """The edges of ELL slabs ``idx, val [n, L]`` (neighbour entries
    ``-w``, the diagonal, padding of value 0): ``(keys, w, unpaired)``,
    one key ``u n + v`` (``u < v``) and float64 weight an edge whose two
    entries agree, and the count of entries without such a mirror."""
    idx = np.asarray(idx, np.int64)
    val = np.asarray(val)
    rows = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None], idx.shape)
    off = (idx != rows) & (val != 0)
    u, v, w = rows[off], idx[off], -val[off].astype(np.float64)
    key = np.minimum(u, v) * n + np.maximum(u, v)
    order = np.lexsort((w, key))
    key, w = key[order], w[order]
    keys, start, counts = np.unique(key, return_index=True,
                                    return_counts=True)
    paired = (counts == 2) & (w[start] == w[np.minimum(start + 1,
                                                        len(w) - 1)])
    return keys[paired], w[start][paired], int(off.sum() - 2 * paired.sum())


def hops_to_root(pred: np.ndarray, root: int) -> np.ndarray:
    """Depth of every vertex of a tree given as ``pred`` (the root its
    own), by pointer jumping."""
    n = pred.shape[0]
    p = pred.copy()
    d = (np.arange(n) != root).astype(np.int64)
    for _ in range(max(1, math.ceil(math.log2(max(n, 2)))) + 1):
        d = d + d[p] * (p != np.arange(n))
        d[root] = 0
        p = p[p]
    return d


def _adjacency(n: int, u, v, data) -> sp.csr_matrix:
    return sp.coo_matrix((data, (u, v)), shape=(n, n)).tocsr()


def feGRASS_tree(n: int, u, v, w32) -> Tuple[np.ndarray, int]:
    """``(in_tree [m], root)``: the maximum spanning tree over the
    effective weights (float32, as the configuration computes them),
    ties to the lower edge id."""
    m = u.shape[0]
    deg = np.bincount(np.concatenate([u, v]), minlength=n)
    root = int(np.argmax(deg))
    adj = _adjacency(n, u, v, np.ones(m))
    order, pred = breadth_first_order(adj, root, directed=False,
                                      return_predecessors=True)
    if order.shape[0] != n:
        raise ValueError("the graph is not connected")
    pred = np.where(pred < 0, np.arange(n), pred)
    dist = hops_to_root(pred, root)
    num = np.log(np.maximum(np.maximum(deg[u], deg[v]), 2)
                 .astype(np.float64)).astype(np.float32)
    den = np.maximum(dist[u] + dist[v], 1).astype(np.float32)
    eff = (w32 * num) / den
    best_first = np.lexsort((np.arange(m), -eff))
    rank = np.empty(m, np.float64)
    rank[best_first] = np.arange(1, m + 1)
    # the minimum spanning tree over the ranks: each tree edge once
    t = minimum_spanning_tree(_adjacency(n, u, v, rank)).tocoo()
    in_tree = np.zeros(m, bool)
    in_tree[best_first[(t.data - 1).astype(np.int64)]] = True
    return in_tree, root


class RootedTree:
    """A spanning tree rooted at ``root``: parents, depths, the float32
    resistive distance to the root by binary lifting, LCA queries and
    ancestor signatures."""

    def __init__(self, n: int, u, v, w32, in_tree, root: int):
        tu, tv, tw = u[in_tree], v[in_tree], w32[in_tree]
        adj = _adjacency(n, np.concatenate([tu, tv]),
                         np.concatenate([tv, tu]),
                         np.ones(2 * tu.shape[0]))
        _, pred = breadth_first_order(adj, root, directed=True,
                                      return_predecessors=True)
        parent = np.where(pred < 0, np.arange(n), pred).astype(np.int64)
        self.parent, self.root = parent, root
        self.depth = hops_to_root(parent, root)
        # the weight of each vertex's edge to its parent
        child = np.where(parent[tv] == tu, tv, tu)
        pw = np.zeros(n, np.float32)
        pw[child] = tw
        is_root = parent == np.arange(n)
        up = parent
        rw = np.where(is_root, np.float32(0),
                      np.float32(1) / np.maximum(pw, np.float32(1e-30)))
        self.ups = [up]
        for _ in range(max(int(np.ceil(np.log2(max(n, 2)))) + 1, 1) - 1):
            up, rw = up[up], rw + rw[up]
            self.ups.append(up)
        self.rdist = rw.astype(np.float32)

    def lca(self, a, b) -> np.ndarray:
        da, db = self.depth[a], self.depth[b]
        x = np.where(da >= db, a, b)
        y = np.where(da >= db, b, a)
        diff = np.abs(da - db)
        for k in range(len(self.ups) - 1, -1, -1):
            x = np.where((diff >> k) & 1 == 1, self.ups[k][x], x)
        eq = x == y
        for k in range(len(self.ups) - 1, -1, -1):
            ux, uy = self.ups[k][x], self.ups[k][y]
            go = ~eq & (ux != uy)
            x, y = np.where(go, ux, x), np.where(go, uy, y)
        return np.where(eq, x, self.ups[0][x])

    def signatures(self, c: int) -> np.ndarray:
        """``[n, c + 1]``: column ``j`` the ``j``-th ancestor (saturating
        at the root)."""
        cols = [np.arange(self.parent.shape[0])]
        for _ in range(c):
            cols.append(self.parent[cols[-1]])
        return np.stack(cols, axis=1)


def _near(sa, sb, beta, apb):
    """``[P]``: some ancestor pair ``(a, b)`` of rows ``sa``, ``sb`` with
    ``a + b <= beta`` is equal, i.e. tree distance ``<= beta``."""
    eq = sa[:, :, None] == sb[:, None, :]
    return (eq & (apb[None] <= beta[:, None, None])).flatten(1).any(1)


def greedy_check(n: int, u, v, w32, in_tree, in_s, tree: RootedTree,
                 c: int, complete: bool, device="cpu") -> Dict[str, int]:
    """``recovered_marked`` and ``skipped_unmarked`` of the off-tree edges
    against the strict-similarity greedy (module docstring); with
    ``complete`` the greedy ran through every subtask to its end."""
    import torch

    off = np.flatnonzero(~in_tree)
    if off.shape[0] == 0:
        return {"recovered_marked": 0, "skipped_unmarked": 0}
    ou, ov, ow = u[off], v[off], w32[off]
    lca = tree.lca(ou, ov)
    r = tree.rdist
    score = ow * ((r[ou] + r[ov]) - np.float32(2) * r[lca])
    dl = tree.depth[lca]
    beta = np.minimum(np.minimum(tree.depth[ou] - dl, tree.depth[ov] - dl),
                      c)
    order = np.lexsort((-score, lca))
    seg, kept = lca[order], in_s[off][order]
    ou, ov, beta = ou[order], ov[order], beta[order]
    m = order.shape[0]
    pos = np.arange(m)
    # each subtask's last kept row (its last row where the greedy ran
    # through): rows up to it were all processed
    first = np.concatenate([[True], seg[1:] != seg[:-1]])
    sid = np.cumsum(first) - 1
    last = np.full(int(sid[-1]) + 1, -1)
    if complete:
        last[sid] = pos
    else:
        np.maximum.at(last, sid[kept], pos[kept])
    region = pos <= last[sid]
    # pairs (kept i, later row j of its subtask up to the last kept row)
    ki = np.flatnonzero(kept)
    span = last[sid[ki]] - ki
    I = np.repeat(ki, span)
    J = I + 1 + (np.arange(I.shape[0]) - np.repeat(np.cumsum(span) - span,
                                                   span))
    sig = tree.signatures(c)
    dev = torch.device(device)
    su = torch.as_tensor(sig[ou], device=dev)
    sv = torch.as_tensor(sig[ov], device=dev)
    bt = torch.as_tensor(beta, device=dev)
    a = torch.arange(c + 1, device=dev)
    apb = a[:, None] + a[None, :]
    marked = torch.zeros(m, dtype=torch.bool, device=dev)
    for lo in range(0, I.shape[0], PAIR_CHUNK):
        i = torch.as_tensor(I[lo:lo + PAIR_CHUNK], device=dev)
        j = torch.as_tensor(J[lo:lo + PAIR_CHUNK], device=dev)
        b = bt[i]
        sim = ((_near(su[i], su[j], b, apb) & _near(sv[i], sv[j], b, apb))
               | (_near(su[i], sv[j], b, apb)
                  & _near(sv[i], su[j], b, apb)))
        marked[j[sim]] = True
    marked = marked.cpu().numpy()
    return {"recovered_marked": int((kept & marked).sum()),
            "skipped_unmarked": int((region & ~kept & ~marked).sum())}


def judge_level(n: int, u, v, w, keys, s_keys, s_w, alpha: float, c: int,
                device="cpu") -> Dict[str, float]:
    """The numbers of one level: graph ``(u, v, w)`` with ``keys``, its
    sparsifier's paired edges ``(s_keys, s_w)``."""
    m = u.shape[0]
    pos = np.minimum(np.searchsorted(keys, s_keys), max(m - 1, 0))
    found = keys[pos] == s_keys
    in_s = np.zeros(m, bool)
    in_s[pos[found]] = True
    gap = np.abs(s_w[found] - w[pos[found]]) / w[pos[found]]
    m_off = m - (n - 1)
    a = _adjacency(n, u[in_s], v[in_s], np.ones(int(in_s.sum())))
    components = connected_components(a, directed=False)[0]
    w32 = w.astype(np.float32)
    in_tree, root = feGRASS_tree(n, u, v, w32)
    tree = RootedTree(n, u, v, w32, in_tree, root)
    recovered = int((in_s & ~in_tree).sum())
    target = budget(n, m, alpha)
    out = {"foreign_entries": int((~found).sum()),
           "weight_gap": float(gap.max()) if gap.size else 0.0,
           "edges_over_budget": max(0, recovered - target),
           "extra_components": int(components) - 1,
           "tree_missing": int((in_tree & ~in_s).sum())}
    # short of the budget only where the greedy ran through every subtask
    out.update(greedy_check(n, u, v, w32, in_tree, in_s, tree, c,
                            recovered < target and m_off > 0, device))
    return out


def contract(n: int, s_keys, s_w, agg, n_coarse: int):
    """The next level's graph, ``P^T L_S P``'s edges: ``(u, v, w, keys)``,
    and the count of faults of the aggregation map (ids out of range or
    unused, aggregates not connected in ``S``)."""
    agg = np.asarray(agg, np.int64)
    su, sv = s_keys // n, s_keys % n
    bad = int(((agg < 0) | (agg >= n_coarse)).sum())
    agg = np.clip(agg, 0, max(n_coarse - 1, 0))
    bad += int((np.bincount(agg, minlength=n_coarse) == 0).sum())
    cu, cv = agg[su], agg[sv]
    inside = cu == cv
    comps = connected_components(
        _adjacency(n, su[inside], sv[inside], np.ones(int(inside.sum()))),
        directed=False)[0]
    bad += abs(int(comps) - n_coarse)
    cross = ~inside
    return (*canonical(n_coarse, cu[cross], cv[cross], s_w[cross]), bad)


def chol_gap(n: int, u, v, w, chol) -> float:
    """``||C C^T - L_g|| / ||L_g||`` (Frobenius), ``L_g`` the Laplacian
    grounded at vertex 0."""
    L = np.zeros((n, n))
    np.add.at(L, (u, v), -w)
    np.add.at(L, (v, u), -w)
    L[np.arange(n), np.arange(n)] = -L.sum(axis=1)
    Lg = L[1:, 1:]
    C = np.asarray(chol, np.float64)
    return float(np.linalg.norm(C @ C.T - Lg) / np.linalg.norm(Lg))


def judge_hierarchy(n: int, src, dst, w, levels: Sequence[dict], chol,
                    alpha: float, c: int, device="cpu") -> Dict[str, float]:
    """Every level of a hierarchy built from the graph ``(src, dst, w)``:
    ``levels`` holds ``n, idx, val, agg, n_coarse`` a level, ``chol`` the
    coarsest level's factor.  Counts are summed over the levels;
    ``weight_gap`` is the largest relative gap of a sparsifier's weights
    to its level's graph, or of the coarsest factor's product to its
    graph's grounded Laplacian."""
    out: Dict[str, float] = {k: 0 for k in COUNTS}
    out.update({k: 0.0 for k in GAPS})
    u, v, wg, keys = canonical(n, src, dst, w)
    for lev in levels:
        if int(lev["n"]) != n:
            out["bad_aggregates"] += 1
            break
        s_keys, s_w, unpaired = ell_edges(n, lev["idx"], lev["val"])
        got = judge_level(n, u, v, wg, keys, s_keys, s_w, alpha, c, device)
        got["foreign_entries"] += unpaired
        for k, val in got.items():
            out[k] = max(out[k], val) if k in GAPS else out[k] + val
        nc = int(lev["n_coarse"])
        u, v, wg, keys, bad = contract(n, s_keys, s_w, lev["agg"], nc)
        out["bad_aggregates"] += bad
        n = nc
    if chol is None:
        gap = float("inf") if n > 1 else 0.0
    else:
        gap = chol_gap(n, u, v, wg, chol)
    out["weight_gap"] = max(out["weight_gap"], gap)
    return out


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest of each number over several hierarchies."""
    return {k: max(r[k] for r in readings) for k in COUNTS + GAPS}
