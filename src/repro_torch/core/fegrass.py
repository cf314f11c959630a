"""feGRASS baseline: loose (vertex-cover) similarity, multi-pass recovery.

The port of ``repro.core.fegrass``: the engine runs on the host over numpy
arrays, as the reference's does, reading the prepared tree mask and scores
back from the device once.

This is the comparison target of the paper (its Table II).  It shares steps
1-2 with pdGRASS (same spanning tree, same criticality order — the paper
does the same for an apples-to-apples recovery comparison) and differs in
step 4:

  * similarity is the *loose* condition (Definition 4 / Eq. 7): an edge is
    skipped if **either** endpoint is inside the union of the covered
    beta-hop neighborhoods of previously recovered edges;
  * the covered set is a vertex bitmap rebuilt each pass; if a pass ends
    with fewer than ``alpha * |V|`` recovered edges, the remaining edges are
    re-scanned in another pass (this is the multi-pass pathology that
    pdGRASS eliminates — thousands of passes on hub-dominated graphs).

In the unified API this is just the ``multipass`` recovery engine
(:mod:`repro_torch.pipeline.stages`): feGRASS == pdGRASS with a different
``recovery`` stage config.  :func:`fegrass` below is the back-compat
wrapper over ``Pipeline(fegrass_config(...))``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.sparsify import Prepared, Sparsifier


def _tree_csr(graph: Graph, tree_mask: np.ndarray):
    """CSR adjacency of the spanning tree (host side)."""
    s = graph.src[tree_mask]
    d = graph.dst[tree_mask]
    heads = np.concatenate([s, d])
    tails = np.concatenate([d, s])
    order = np.argsort(heads, kind="stable")
    heads, tails = heads[order], tails[order]
    indptr = np.zeros(graph.n + 1, dtype=np.int64)
    np.add.at(indptr, heads + 1, 1)
    return np.cumsum(indptr), tails


def _bfs_ball(indptr, adj, start: int, beta: int, out: np.ndarray):
    """Mark all vertices within ``beta`` tree hops of ``start`` in ``out``."""
    frontier = [start]
    seen = {start}
    out[start] = True
    for _ in range(beta):
        nxt = []
        for u in frontier:
            for v in adj[indptr[u]:indptr[u + 1]]:
                if v not in seen:
                    seen.add(v)
                    out[v] = True
                    nxt.append(v)
        if not nxt:
            break
        frontier = nxt


def loose_multipass_recover(prep: Prepared, target: int, *, c: int = 8,
                            max_passes: int = 200_000):
    """The feGRASS recovery engine: loose-similarity multi-pass (numpy).

    Returns ``(recovered_mask [graph.m] bool, stats)`` — the recovery-engine
    contract of :mod:`repro_torch.pipeline.stages`.
    """
    graph = prep.graph
    tree_mask = prep.tree.in_tree.cpu().numpy()
    indptr, adj = _tree_csr(graph, tree_mask)

    # Off-tree edges in global criticality order (score desc).
    score = prep.problem.score.cpu().numpy()[: prep.m_off]
    order = np.argsort(-score, kind="stable")
    eids = prep.off_edge_id[order]
    eu = graph.src[eids]
    ev = graph.dst[eids]

    recovered: list[int] = []
    remaining = np.arange(eids.shape[0])
    passes = 0
    while len(recovered) < target and remaining.size and passes < max_passes:
        passes += 1
        covered = np.zeros(graph.n, dtype=bool)
        keep_for_next = []
        progress = False
        for idx in remaining:
            if len(recovered) >= target:
                break
            u, v = int(eu[idx]), int(ev[idx])
            if covered[u] or covered[v]:
                keep_for_next.append(idx)
                continue
            recovered.append(idx)
            progress = True
            _bfs_ball(indptr, adj, u, c, covered)
            _bfs_ball(indptr, adj, v, c, covered)
        if not progress:
            break
        remaining = np.asarray(keep_for_next, dtype=remaining.dtype)

    recovered_mask = np.zeros(graph.m, dtype=bool)
    recovered_mask[eids[np.asarray(recovered, dtype=np.int64)]] = True
    return recovered_mask, {"passes": passes}


def fegrass(
    graph: Graph,
    alpha: float = 0.02,
    *,
    c: int = 8,
    max_passes: int = 200_000,
    prepared: Prepared | None = None,
    device="cuda",
) -> Sparsifier:
    """Loose-similarity multi-pass recovery — back-compat wrapper over
    ``Pipeline(fegrass_config(...))``; steps 1-3 run on ``device``."""
    from repro_torch.pipeline import Pipeline, fegrass_config

    cfg = fegrass_config(alpha=alpha, c=c, max_passes=max_passes)
    return Pipeline(cfg).run(graph, prepared=prepared, device=device)
