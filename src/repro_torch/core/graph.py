"""Graph substrate for pdGRASS.

Host-side (numpy) graph construction, validation and synthetic generators.
The device-side algorithm (BFS, Boruvka MST, binary lifting, recovery) lives
in the sibling modules and consumes the flat edge arrays defined here.

All graphs are undirected, weighted, connected, simple (no self loops, no
multi-edges).  Edges are stored once with ``src < dst``; a CSR adjacency over
both directions is kept for host-side reference algorithms (feGRASS baseline,
PCG assembly).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """A weighted undirected graph in flat-array form.

    Attributes:
      n:       number of vertices.
      src/dst: ``[m]`` int32 endpoints with ``src < dst``.
      weight:  ``[m]`` float32 positive edge weights.
      indptr/adj/adj_w/adj_edge: CSR over both edge directions; ``adj_edge``
        maps a directed slot back to the undirected edge id.
    """

    n: int
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    indptr: np.ndarray
    adj: np.ndarray
    adj_w: np.ndarray
    adj_edge: np.ndarray

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def laplacian(self):
        """Graph Laplacian as a scipy CSR matrix (host side)."""
        import scipy.sparse as sp

        i = np.concatenate([self.src, self.dst, np.arange(self.n)])
        j = np.concatenate([self.dst, self.src, np.arange(self.n)])
        deg_w = np.zeros(self.n, dtype=np.float64)
        np.add.at(deg_w, self.src, self.weight)
        np.add.at(deg_w, self.dst, self.weight)
        v = np.concatenate([-self.weight, -self.weight, deg_w])
        return sp.csr_matrix((v, (i, j)), shape=(self.n, self.n))

    def laplacian_matvec(self, x: np.ndarray) -> np.ndarray:
        """``y = L x`` in float64 over the CSR arrays — numpy only, no scipy.

        ``x`` may be [n] or [n, k].  The service's float64 refinement
        residual on a CPU service (K7's plain version,
        :func:`repro_torch.kernels.ref.laplacian_residual_ref`) and the
        reference K7 is tested against on the card; graphs here are
        connected (every row non-empty), which ``np.add.reduceat`` over
        ``indptr`` relies on.
        """
        return csr_laplacian_matvec(self.indptr, self.adj, self.adj_w, x)


def csr_laplacian_matvec(indptr, adj, adj_w, x) -> np.ndarray:
    """:meth:`Graph.laplacian_matvec` over bare CSR arrays: each row's
    weighted degree and neighbour sum in float64, in CSR order."""
    x = np.asarray(x, dtype=np.float64)
    w = np.asarray(adj_w).astype(np.float64)
    wdeg = np.add.reduceat(w, indptr[:-1])
    if x.ndim == 2:
        nbr = np.add.reduceat(w[:, None] * x[adj], indptr[:-1], axis=0)
        return wdeg[:, None] * x - nbr
    nbr = np.add.reduceat(w * x[adj], indptr[:-1])
    return wdeg * x - nbr


def _two_wide(a: np.ndarray) -> np.ndarray:
    """``[n, k]`` with at least two columns (a zero column beside a single
    one).  numpy reduces an array of two or more columns over its rows one
    row at a time, every column alike, but a single column pairwise: so a
    column's mean or norm taken through here has the same bits in a batch
    of any width, and a request batched with others solves as it does
    alone."""
    return a if a.shape[1] > 1 else np.concatenate([a, 0 * a], axis=1)


def col_mean(a: np.ndarray) -> np.ndarray:
    return _two_wide(a).mean(axis=0)[:a.shape[1]]


def col_norm(a: np.ndarray) -> np.ndarray:
    return np.linalg.norm(_two_wide(a), axis=0)[:a.shape[1]]


def build_graph(n: int, src, dst, weight) -> Graph:
    """Validate + canonicalize an edge list into a :class:`Graph`."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    weight = np.asarray(weight, dtype=np.float32)
    if src.shape != dst.shape or src.shape != weight.shape:
        raise ValueError("src/dst/weight shape mismatch")
    if np.any(src == dst):
        raise ValueError("self loops are not allowed")
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    # Deduplicate multi-edges by summing weights (standard Laplacian semantics).
    key = lo * n + hi
    order = np.argsort(key, kind="stable")
    key, lo, hi, weight = key[order], lo[order], hi[order], weight[order]
    uniq, start = np.unique(key, return_index=True)
    if uniq.shape[0] != key.shape[0]:
        wsum = np.add.reduceat(weight, start)
        lo, hi, weight = lo[start], hi[start], wsum.astype(np.float32)
    if np.any(weight <= 0):
        raise ValueError("edge weights must be positive")

    m = lo.shape[0]
    # CSR over both directions.
    heads = np.concatenate([lo, hi])
    tails = np.concatenate([hi, lo])
    eids = np.concatenate([np.arange(m), np.arange(m)])
    ws = np.concatenate([weight, weight])
    order = np.argsort(heads, kind="stable")
    heads, tails, eids, ws = heads[order], tails[order], eids[order], ws[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, heads + 1, 1)
    indptr = np.cumsum(indptr)

    g = Graph(
        n=n,
        src=lo.astype(np.int32),
        dst=hi.astype(np.int32),
        weight=weight.astype(np.float32),
        indptr=indptr.astype(np.int64),
        adj=tails.astype(np.int32),
        adj_w=ws.astype(np.float32),
        adj_edge=eids.astype(np.int32),
    )
    if not is_connected(g):
        raise ValueError("graph must be a single connected component")
    return g


def is_connected(g: Graph) -> bool:
    """Breadth-first from vertex 0, one frontier at a time: every
    frontier vertex's adjacency range gathered at once."""
    seen = np.zeros(g.n, dtype=bool)
    seen[0] = True
    frontier = np.zeros(1, dtype=np.int64)
    while frontier.size:
        starts = g.indptr[frontier]
        lens = g.indptr[frontier + 1] - starts
        offs = np.cumsum(lens) - lens
        nbrs = g.adj[np.repeat(starts - offs, lens)
                     + np.arange(int(lens.sum()))]
        frontier = np.unique(nbrs[~seen[nbrs]]).astype(np.int64)
        seen[frontier] = True
    return bool(seen.all())


# ---------------------------------------------------------------------------
# Synthetic generators (stand-ins for the SuiteSparse suite; no network access)
# ---------------------------------------------------------------------------

def _rand_weights(rng: np.random.Generator, m: int) -> np.ndarray:
    # Paper: "random positive weights uniformly sampled between 1 and 10".
    return rng.uniform(1.0, 10.0, size=m).astype(np.float32)


def grid2d(rows: int, cols: int, seed: int = 0) -> Graph:
    """2D grid — analog of the road/census graphs (mi2010 .. tx2010)."""
    rng = np.random.default_rng(seed)
    idx = np.arange(rows * cols).reshape(rows, cols)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)
    e = np.concatenate([right, down])
    return build_graph(rows * cols, e[:, 0], e[:, 1], _rand_weights(rng, len(e)))


def mesh2d(rows: int, cols: int, seed: int = 0) -> Graph:
    """Triangulated grid — analog of the FEM meshes (NACA0015, M6, 333SP...)."""
    rng = np.random.default_rng(seed)
    idx = np.arange(rows * cols).reshape(rows, cols)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)
    diag = np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], 1)
    e = np.concatenate([right, down, diag])
    return build_graph(rows * cols, e[:, 0], e[:, 1], _rand_weights(rng, len(e)))


def barabasi_albert(n: int, k: int = 3, seed: int = 0) -> Graph:
    """Preferential attachment — skewed degrees, analog of com-Youtube/DBLP.

    These are the worst-case inputs for feGRASS (few high-degree hubs).
    """
    import networkx as nx

    rng = np.random.default_rng(seed)
    gx = nx.barabasi_albert_graph(n, k, seed=seed)
    e = np.asarray(gx.edges(), dtype=np.int64)
    return build_graph(n, e[:, 0], e[:, 1], _rand_weights(rng, len(e)))


def watts_strogatz(n: int, k: int = 6, p: float = 0.1, seed: int = 0) -> Graph:
    import networkx as nx

    rng = np.random.default_rng(seed)
    gx = nx.connected_watts_strogatz_graph(n, k, p, seed=seed)
    e = np.asarray(gx.edges(), dtype=np.int64)
    return build_graph(n, e[:, 0], e[:, 1], _rand_weights(rng, len(e)))


def random_regular(n: int, d: int = 4, seed: int = 0) -> Graph:
    import networkx as nx

    rng = np.random.default_rng(seed)
    gx = nx.random_regular_graph(d, n, seed=seed)
    if not nx.is_connected(gx):
        # connect components with a path
        comps = [list(c) for c in nx.connected_components(gx)]
        for a, b in zip(comps, comps[1:]):
            gx.add_edge(a[0], b[0])
    e = np.asarray(gx.edges(), dtype=np.int64)
    return build_graph(n, e[:, 0], e[:, 1], _rand_weights(rng, len(e)))


def star_hub(n: int, extra: int = 0, seed: int = 0) -> Graph:
    """Star + random chords — the degenerate feGRASS input (one pass per edge)."""
    rng = np.random.default_rng(seed)
    src = np.zeros(n - 1, dtype=np.int64)
    dst = np.arange(1, n, dtype=np.int64)
    if extra:
        a = rng.integers(1, n, size=extra)
        b = rng.integers(1, n, size=extra)
        keep = a != b
        src = np.concatenate([src, a[keep]])
        dst = np.concatenate([dst, b[keep]])
    return build_graph(n, src, dst, _rand_weights(rng, len(src)))


def suite(scale: str = "small") -> dict:
    """The benchmark suite: one generator per structural family in Table II."""
    if scale == "tiny":
        return {
            "grid": grid2d(12, 12, seed=1),
            "mesh": mesh2d(12, 12, seed=2),
            "ba": barabasi_albert(150, 3, seed=3),
            "ws": watts_strogatz(150, 6, 0.1, seed=4),
            "star": star_hub(120, extra=80, seed=5),
        }
    if scale == "small":
        return {
            "grid": grid2d(60, 60, seed=1),
            "mesh": mesh2d(60, 60, seed=2),
            "ba": barabasi_albert(4000, 3, seed=3),
            "ws": watts_strogatz(4000, 6, 0.1, seed=4),
            "regular": random_regular(4000, 4, seed=6),
            "star": star_hub(3000, extra=2000, seed=5),
        }
    if scale == "medium":
        return {
            "grid": grid2d(300, 300, seed=1),
            "mesh": mesh2d(300, 300, seed=2),
            "ba": barabasi_albert(100_000, 3, seed=3),
            "ws": watts_strogatz(100_000, 6, 0.1, seed=4),
            "regular": random_regular(100_000, 4, seed=6),
            "star": star_hub(50_000, extra=40_000, seed=5),
        }
    raise ValueError(f"unknown scale {scale!r}")
