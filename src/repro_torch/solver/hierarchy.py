"""Multilevel pdGRASS: recursive sparsify -> contract -> re-sparsify.

The port of ``repro.solver.hierarchy``.  The sparsifier of a graph is
itself a graph that can be contracted by heavy-edge matching and sparsified
again; recursing until the graph is tiny yields a chain of ultra-sparse
Laplacians that :mod:`repro_torch.solver.device_pcg` applies as a symmetric
V-cycle.

Every level stores its sparsifier Laplacian as ELL [n, L] slabs, and its
aggregation ``agg`` both as an index (prolongation is a gather) and as a
CSR of aggregates (``perm``, ``agg_ptr``: the fine rows of each aggregate in
ascending order), which the restrict+residual kernel K3 walks to sum
without float atomics.

Contraction modes (``build_hierarchy(contraction=...)``):

  * ``"device"`` (default) — propose/accept heavy-edge matching with
    heaviest-neighbour absorption on the sparsifier's :class:`DeviceGraph`.
  * ``"host"`` — the sequential greedy matching over numpy arrays, the
    parity oracle.  Both follow the strict (weight, -edge id) order and
    give the identical clustering.
  * ``"sharded"`` — the propose/accept rounds with the edge list sharded
    over a :class:`repro_torch.launch.Mesh` (:func:`sharded_contract`):
    the same clustering; coarse weights equal up to the order of their
    float sums (each shard sums its own parallel edges first).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device_graph import DeviceGraph
from repro_torch.core.graph import Graph, build_graph
from repro_torch.core.collectives import pmax
from repro_torch.core.graph_ops import (coalesce_edges,
                                        propose_accept_matching,
                                        scatter_drop, segment_argmax,
                                        sharded_coalesce_edges,
                                        sharded_matching,
                                        sharded_segment_argmax)
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.obs.device import trace_annotation
from repro_torch.pipeline import Pipeline, PipelineConfig, pdgrass_config


@dataclasses.dataclass(frozen=True)
class Level:
    """One fine level of the hierarchy (everything above the coarsest).

    Attributes:
      n:        vertex count at this level.
      idx/val:  ELL [n, L] slabs of this level's sparsifier Laplacian.
      diag:     [n] weighted degrees (Laplacian diagonal).
      agg:      [n] int32 coarse vertex of each fine vertex.
      n_coarse: vertex count of the next level.
      stats:    per-level build statistics.
      perm:     [n] int32 fine rows grouped by aggregate, ascending within.
      agg_ptr:  [n_coarse + 1] int32 aggregate c owns perm[agg_ptr[c]:
                agg_ptr[c+1]].
      agg_max:  the largest aggregate's size.
    """

    n: int
    idx: torch.Tensor
    val: torch.Tensor
    diag: torch.Tensor
    agg: torch.Tensor
    n_coarse: int
    stats: dict
    perm: torch.Tensor
    agg_ptr: torch.Tensor
    agg_max: int


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """A multilevel preconditioner chain: fine levels + coarsest dense factor."""

    levels: Tuple[Level, ...]
    coarse_n: int
    coarse_chol: Optional[torch.Tensor]  # [coarse_n-1, coarse_n-1] lower
    coarse_stats: dict

    @property
    def stats(self) -> Tuple[dict, ...]:
        return tuple(lev.stats for lev in self.levels) + (self.coarse_stats,)

    @property
    def depth(self) -> int:
        return len(self.levels) + 1

    @property
    def level_sizes(self) -> list:
        return [lev.n for lev in self.levels] + [self.coarse_n]


def aggregate_csr(agg: torch.Tensor, n_coarse: int):
    """``(perm, agg_ptr, agg_max)``: the CSR of aggregates of ``agg``, members
    of each aggregate in ascending fine index (a stable sort)."""
    perm = torch.argsort(agg, stable=True).to(torch.int32)
    counts = torch.bincount(agg.long(), minlength=n_coarse)
    agg_ptr = torch.zeros(n_coarse + 1, dtype=torch.int32, device=agg.device)
    agg_ptr[1:] = torch.cumsum(counts, 0)
    return perm, agg_ptr, int(counts.max()) if n_coarse else 0


def make_level(n, idx, val, diag, agg, n_coarse, stats) -> Level:
    perm, agg_ptr, agg_max = aggregate_csr(agg, n_coarse)
    return Level(n=n, idx=idx, val=val, diag=diag, agg=agg,
                 n_coarse=n_coarse, stats=stats, perm=perm, agg_ptr=agg_ptr,
                 agg_max=agg_max)


def subgraph(g: Graph, edge_mask: np.ndarray) -> Graph:
    """The graph induced by keeping ``edge_mask`` edges."""
    keep = np.asarray(edge_mask, dtype=bool)
    return build_graph(g.n, g.src[keep], g.dst[keep], g.weight[keep])


def heavy_edge_matching(g: Graph) -> np.ndarray:
    """Greedy maximal matching preferring heavy edges (host parity oracle);
    ``mate[v]`` or -1."""
    order = np.argsort(-g.weight, kind="stable")
    mate = np.full(g.n, -1, dtype=np.int64)
    src_l = g.src[order].tolist()
    dst_l = g.dst[order].tolist()
    mate_l = mate.tolist()
    for u, v in zip(src_l, dst_l):
        if mate_l[u] < 0 and mate_l[v] < 0:
            mate_l[u] = v
            mate_l[v] = u
    return np.asarray(mate_l, dtype=np.int64)


def contract(g: Graph) -> Tuple[np.ndarray, Graph]:
    """Contract a heavy-edge matching into clusters: ``(agg [n], coarse)``.

    Matched pairs seed the clusters (numbered by their lower endpoint);
    every unmatched vertex joins its heaviest neighbour's cluster."""
    mate = heavy_edge_matching(g)
    agg = np.full(g.n, -1, dtype=np.int64)
    verts = np.arange(g.n)
    lo_end = np.flatnonzero((mate >= 0) & (verts < mate))
    agg[lo_end] = np.arange(lo_end.shape[0])
    agg[mate[lo_end]] = np.arange(lo_end.shape[0])
    nxt = lo_end.shape[0]
    un = agg < 0
    if np.any(un):
        deg = np.diff(g.indptr)
        heads = np.repeat(verts, deg)
        slot_order = np.lexsort((-g.adj_w, heads))[::-1]
        best = np.full(g.n, -1, dtype=np.int64)
        best[heads[slot_order]] = g.adj[slot_order]
        agg[un] = agg[best[un]]
    cu, cv = agg[g.src], agg[g.dst]
    keep = cu != cv
    coarse = build_graph(nxt, cu[keep], cv[keep], g.weight[keep])
    return agg.astype(np.int32), coarse


def _device_contract_arrays(n: int, src, dst, weight):
    """Matching + clustering + edge coalesce over flat device tensors.

    Returns ``(mate, agg, n_pairs, csrc, cdst, cw, m_coarse)``."""
    m = src.shape[0]
    dev = src.device
    verts = torch.arange(n, dtype=torch.int32, device=dev)
    mate = propose_accept_matching(n, src, dst, weight)
    matched = mate >= 0
    is_lo = matched & (verts < mate)
    pid = torch.cumsum(is_lo.to(torch.int32), 0, dtype=torch.int32) - 1
    pair_of = torch.where(is_lo, pid,
                          pid[torch.where(matched, mate, 0).long()])
    pair_of = torch.where(matched, pair_of, -1)
    # Unmatched vertices absorb into their heaviest neighbour's cluster; the
    # [src-side | dst-side] layout makes the element-index tie-break
    # reproduce the host CSR slot order.
    heads = torch.cat([src, dst])
    tails = torch.cat([dst, src])
    w2 = torch.cat([weight, weight])
    pick, _ = segment_argmax(w2, heads, n)
    target = tails[torch.where(pick < 2 * m, pick, 0).long()]
    agg = torch.where(matched, pair_of, pair_of[target.long()])
    csrc, cdst, cw, m_coarse = coalesce_edges(src, dst, weight, agg, n)
    return mate, agg, is_lo.sum(), csrc, cdst, cw, m_coarse


def device_contract(dg: DeviceGraph) -> Tuple[torch.Tensor, Graph]:
    """Device counterpart of :func:`contract`: ``(agg [n] int32 on the
    device, coarse host Graph)``.  The host only slices the coalesced coarse
    edge list to build the next level's :class:`Graph`."""
    _, agg, n_pairs, csrc, cdst, cw, m_coarse = _device_contract_arrays(
        dg.n, dg.src, dg.dst, dg.weight)
    nc, mc = (int(v) for v in torch.stack([n_pairs, m_coarse]).tolist())
    with get_tracer().span("hierarchy.coarse_graph", n=nc, m=mc):
        coarse = build_graph(nc, csrc[:mc].cpu().numpy(),
                             cdst[:mc].cpu().numpy(), cw[:mc].cpu().numpy())
    return agg, coarse


def _sharded_contract_arrays(n: int, m_total: int, src, dst, weight, eids):
    """:func:`_device_contract_arrays` with the edges sharded ``[P, m_loc]``:
    matching, clustering and a two-phase coalesce.

    ``eids`` holds global edge ids, -1 on padding; padding slots carry
    ``src == dst == 0``, so the coalesce drops them.  The clustering is the
    replicated ``[n]`` mirror of the single-device one, with the same pair
    numbering and slot order for the absorption tie-break, so it gives the
    identical ``agg``."""
    dev = src.device
    verts = torch.arange(n, dtype=torch.int32, device=dev)
    valid = eids >= 0
    mate = sharded_matching(n, src, dst, weight, eids)
    matched = mate >= 0
    is_lo = matched & (verts < mate)
    pid = torch.cumsum(is_lo.to(torch.int32), 0, dtype=torch.int32) - 1
    pair_of = torch.where(is_lo, pid,
                          pid[torch.where(matched, mate, 0).long()])
    pair_of = torch.where(matched, pair_of, -1)
    # Unmatched vertices absorb into their heaviest neighbour's cluster.
    # Global slot ids reproduce the single-device [src-side | dst-side]
    # layout (edge e's slots are e and m_total + e), so the pmin tie-break
    # matches the element-index tie-break of segment_argmax.
    heads = torch.cat([src, dst], dim=1)
    tails = torch.cat([dst, src], dim=1)
    slots = torch.cat([eids, torch.where(valid, eids + m_total, -1)], dim=1)
    w2 = torch.where(torch.cat([valid, valid], dim=1),
                     torch.cat([weight, weight], dim=1), -float("inf"))
    big = torch.iinfo(torch.int32).max
    pick, _ = sharded_segment_argmax(w2, heads, n, element_ids=slots,
                                     sentinel=big)
    # the shard that owns the winning slot writes its tail; pmax merges
    won = (slots >= 0) & (pick[heads] == slots)
    none = torch.full((n,), -1, dtype=torch.int32, device=dev)
    tgt = pmax(torch.stack([scatter_drop(none, heads[s], tails[s], won[s])
                            for s in range(src.shape[0])]))
    agg = torch.where(matched, pair_of,
                      pair_of[torch.where(tgt >= 0, tgt, 0).long()])
    csrc, cdst, cw, m_coarse = sharded_coalesce_edges(src, dst, weight, agg,
                                                      n)
    return mate, agg, is_lo.sum(), csrc, cdst, cw, m_coarse


def sharded_contract(dg: DeviceGraph, mesh, axis: str = "data"
                     ) -> Tuple[torch.Tensor, Graph]:
    """Mesh-sharded counterpart of :func:`device_contract`: the
    propose/accept rounds with the edge list sharded over ``axis``.

    Returns ``(agg [n] int32 on the device, coarse host Graph)``: the
    clustering of the device path, with coarse weights equal up to the
    order of their float sums."""
    mesh.check_device(dg.device, "the graph")
    n_sh = int(mesh.shape[axis])
    m = dg.m
    m_loc = max(1, -(-m // n_sh))
    pad = m_loc * n_sh - m

    def shard(x, fill):
        x = torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                     device=x.device)])
        return x.view(n_sh, m_loc)

    eids = torch.arange(m, dtype=torch.int32, device=dg.device)
    _, agg, n_pairs, csrc, cdst, cw, m_coarse = _sharded_contract_arrays(
        dg.n, m, shard(dg.src, 0), shard(dg.dst, 0), shard(dg.weight, 0.0),
        shard(eids, -1))
    nc, mc = (int(v) for v in torch.stack([n_pairs, m_coarse]).tolist())
    with get_tracer().span("hierarchy.coarse_graph", n=nc, m=mc):
        coarse = build_graph(nc, csrc[:mc].cpu().numpy(),
                             cdst[:mc].cpu().numpy(), cw[:mc].cpu().numpy())
    return agg, coarse


def _laplacian_diag(g: Graph) -> np.ndarray:
    deg = np.zeros(g.n, dtype=np.float64)
    np.add.at(deg, g.src, g.weight)
    np.add.at(deg, g.dst, g.weight)
    return deg


def _grounded_chol(g: Graph, device="cuda") -> Optional[torch.Tensor]:
    """Lower Cholesky factor of the grounded (node-0-removed) Laplacian,
    factored in float64 on the host, stored as f32 on ``device``."""
    if g.n < 2:
        return None
    w = g.weight.astype(np.float64)
    L = np.zeros((g.n, g.n), dtype=np.float64)
    np.add.at(L, (g.src, g.dst), -w)
    np.add.at(L, (g.dst, g.src), -w)
    L[np.arange(g.n), np.arange(g.n)] = _laplacian_diag(g)
    chol = np.linalg.cholesky(L[1:, 1:]).astype(np.float32)
    return torch.as_tensor(chol, device=device)


def build_hierarchy(
    graph: Graph,
    alpha: float = 0.05,
    *,
    config: Optional[PipelineConfig] = None,
    coarse_n: int = 64,
    max_levels: int = 16,
    chunk: int = 512,
    contraction: str = "device",
    mesh=None,
    shard_axis: str = "data",
    device="cuda",
    **pdgrass_kwargs,
) -> Hierarchy:
    """Sparsify/contract recursively until the graph fits a dense coarse
    solve, with every tensor on ``device``.

    Each level sparsifies through :class:`repro_torch.pipeline.Pipeline`
    (``config`` if given, else a pdGRASS config from
    ``alpha``/``chunk``/``pdgrass_kwargs``), stores the sparsifier
    Laplacian as ELL slabs, then contracts the sparsifier by heavy-edge
    matching into the next level's graph.  ``contraction="sharded"``
    contracts over ``mesh``'s ``shard_axis`` (required in that mode)."""
    if contraction not in ("device", "host", "sharded"):
        raise ValueError(f"unknown contraction mode {contraction!r}; "
                         f"want 'device', 'host' or 'sharded'")
    if contraction == "sharded" and mesh is None:
        raise ValueError("contraction='sharded' needs a mesh")
    if config is None:
        config = pdgrass_config(alpha=alpha, chunk=chunk, **pdgrass_kwargs)
    pipe = Pipeline(config)
    tracer = get_tracer()
    levels = []
    g = graph
    with tracer.span("hierarchy.build", contraction=contraction,
                     n=graph.n, m=graph.m) as build_span:
        for _ in range(max_levels):
            if g.n <= coarse_n:
                break
            with tracer.span("hierarchy.level", level=len(levels),
                             n=g.n, m=g.m) as lev_span:
                m_off = g.m - (g.n - 1)
                if m_off > 0:
                    with tracer.span("hierarchy.sparsify", n=g.n, m=g.m):
                        sp = pipe.run(g, device=device)
                    edge_mask = sp.edge_mask
                    dg = sp.device_graph
                else:
                    edge_mask = None  # already a tree — nothing to sparsify
                    dg = DeviceGraph.from_graph(g, device=device)
                with tracer.span("hierarchy.contract", mode=contraction), \
                        trace_annotation(f"hierarchy.contract.{contraction}"):
                    if contraction == "device":
                        agg_dev, coarse = device_contract(dg)
                        m_sparsifier = dg.m
                    elif contraction == "sharded":
                        agg_dev, coarse = sharded_contract(
                            dg, mesh, axis=shard_axis)
                        m_sparsifier = dg.m
                    else:
                        sg = subgraph(g, edge_mask) \
                            if edge_mask is not None else g
                        agg_host, coarse = contract(sg)
                        agg_dev = torch.as_tensor(agg_host, device=device)
                        m_sparsifier = sg.m
                lev_span.set(n_coarse=coarse.n)
            if coarse.n >= g.n:  # no progress — stop rather than loop
                break
            with tracer.span("hierarchy.ell", n=g.n):
                idx, val = dg.to_ell()
            lev_stats = {
                "n": g.n, "m": g.m, "m_sparsifier": m_sparsifier,
                "n_coarse": coarse.n, "shrink": coarse.n / g.n,
                "contraction": contraction,
            }
            levels.append(make_level(g.n, idx, val, dg.diag, agg_dev,
                                     coarse.n, lev_stats))
            g = coarse
        coarse_stats = {"n": g.n, "m": g.m, "m_sparsifier": g.m,
                        "n_coarse": g.n, "shrink": 1.0,
                        "contraction": contraction}
        with tracer.span("hierarchy.coarse_chol", n=g.n):
            chol = _grounded_chol(g, device=device)
        build_span.set(depth=len(levels) + 1)
    m = get_metrics()
    m.inc("hierarchy.builds")
    m.inc("hierarchy.levels_built", len(levels))
    m.set_gauge("hierarchy.last_depth", len(levels) + 1)
    return Hierarchy(levels=tuple(levels), coarse_n=g.n,
                     coarse_chol=chol, coarse_stats=coarse_stats)


def hierarchy_from_arrays(levels: Sequence[dict], coarse_n: int,
                          coarse_chol, device="cuda") -> Hierarchy:
    """A :class:`Hierarchy` from numpy arrays (e.g. another build's).

    ``levels`` holds one dict per fine level with ``n, idx, val, diag,
    agg, n_coarse``; the aggregate CSR is derived here."""
    out = []
    for lev in levels:
        def t(name, dtype):
            return torch.tensor(np.asarray(lev[name], dtype=dtype),
                                device=device)
        n, nc = int(lev["n"]), int(lev["n_coarse"])
        out.append(make_level(n, t("idx", np.int32), t("val", np.float32),
                              t("diag", np.float32), t("agg", np.int32), nc,
                              {"n": n, "n_coarse": nc}))
    chol = (None if coarse_chol is None else
            torch.tensor(np.asarray(coarse_chol, dtype=np.float32),
                         device=device))
    return Hierarchy(levels=tuple(out), coarse_n=int(coarse_n),
                     coarse_chol=chol, coarse_stats={"n": int(coarse_n)})
