"""Step 1 of pdGRASS/feGRASS: effective-weight maximum spanning tree.

The port of ``repro.core.spanning_tree``:

  * BFS is iterative edge relaxation with a scatter-min — one vectorized
    sweep over the edges per BFS level.
  * The maximum spanning tree is Boruvka (O(log V) rounds of segment-max +
    pointer jumping) under the strict (weight, -edge id) order.

The reference's three ``lax.while_loop``s (``spanning_tree.py:41`` BFS,
``:111`` Boruvka, ``:132`` tree-depth BFS) are Python loops with a host sync
on their termination test.  A BFS relaxation is idempotent once converged,
so the two BFS loops test every 16 trips; a graph's diameter
of trips (about a thousand on a 1024 x 1024 mesh) then costs a few dozen
syncs.  Boruvka tests every round, as its last round must see no
cross-component edge.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.graph_ops import (pointer_jump, scatter_drop,
                                        segment_argmax)


_RELAX_CHECK_EVERY = 16   # BFS trips between host tests of the fixpoint


def _relax_until_fixed(dist: torch.Tensor, usrc: torch.Tensor,
                       udst: torch.Tensor) -> torch.Tensor:
    """``dist[v] = min(dist[v], dist[u] + 1)`` over directed edges u -> v,
    repeated to the fixpoint; tests for it every few trips."""
    usrc, udst = usrc.long(), udst.long()
    while True:
        for _ in range(_RELAX_CHECK_EVERY):
            prev = dist
            dist = dist.scatter_reduce(0, udst, dist[usrc] + 1, "amin",
                                       include_self=True)
        if not bool((dist != prev).any()):       # host sync
            return dist


def bfs_dist(n: int, usrc: torch.Tensor, udst: torch.Tensor,
             root) -> torch.Tensor:
    """Unweighted BFS distances from ``root`` via edge relaxation.

    ``usrc``/``udst`` are the directed edge tensors (both orientations).
    Returns int32 distances; unreachable = n (graphs here are connected)."""
    dist = torch.full((n,), n, dtype=torch.int32, device=usrc.device)
    dist[root] = 0
    return _relax_until_fixed(dist, usrc, udst)


def effective_weights(n: int, src, dst, weight, deg, root_dist):
    """Definition 1 (feGRASS): W_eff = w * log(max(deg)) / (d_u + d_v),
    with the degree term floored at log(2), as in the reference.

    ``torch.log`` and XLA's ``log`` round a few arguments differently (7 is
    one); the tree is the same unless that ULP reorders two edges."""
    dmax = torch.maximum(deg[src], deg[dst]).to(torch.float32)
    num = torch.log(torch.clamp(dmax, min=2.0))
    den = (root_dist[src] + root_dist[dst]).to(torch.float32)
    den = torch.clamp(den, min=1.0)
    return weight * num / den


class TreeResult(NamedTuple):
    in_tree: torch.Tensor     # [m] bool — edge is in the spanning tree
    parent: torch.Tensor      # [n] int32 — parent pointer (root -> itself)
    parent_w: torch.Tensor    # [n] float32 — weight of edge to parent
    depth: torch.Tensor       # [n] int32 — hop depth from root
    root: torch.Tensor        # int32 scalar


def boruvka_max_st(n: int, src, dst, eff_w) -> torch.Tensor:
    """Maximum spanning tree over ``eff_w``; returns the [m] bool mask.

    Every component segment-argmaxes its best outgoing edge, hooks to the
    component across it (2-cycles broken to the smaller label), and the
    hooking forest collapses by pointer jumping."""
    m = src.shape[0]
    dev = src.device
    eidx = torch.arange(m, dtype=torch.int32, device=dev)
    varange = torch.arange(n, dtype=torch.int32, device=dev)
    eids2 = torch.cat([eidx, eidx])
    srcl, dstl = src.long(), dst.long()
    neg_inf = torch.tensor(-float("inf"), dtype=eff_w.dtype, device=dev)
    comp = varange
    in_tree = torch.zeros((m,), dtype=torch.bool, device=dev)
    while True:
        cu, cv = comp[srcl], comp[dstl]
        valid = cu != cv
        key = torch.where(valid, eff_w, neg_inf)
        pick, _ = segment_argmax(torch.cat([key, key]), torch.cat([cu, cv]),
                                 n, element_ids=eids2, sentinel=m)
        has = pick < m
        pe = torch.where(has, pick, 0).long()
        ecu, ecv = comp[srcl[pe]], comp[dstl[pe]]
        other = torch.where(ecu == varange, ecv, ecu)
        parent = torch.where(has, other, varange)
        p2 = parent[parent.long()]
        parent = torch.where((p2 == varange) & (varange < parent), varange,
                             parent)
        parent = pointer_jump(parent)
        in_tree = scatter_drop(in_tree, pick, True, has)
        comp = parent[comp.long()]
        if not bool(valid.any()):                # host sync
            return in_tree


def root_tree(n: int, src, dst, weight, in_tree, root) -> TreeResult:
    """Orient the spanning tree away from ``root``: parent/depth/parent_w.

    The depth BFS relaxes over the tree edges only; the reference relaxes
    over all edges with non-tree candidates pushed to ``n``, which never
    lowers a distance, so the result is the same."""
    dev = src.device
    ts, td = src[in_tree], dst[in_tree]
    dist = torch.full((n,), n, dtype=torch.int32, device=dev)
    dist[root] = 0
    depth = _relax_until_fixed(dist, torch.cat([ts, td]),
                               torch.cat([td, ts]))

    # parent[child] = other endpoint for tree edges with depth diff +1.
    srcl, dstl = src.long(), dst.long()
    child_is_dst = in_tree & (depth[dstl] == depth[srcl] + 1)
    child_is_src = in_tree & (depth[srcl] == depth[dstl] + 1)
    parent = torch.arange(n, dtype=torch.int32, device=dev)
    parent = scatter_drop(parent, dst, src, child_is_dst)
    parent = scatter_drop(parent, src, dst, child_is_src)
    parent_w = torch.zeros((n,), dtype=weight.dtype, device=dev)
    parent_w = scatter_drop(parent_w, dst, weight, child_is_dst)
    parent_w = scatter_drop(parent_w, src, weight, child_is_src)
    return TreeResult(in_tree=in_tree, parent=parent, parent_w=parent_w,
                      depth=depth,
                      root=torch.as_tensor(root, dtype=torch.int32,
                                           device=dev))


def build_spanning_tree(n: int, src, dst, weight, *,
                        mode: str = "low_stretch") -> TreeResult:
    """Full step 1: degrees -> root -> BFS -> W_eff -> Boruvka -> rooting.

    ``"low_stretch"`` maximizes the feGRASS effective weights,
    ``"boruvka"`` the raw weights (a plain maximum spanning tree)."""
    deg = torch.bincount(torch.cat([src, dst]).long(), minlength=n)
    deg = deg.to(torch.int32)
    root = torch.argmax(deg).to(torch.int32)
    srcl, dstl = src.long(), dst.long()
    if mode == "low_stretch":
        rd = bfs_dist(n, torch.cat([src, dst]), torch.cat([dst, src]), root)
        eff = effective_weights(n, srcl, dstl, weight, deg, rd)
    elif mode == "boruvka":
        eff = weight
    else:
        raise ValueError(f"unknown tree mode {mode!r}")
    in_tree = boruvka_max_st(n, src, dst, eff)
    return root_tree(n, src, dst, weight, in_tree, root)
