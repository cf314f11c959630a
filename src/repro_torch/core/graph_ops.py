"""Flat-tensor device primitives for label/propose/accept graph work.

The port of ``repro.core.graph_ops``:

  * :func:`segment_argmax`          — per-segment argmax under the
    (value, min element id) total order.
  * :func:`handshake`               — an edge wins iff both endpoints
    proposed it.
  * :func:`propose_accept_matching` — locally dominant heavy-edge matching;
    equals the sequential greedy matching bit for bit.
  * :func:`pointer_jump`            — parent forest -> roots by doubling.
  * :func:`compact_labels`          — order-preserving dense relabel.
  * :func:`coalesce_edges`          — relabel + merge an edge list.

Mesh-sharded variants sit beside them, with the edges row-sharded over a
:class:`repro_torch.launch.Mesh`: a sharded argument is stacked, shard
``s`` holding ``x[s]`` (``[P, ...]``), and results are replicated.  Each
shard reduces its own elements, then the collectives of
:mod:`repro_torch.core.collectives` combine the shards under the same
total orders, so each is bit-identical to its single-device counterpart:

  * :func:`sharded_segment_argmax` — a ``pmax`` settles the best value, a
    ``pmin`` over the global element ids that attain it the winner.
  * :func:`sharded_matching`       — :func:`propose_accept_matching` with
    the proposal sweep sharded; accepted writes merge by ``pmax``.
  * :func:`sharded_coalesce_edges` — a local coalesce per shard, an
    ``all_gather``, a final merge (coarse weights equal up to the order
    of their float sums).

Two helpers stand in for JAX idioms that PyTorch lacks:

  * :func:`scatter_drop` — JAX's ``.at[i].set(v, mode="drop")``.  PyTorch
    has no drop mode and a CUDA index out of range is a device assert, so
    masked-out writes are routed to one scratch slot past the end and
    sliced away.
  * :func:`ordered_segment_sum` — JAX's float ``.at[i].add`` as XLA runs it
    on the CPU: each segment summed left to right from zero.
    ``index_add_`` on CUDA uses atomics, whose order changes from run to
    run; this loop over segment positions gives the same bits on every
    run and on either device.

Loops that JAX runs as ``lax.while_loop`` are Python loops here, each
ending on a host sync of its termination test.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.collectives import all_gather, pmax, pmin, psum

INT32_MAX = torch.iinfo(torch.int32).max
_JUMP_CHECK_EVERY = 4   # doublings between host tests in pointer_jump


def scatter_drop(target: torch.Tensor, index: torch.Tensor,
                 values, keep: torch.Tensor) -> torch.Tensor:
    """``target.at[where(keep, index, OOB)].set(values, mode="drop")``.

    Returns a new tensor; ``values`` may be a tensor shaped like ``index``
    or a Python scalar.  Kept indices must be in range."""
    n = target.shape[0]
    buf = torch.cat([target, target[:1]])
    if not torch.is_tensor(values):
        values = torch.full_like(index, values, dtype=target.dtype)
    buf.scatter_(0, torch.where(keep, index, n).long(),
                 values.to(target.dtype))
    return buf[:n]


def ordered_segment_sum(values: torch.Tensor, ids: torch.Tensor,
                        num_segments: int,
                        init: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Segment sums, each taken left to right in the order of ``values``.

    ``ids`` [N] holds each value's segment (any order; ids out of
    ``[0, num_segments)`` are dropped); ``values`` is [N] or [N, k].
    Segment ``s`` gets ``((init[s] + v_0) + v_1) + ...`` over its values in
    index order, which is the order of a sequential scatter-add.  One host
    sync (the longest segment) and one vectorized step per position."""
    dev = values.device
    tail = values.shape[1:]
    out = (torch.zeros((num_segments,) + tail, dtype=values.dtype,
                       device=dev) if init is None else init.clone())
    keep = (ids >= 0) & (ids < num_segments)
    ids = torch.where(keep, ids, num_segments).long()
    order = torch.argsort(ids, stable=True)
    # an integer index_add: bincount's exact counts, without the host read
    # of max(ids) that bincount makes on a CUDA device to size its output
    counts = torch.zeros((num_segments + 1,), dtype=torch.int64,
                         device=dev).index_add_(
        0, ids, torch.ones_like(ids))[:num_segments]
    if values.shape[0] == 0:
        return out
    start = torch.cumsum(counts, 0) - counts
    v_sorted = values[order]
    # analysis: allow(audit-host-transfer): the loop bound, once a call
    longest = int(counts.max())           # host sync: the loop bound
    for t in range(longest):
        live = counts > t
        pos = torch.where(live, start + t, 0)
        if tail:
            live = live.view((-1,) + (1,) * len(tail))
        out = torch.where(live, out + v_sorted[pos], out)
    return out


def segment_argmax(values: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, *,
                   element_ids: Optional[torch.Tensor] = None,
                   sentinel: Optional[int] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment argmax under the (value, minimal element id) order.

    Returns ``(pick, best)``: ``pick[s]`` the winning element id of segment
    ``s`` and ``best[s]`` its value.  Empty or all ``-inf`` segments get
    ``pick == sentinel`` (default ``len(values)``) and ``best == -inf``.
    Out-of-range ``segment_ids`` are dropped.  Max and min are exact and
    commutative, so the CUDA scatter's atomics give deterministic results.
    """
    k = values.shape[0]
    dev = values.device
    if element_ids is None:
        element_ids = torch.arange(k, dtype=torch.int32, device=dev)
    if sentinel is None:
        sentinel = k
    inside = (segment_ids >= 0) & (segment_ids < num_segments)
    segs = torch.where(inside, segment_ids, num_segments).long()
    best = torch.full((num_segments + 1,), -float("inf"),
                      dtype=values.dtype, device=dev)
    best = best.scatter_reduce(0, segs, values, "amax", include_self=True)
    is_best = inside & (values == best[segs]) & (values > -float("inf"))
    big = torch.iinfo(element_ids.dtype).max
    pick = torch.full((num_segments + 1,), big, dtype=element_ids.dtype,
                      device=dev)
    pick = pick.scatter_reduce(0, torch.where(is_best, segs, num_segments),
                               element_ids, "amin", include_self=True)
    pick = pick[:num_segments]
    pick = torch.where(pick == big, torch.full_like(pick, sentinel), pick)
    return pick, best[:num_segments]


def handshake(prop: torch.Tensor, src: torch.Tensor, dst: torch.Tensor
              ) -> torch.Tensor:
    """Symmetric accept: edge ``e`` wins iff both endpoints propose it."""
    e = torch.arange(src.shape[0], dtype=prop.dtype, device=prop.device)
    return (prop[src] == e) & (prop[dst] == e)


def pointer_jump(parent: torch.Tensor) -> torch.Tensor:
    """Collapse a parent forest to its roots: ``p[v] -> root(v)``.

    The reference's ``lax.while_loop`` (``graph_ops.py:130``) becomes a
    Python loop that tests for the fixpoint on the host every
    ``_JUMP_CHECK_EVERY`` doublings: once converged, ``p = p[p]`` is the
    identity, so the extra doublings change nothing."""
    p = parent
    while True:
        for _ in range(_JUMP_CHECK_EVERY):
            p = p[p]
        if not bool((p[p] != p).any()):          # host sync
            return p


def compact_labels(labels: torch.Tensor, num_labels: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Order-preserving dense relabel: ids in [0, num_labels) -> 0..k-1.

    Returns ``(dense, k)``; labels out of range are dropped from ``k``."""
    used = torch.zeros((num_labels,), dtype=torch.int32,
                       device=labels.device)
    inside = (labels >= 0) & (labels < num_labels)
    used = scatter_drop(used, labels, 1, inside)
    new_id = (torch.cumsum(used, 0, dtype=torch.int32) - 1).to(labels.dtype)
    return new_id[torch.where(inside, labels, 0).long()], used.sum()


def propose_accept_matching(n: int, src: torch.Tensor, dst: torch.Tensor,
                            weight: torch.Tensor) -> torch.Tensor:
    """Heavy-edge maximal matching by propose/accept rounds; ``mate[v]`` or -1.

    Each round every free vertex proposes its heaviest alive edge under the
    strict (weight, -edge id) order and mutually proposed edges match —
    exactly the sequential greedy matching.  The rounds'
    ``lax.while_loop`` (``graph_ops.py:184``) is a Python loop with one host
    sync per round."""
    m = src.shape[0]
    dev = src.device
    eidx = torch.arange(m, dtype=torch.int32, device=dev)
    heads = torch.cat([src, dst])
    eids2 = torch.cat([eidx, eidx])
    w2 = torch.cat([weight, weight])
    mate = torch.full((n,), -1, dtype=torch.int32, device=dev)
    neg_inf = torch.full((), -float("inf"), dtype=weight.dtype, device=dev)
    while True:
        free = mate < 0
        alive = free[src] & free[dst]
        alive2 = torch.cat([alive, alive])
        vals = torch.where(alive2, w2, neg_inf)
        prop, _ = segment_argmax(vals, heads, n, element_ids=eids2,
                                 sentinel=m)
        accept = handshake(prop, src, dst)
        mate = scatter_drop(mate, src, dst, accept)
        mate = scatter_drop(mate, dst, src, accept)
        # analysis: allow(audit-host-transfer): the matching's round test
        if not bool(alive.any()):                # host sync
            return mate


def coalesce_edges(src: torch.Tensor, dst: torch.Tensor,
                   weight: torch.Tensor, labels: torch.Tensor,
                   num_labels: int):
    """Relabel an edge list through ``labels`` and merge the result.

    Intra-cluster edges drop; parallel coarse edges merge with their weights
    summed in edge order.  Returns ``(csrc, cdst, cw, m_coarse)`` of the
    input length ``m``; the first ``m_coarse`` entries are valid, canonical
    (``csrc < cdst``) and sorted by (csrc, cdst).  ``jnp.lexsort`` becomes
    two stable sorts, secondary key first."""
    del num_labels  # kept for API symmetry; the sort is label-range-free
    m = src.shape[0]
    dev = src.device
    cu, cv = labels[src], labels[dst]
    valid = cu != cv
    big = torch.full((), INT32_MAX, dtype=torch.int32, device=dev)
    lo = torch.where(valid, torch.minimum(cu, cv).to(torch.int32), big)
    hi = torch.where(valid, torch.maximum(cu, cv).to(torch.int32), big)
    order = torch.argsort(hi, stable=True)
    order = order[torch.argsort(lo[order], stable=True)]
    lo_s, hi_s = lo[order], hi[order]
    w_s, valid_s = weight[order], valid[order]
    first = valid_s & torch.cat(
        [torch.ones((1,), dtype=torch.bool, device=dev),
         (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])])
    uid = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    cw = ordered_segment_sum(w_s, torch.where(valid_s, uid, m), m)
    zeros = torch.zeros((m,), dtype=torch.int32, device=dev)
    csrc = scatter_drop(zeros, uid, lo_s, first)
    cdst = scatter_drop(zeros, uid, hi_s, first)
    return csrc, cdst, cw, first.sum()


# ---------------------------------------------------------------------------
# Mesh-sharded variants: [P, ...] stacked shards in, replicated results out
# ---------------------------------------------------------------------------

def sharded_segment_argmax(values: torch.Tensor, segment_ids: torch.Tensor,
                           num_segments: int, *, element_ids: torch.Tensor,
                           sentinel: Optional[int] = None,
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`segment_argmax` with the elements sharded (``[P, E]`` each).

    ``element_ids`` must carry global ids, unique across shards: local ids
    would collide between shards and corrupt the tie-break."""
    big = torch.iinfo(element_ids.dtype).max
    local = [segment_argmax(values[s], segment_ids[s], num_segments,
                            element_ids=element_ids[s], sentinel=big)
             for s in range(values.shape[0])]
    pick_l = torch.stack([p for p, _ in local])
    best_l = torch.stack([b for _, b in local])
    best = pmax(best_l)
    cand = torch.where((best_l == best) & (best > -float("inf")), pick_l,
                       big)
    pick = pmin(cand)
    if sentinel is None:
        sentinel = big
    return torch.where(pick == big, torch.full_like(pick, sentinel),
                       pick), best


def sharded_matching(n: int, src: torch.Tensor, dst: torch.Tensor,
                     weight: torch.Tensor, edge_ids: torch.Tensor
                     ) -> torch.Tensor:
    """:func:`propose_accept_matching` with the edge list sharded
    (``[P, m_loc]`` each); returns the replicated ``[n]`` ``mate``.

    ``edge_ids`` holds every slot's global edge id, ``-1`` on padding.
    Accepted edges are vertex-disjoint over the whole mesh, so at most one
    shard writes a vertex and a ``pmax`` merges the writes.  One host sync
    a round, on the ``psum`` of the alive edges."""
    dev = src.device
    valid = edge_ids >= 0
    heads = torch.cat([src, dst], dim=1)
    eids2 = torch.cat([edge_ids, edge_ids], dim=1)
    w2 = torch.cat([weight, weight], dim=1)
    none = torch.full((n,), -1, dtype=torch.int32, device=dev)
    mate = none
    neg_inf = torch.full((), -float("inf"), dtype=weight.dtype, device=dev)
    while True:
        free = mate < 0
        alive = valid & free[src] & free[dst]
        vals = torch.where(torch.cat([alive, alive], dim=1), w2, neg_inf)
        prop, _ = sharded_segment_argmax(vals, heads, n, element_ids=eids2,
                                         sentinel=INT32_MAX)
        accept = alive & (prop[src] == edge_ids) & (prop[dst] == edge_ids)
        upd = torch.stack([
            scatter_drop(scatter_drop(none, src[s], dst[s], accept[s]),
                         dst[s], src[s], accept[s])
            for s in range(src.shape[0])])
        upd = pmax(upd)
        mate = torch.where(upd >= 0, upd, mate)
        if not bool(psum(alive.sum(dim=1)) > 0):     # host sync
            return mate


def sharded_coalesce_edges(src: torch.Tensor, dst: torch.Tensor,
                           weight: torch.Tensor, labels: torch.Tensor,
                           num_labels: int):
    """:func:`coalesce_edges` with the edge list sharded (``[P, m_loc]``).

    Two phases: every shard coalesces its own slice (parallel duplicates
    within a shard merge there), then one ``all_gather`` of the merged
    lists feeds a final replicated merge.  Padding slots (``src == dst``)
    drop in phase one.  The output has the layout of
    :func:`coalesce_edges` over the gathered length ``P * m_loc``."""
    local = [coalesce_edges(src[s], dst[s], weight[s], labels, num_labels)
             for s in range(src.shape[0])]
    g_src, g_dst, g_w = (all_gather(torch.stack([part[i] for part in local]),
                                    tiled=True) for i in range(3))
    # phase two relabels through the identity: entries are already coarse
    # ids, and phase one's empty slots are (0, 0), which drop again
    ident = torch.arange(num_labels, dtype=torch.int32, device=src.device)
    return coalesce_edges(g_src, g_dst, g_w, ident, num_labels)
