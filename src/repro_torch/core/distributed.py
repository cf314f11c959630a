"""Distributed pdGRASS recovery: the paper's mixed parallel strategy on a mesh.

The port of ``repro.core.distributed``.  The paper parallelizes over
OpenMP threads; here the same two-level decomposition runs over the shards
of a :class:`repro_torch.launch.Mesh`:

  * **Outer parallelism** (Lemma 7: subtasks are disjoint): subtasks are
    bin-packed (LPT) onto shards, and every shard runs the round engine
    (:func:`repro_torch.core.recovery.recover_rounds`) on its own bucket
    with no communication.  On the card each shard marks through K4.
  * **Inner parallelism** (skewed inputs: one subtask holds most off-tree
    edges): the rows of one giant subtask are sharded contiguously.  Each
    round the shards pick their local candidates, exchange them with one
    ``all_gather``, resolve the block (replicated), and mark their own
    rows; a ``psum`` of the open rows decides termination.
  * **Mixed strategy**: subtasks of at least ``cutoff`` rows (paper: 1e5
    edges or 10% of the off-tree edges) go through the inner engine one
    at a time, the rest through the outer engine (the paper's §IV.A).

Every engine returns the status of :func:`recover_serial`, bit for bit.

The mesh is single-controller, as the reference's ``shard_map`` is: one
process drives the shards, and every shard lives on the mesh's device.
A sharded tensor is stacked, shard ``s`` holding ``x[s]``; the shards
exchange data only through :mod:`repro_torch.core.collectives`.  The
reference's in-block ``lax.scan`` is the port's fixpoint
(:func:`repro_torch.core.recovery._resolve_block`), which gives the same
result; its ``lax.while_loop`` is a Python loop with one host sync a round.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import recovery as rec_mod
from repro_torch.core.collectives import all_gather, psum
from repro_torch.core.graph_ops import scatter_drop
from repro_torch.core.recovery import (STATUS_OPEN, STATUS_RECOVERED,
                                       STATUS_SKIPPED, RecoveryProblem,
                                       strict_similarity_matrix)
from repro_torch.kernels import ops as kops
from repro_torch.obs import get_metrics, get_tracer


# ---------------------------------------------------------------------------
# Host-side partitioning (outer parallelism)
# ---------------------------------------------------------------------------

def pad_fill_value(dtype: torch.dtype, *, lowest: bool = False):
    """Per-dtype sentinel for padding slots of the sharded problems.

    ``lowest=True`` asks for the most negative representable value (the
    "never wins an argmax" encoding for scores): ``-inf`` for floats,
    ``iinfo.min`` for signed integers.  ``lowest=False`` asks for the
    ``-1`` invalid marker (tested as ``x >= 0`` downstream).  Unsigned
    integers cannot hold either sentinel (``-1`` would wrap to the largest
    value and turn padding into live data), so they raise, as does any
    dtype that is neither float nor integer."""
    if dtype.is_floating_point:
        return -float("inf") if lowest else -1.0
    if dtype in (torch.uint8, torch.uint16, torch.uint32, torch.uint64):
        raise TypeError(
            f"cannot pad unsigned dtype {dtype}: the -1/-inf sentinels "
            f"would wrap to live values — use a signed or float array")
    if dtype in (torch.int8, torch.int16, torch.int32, torch.int64):
        return torch.iinfo(dtype).min if lowest else -1
    raise TypeError(f"no pad sentinel for dtype {dtype}")


def partition_subtasks(sizes: np.ndarray, n_shards: int,
                       cutoff: int | None = None,
                       cutoff_frac: float = 0.10):
    """LPT bin-packing of subtasks onto shards.

    Returns (shard_of_subtask [S] with -1 = "inner" giant task,
             giant_subtask_ids list, per-shard load)."""
    total = int(sizes.sum())
    if cutoff is None:
        cutoff = int(min(1e5, max(1, cutoff_frac * total)))
    giants = np.flatnonzero(sizes >= cutoff)
    shard_of = np.full(sizes.shape[0], -1, dtype=np.int32)
    load = np.zeros(n_shards, dtype=np.int64)
    order = np.argsort(-sizes)
    for s in order:
        if sizes[s] >= cutoff:
            continue
        tgt = int(np.argmin(load))
        shard_of[s] = tgt
        load[tgt] += int(sizes[s])
    return shard_of, giants.tolist(), load


class ShardedProblem(NamedTuple):
    """``[n_shards, m_loc]`` stacked per-shard recovery problems."""

    sig_u: torch.Tensor
    sig_v: torch.Tensor
    beta: torch.Tensor
    seg: torch.Tensor
    score: torch.Tensor
    # maps local rows back to rows of the flat (sorted) problem; -1 = pad
    src_row: torch.Tensor


def build_outer_shards(problem: RecoveryProblem, seg_sizes: np.ndarray,
                       shard_of: np.ndarray, n_shards: int,
                       chunk: int = 2048) -> ShardedProblem:
    """Each shard's rows: the rows of its subtasks in problem order, padded
    to a common multiple of ``chunk``.  The plan is made on the host from
    ``seg``; the rows are gathered on the problem's device.

    Subtasks are contiguous and ascending, so a shard's rows in problem
    order are its subtasks' rows in the order of their starts, as the
    reference lists them (``seg_sizes`` is implied by ``seg``)."""
    del seg_sizes
    seg = problem.seg.cpu().numpy()
    row_shard = np.where(seg >= 0, shard_of[np.maximum(seg, 0)], -1)
    rows = [np.flatnonzero(row_shard == sh) for sh in range(n_shards)]
    m_loc = max([chunk] + [-(-r.shape[0] // chunk) * chunk for r in rows])
    src_row = np.full((n_shards, m_loc), -1, dtype=np.int64)
    for sh, r in enumerate(rows):
        src_row[sh, :r.shape[0]] = r
    src = torch.as_tensor(src_row, device=problem.seg.device)
    keep = src >= 0
    take = torch.where(keep, src, 0)

    def gather(x, *, lowest=False):
        fill = torch.tensor(pad_fill_value(x.dtype, lowest=lowest),
                            dtype=x.dtype, device=x.device)
        shape = keep.shape + (1,) * (x.dim() - 1)
        return torch.where(keep.view(shape), x[take], fill)

    return ShardedProblem(
        sig_u=gather(problem.sig_u), sig_v=gather(problem.sig_v),
        beta=gather(problem.beta), seg=gather(problem.seg),
        score=gather(problem.score, lowest=True), src_row=src)


# ---------------------------------------------------------------------------
# Outer engine: the round engine on every shard (no collectives)
# ---------------------------------------------------------------------------

def recover_outer(sharded: ShardedProblem, mesh, axis: str = "data",
                  block_size: int = 16, max_candidates: int = 128,
                  chunk: int = 2048):
    """Run the round engine on every shard's bucket, shard by shard.

    Returns (status ``[P, m_loc]`` int8, rounds: a list of each shard's
    round count)."""
    del mesh, axis   # the stacked layout carries the shard count
    statuses, rounds = [], []
    for s in range(sharded.seg.shape[0]):
        prob = RecoveryProblem(sharded.sig_u[s], sharded.sig_v[s],
                               sharded.beta[s], sharded.seg[s],
                               sharded.score[s])
        status, stats = rec_mod.recover_rounds(
            prob, block_size=block_size, max_candidates=max_candidates,
            stop_at_target=False, chunk=chunk)
        statuses.append(status)
        rounds.append(stats.rounds)
    return torch.stack(statuses), rounds


# ---------------------------------------------------------------------------
# Inner engine: one giant subtask sharded over the mesh
# ---------------------------------------------------------------------------

class InnerRound(NamedTuple):
    """What a round of the inner engine needs beside the status: the
    constants of its shapes, made once by :func:`inner_init`."""

    n_sh: int
    block_size: int
    arange: torch.Tensor     # [m_loc] int32 row ids
    later: torch.Tensor      # [B, B] bool, column after row
    eseg: torch.Tensor       # [P, m_loc] int32: 0 on edges, -1 on padding
    cseg: torch.Tensor       # [B] int32 zeros: the candidates' subtask


def inner_init(seg, n_sh: int, block_size: int):
    """The engine's first status ``[P, m_loc]`` int8 (open on edge rows,
    skipped on padding) and its :class:`InnerRound`."""
    m_loc = seg.shape[1]
    dev = seg.device
    B = block_size
    is_edge = seg >= 0
    status = torch.where(is_edge, STATUS_OPEN, STATUS_SKIPPED).to(torch.int8)
    # every row in subtask 0, padding in none (K4's same-subtask test)
    return status, InnerRound(
        n_sh=n_sh, block_size=B,
        arange=torch.arange(m_loc, dtype=torch.int32, device=dev),
        later=(torch.arange(B, device=dev)[None, :]
               > torch.arange(B, device=dev)[:, None]),
        eseg=torch.where(is_edge, 0, -1).to(torch.int32),
        cseg=torch.zeros((B,), dtype=torch.int32, device=dev))


def inner_open(status) -> bool:
    """The loop test: a ``psum`` of every shard's open rows (int32, as the
    reference's), read on the host."""
    return bool(psum((status == STATUS_OPEN).sum(dim=1, dtype=torch.int32))
                > 0)                                            # host sync


def inner_round(sig_u, sig_v, beta, status, r: InnerRound):
    """One round of the inner engine over the stacked shards ``[P,
    m_loc]``: the block of the next ``B`` open rows by global rank, one
    ``all_gather`` of its candidate pack (and one of each shard's open
    count), its resolution, and every shard's rows marked against its
    recovered candidates.  Returns (the new status, the block's marking
    betas ``[B]``: a recovered candidate's beta, else -1).

    The marking pass marks each shard's rows against the block's recovered
    candidates: the function of K4 with every row in one subtask, so it
    runs through :func:`repro_torch.kernels.ops.similarity_mark`, which
    launches K4 on the card and runs its plain version on the CPU."""
    n_sh, B, m_loc = r.n_sh, r.block_size, status.shape[1]
    dev = status.device
    avail = status == STATUS_OPEN
    ones = avail.to(torch.int32)
    local_cum = torch.cumsum(ones, dim=1, dtype=torch.int32)
    # exclusive prefix over the shards of their open counts
    all_tot = all_gather(local_cum[:, -1])                     # [n_sh]
    base = torch.cumsum(all_tot, 0, dtype=torch.int32) - all_tot
    rank = base[:, None] + local_cum - ones                    # global rank
    cand = avail & (rank < B)

    # each shard's candidates (at most B), then one all_gather
    cidx = torch.sort(torch.where(cand, r.arange, m_loc), dim=1)[0][:, :B]
    cvalid = cidx < m_loc
    ci = torch.where(cvalid, cidx, 0).long()
    crank = torch.where(cvalid, torch.gather(rank, 1, ci), B)
    rows = torch.arange(n_sh, device=dev)[:, None]
    pack = (sig_u[rows, ci], sig_v[rows, ci],
            torch.where(cvalid, torch.gather(beta, 1, ci), -1), crank)
    g_su, g_sv, g_beta, g_rank = (all_gather(x, tiled=True)
                                  for x in pack)              # [n_sh * B]
    # order by global rank; invalid slots have rank B and sort last
    order = torch.argsort(g_rank, stable=True)[:B]
    k_su, k_sv = g_su[order], g_sv[order]
    k_beta, k_rank = g_beta[order], g_rank[order]
    k_valid = k_beta >= 0

    # the in-block resolution, replicated: every shard computes the
    # same bits, so it runs once
    sim = strict_similarity_matrix(k_su, k_sv, k_beta, k_su, k_sv)
    sim = sim & r.later & k_valid[:, None] & k_valid[None, :]
    recovered_k = k_valid & ~rec_mod._resolve_block(sim)

    # write back the statuses of each shard's candidates, by rank
    hit = crank[:, :, None] == k_rank[None, None, :]          # [P, B, B]
    rec_my = (hit & recovered_k[None, None, :]).any(dim=2)
    new = torch.where(rec_my, STATUS_RECOVERED,
                      STATUS_SKIPPED).to(torch.int8)
    mark_beta = torch.where(recovered_k, k_beta, -1)          # -1 disables
    out = []
    for s in range(n_sh):
        st = scatter_drop(status[s], cidx[s], new[s], cvalid[s])
        kill = kops.similarity_mark(k_su, k_sv, mark_beta, r.cseg,
                                    sig_u[s], sig_v[s], r.eseg[s])
        kill = kill & (st == STATUS_OPEN)
        out.append(torch.where(kill, STATUS_SKIPPED, st).to(torch.int8))
    return torch.stack(out), mark_beta


def _inner_round_engine(sig_u, sig_v, beta, seg, n_sh: int,
                        block_size: int):
    """Round engine for one subtask whose rows are sharded ``[P, m_loc]``:
    :func:`inner_round` while :func:`inner_open` finds an open row (one
    host sync a round).  ``n_sh`` is the static shard count, read from the
    mesh by :func:`recover_inner`.  Returns (status ``[P, m_loc]`` int8,
    rounds)."""
    status, r = inner_init(seg, n_sh, block_size)
    rounds = 0
    while inner_open(status):
        status, _ = inner_round(sig_u, sig_v, beta, status, r)
        rounds += 1
    return status, rounds


def recover_inner(sig_u, sig_v, beta, seg, mesh, axis="data",
                  block_size: int = 32, chunk: int = 2048):
    """The inner engine for one giant subtask, its rows (a multiple of the
    shard count) split contiguously over ``axis``: one axis name, or a
    tuple of them flattened in order, as the reference's ``P(axes)``
    flattens them.  Returns (status ``[m]`` int8, rounds).

    The engine reads its shard count from the mesh, a static int, and
    never from a collective.  ``chunk`` is the reference's marking tile;
    K4 and its plain version tile on their own, so it does not change the
    result."""
    del chunk
    n_sh = _mesh_shards(mesh, axis)

    def shard(x):
        return x.reshape((n_sh, -1) + tuple(x.shape[1:]))

    status, rounds = _inner_round_engine(shard(sig_u), shard(sig_v),
                                         shard(beta), shard(seg), n_sh,
                                         block_size)
    return status.reshape(-1), rounds


# ---------------------------------------------------------------------------
# Mixed strategy: giants inner, the rest outer
# ---------------------------------------------------------------------------

def _mesh_shards(mesh, axis) -> int:
    axes = [axis] if isinstance(axis, str) else list(axis)
    return int(np.prod([mesh.shape[a] for a in axes]))


def recover_mixed(prepared, mesh, axis: str = "data",
                  block_size: int = 16, max_candidates: int = 128,
                  chunk: int = 2048, cutoff: int | None = None
                  ) -> torch.Tensor:
    """The full distributed recovery: giant subtasks through the inner
    engine, the rest through LPT outer buckets.  Returns status ``[m]``
    int8 on the problem's device, aligned with the prepared order and
    equal to :func:`recover_serial`'s bit for bit.

    The problem must lie on the mesh's device."""
    prob = prepared.problem
    dev = prob.seg.device
    mesh.check_device(dev, "the problem")
    n_shards = _mesh_shards(mesh, axis)
    shard_of, giants, _ = partition_subtasks(
        prepared.subtask_sizes, n_shards, cutoff=cutoff)

    m = prob.m
    status_global = torch.full((m,), STATUS_SKIPPED, dtype=torch.int8,
                               device=dev)
    seg_np = prob.seg.cpu().numpy()
    tracer = get_tracer()
    metrics = get_metrics()
    metrics.inc("dist.recoveries")
    with tracer.span("dist.recover_mixed", n_shards=n_shards,
                     giants=len(giants), m=m) as msp:
        # --- inner engine for each giant subtask, one at a time ---
        starts = np.flatnonzero(
            np.concatenate([[True], seg_np[1:] != seg_np[:-1]]))
        start_of = {int(seg_np[s]): int(s) for s in starts if seg_np[s] >= 0}
        inner_rounds = 0
        for sid in giants:
            st = start_of[sid]
            sz = int(prepared.subtask_sizes[sid])
            m_loc = -(-sz // (n_shards * chunk)) * chunk
            m_tot = m_loc * n_shards

            def pad(x):
                out = torch.full((m_tot,) + tuple(x.shape[1:]),
                                 pad_fill_value(x.dtype), dtype=x.dtype,
                                 device=dev)
                out[:sz] = x[st:st + sz]
                return out

            bs = max(block_size, 32)
            with tracer.span("dist.inner", subtask=int(sid), edges=sz,
                             m_tot=m_tot) as isp:
                status, rounds = recover_inner(
                    pad(prob.sig_u), pad(prob.sig_v), pad(prob.beta),
                    pad(prob.seg), mesh, axis=axis, block_size=bs,
                    chunk=chunk)
                status_global[st:st + sz] = status[:sz]
                # per-round collective payload: one all_gather of the
                # candidate pack (two signature blocks + beta + rank) from
                # every shard, the engine's only communication
                c1 = int(prob.sig_u.shape[1])
                pack_bytes = n_shards * bs * (2 * c1 * 4 + 4 + 4)
                isp.set(rounds=rounds, collective_bytes=rounds * pack_bytes)
                metrics.inc("dist.inner_rounds", rounds)
                metrics.inc("dist.collective_bytes", rounds * pack_bytes)
            inner_rounds += rounds

        # --- outer engine for everything else ---
        outer_rounds = 0
        if np.any(shard_of >= 0):
            with tracer.span("dist.outer", n_shards=n_shards) as osp:
                sharded = build_outer_shards(prob, prepared.subtask_sizes,
                                             shard_of, n_shards, chunk=chunk)
                status, rounds = recover_outer(
                    sharded, mesh, axis=axis, block_size=block_size,
                    max_candidates=max_candidates, chunk=chunk)
                src = sharded.src_row.reshape(-1)
                ok = src >= 0
                status_global[src[ok]] = status.reshape(-1)[ok]
                outer_rounds = max(rounds) if rounds else 0
                osp.set(rounds=outer_rounds)
                metrics.inc("dist.outer_rounds", outer_rounds)
        msp.set(inner_rounds=inner_rounds, outer_rounds=outer_rounds)
    return status_global
