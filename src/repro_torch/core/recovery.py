"""Step 4 of pdGRASS: strict-similarity off-tree edge recovery.

The port of ``repro.core.recovery``.  Two engines, bit-identical on the
same input:

  * :func:`recover_serial` — numpy oracle, the paper's sequential
    per-subtask greedy (Algorithm 1, step 4).
  * :func:`recover_rounds` — the round engine.  Each round takes, for every
    open subtask, its first ``block_size`` unprocessed edges (capped at
    ``max_candidates`` overall), resolves their order inside the block
    (Lemma 8), then marks the rest of each subtask against the newly
    recovered edges.

Where the port departs in form from the reference (never in result):

  * The rounds' ``lax.while_loop`` (``recovery.py:290``) is a Python loop
    that tests its condition on the host EVERY round.  With
    ``stop_at_target=True`` one extra round recovers more edges, which
    changes what ``select_top`` sees and ``stats.rounds``.
  * The K x K in-block ``lax.scan`` (``recovery.py:219-233``) is a 128-step
    sequential pass.  Its result is the unique fixpoint of
    ``alive[i] = not any(alive[j] & sim[j, i] for j < i)``; the port
    iterates that map on the whole block (each pass fixes at least one
    more leading entry) and tests for the fixpoint on the host every few
    passes.  Chains of similar candidates are short, so this is a handful
    of tensor ops instead of 128 Python steps.
  * The marking pass takes its route from the problem's device, where the
    reference takes the flag ``use_kernel`` (default off).  On a CUDA
    problem it is the reference's kernel route (``recovery.py:241-245``):
    kernel K4 over every row, one launch a round, no host sync.  On a CPU
    problem it is the chunked pass (``recovery.py:247-273``, ``lax.map``
    with a ``lax.cond`` per chunk): the active-chunk mask is computed on
    the device, its indices taken with one host sync per round, and the
    rows of only those chunks marked in one batched op, each against the
    at most ``block_size`` candidates of its own subtask, not all K.  An
    explicit ``use_kernel`` picks the route on either device; both routes
    give the same status.
  * ``mode="drop"`` scatters are masked explicitly (``scatter_drop``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.graph_ops import scatter_drop
from repro_torch.kernels import ops as kops
from repro_torch.obs.device import synced_span

STATUS_OPEN = 0       # not yet processed
STATUS_RECOVERED = 1  # recovered into the sparsifier
STATUS_SKIPPED = 2    # marked strictly similar to an earlier recovered edge


class RecoveryProblem(NamedTuple):
    """Flat per-off-tree-edge tensors, sorted by (subtask asc, score desc).

    Padding rows (to a multiple of the chunk size) carry ``seg == -1``.
    """

    sig_u: torch.Tensor   # [m, c+1] int32 ancestor signature of endpoint u
    sig_v: torch.Tensor   # [m, c+1] int32 ancestor signature of endpoint v
    beta: torch.Tensor    # [m] int32  beta* = min(d(u,lca), d(v,lca), c)
    seg: torch.Tensor     # [m] int32  contiguous subtask ids (-1 = padding)
    score: torch.Tensor   # [m] float32 spectral criticality (w * R_T)

    @property
    def m(self) -> int:
        return int(self.sig_u.shape[0])


# ---------------------------------------------------------------------------
# Similarity predicate (shared by both engines)
# ---------------------------------------------------------------------------

def _apb_table(c1: int) -> np.ndarray:
    a = np.arange(c1)
    return (a[:, None] + a[None, :]).astype(np.int32)  # [c1, c1]


def match_table(sig_a, sig_b, beta_a):
    """``[..., I, c1]`` x ``[..., J, c1]`` -> ``[..., I, J]`` bool: tree
    distance(a_i, b_j) <= beta_a[i]."""
    c1 = sig_a.shape[-1]
    apb = torch.as_tensor(_apb_table(c1), device=sig_a.device)
    eq = sig_a[..., :, None, :, None] == sig_b[..., None, :, None, :]
    ok = eq & (apb <= beta_a[..., :, None, None, None])
    return ok.flatten(-2).any(-1)


def strict_similarity_matrix(sig_u_a, sig_v_a, beta_a, sig_u_b, sig_v_b):
    """[I, J] bool: edge a_i (recovered) marks edge b_j (Definition 5)."""
    m_uu = match_table(sig_u_a, sig_u_b, beta_a)
    m_vv = match_table(sig_v_a, sig_v_b, beta_a)
    m_uv = match_table(sig_u_a, sig_v_b, beta_a)
    m_vu = match_table(sig_v_a, sig_u_b, beta_a)
    return (m_uu & m_vv) | (m_uv & m_vu)


def _pair_match(sig_a, sig_b, beta_a):
    """Row-wise match: ``[R, S, c1]`` x ``[R, c1]`` -> ``[R, S]`` bool."""
    c1 = sig_a.shape[-1]
    apb = torch.as_tensor(_apb_table(c1), device=sig_a.device)
    eq = sig_a[:, :, :, None] == sig_b[:, None, None, :]
    ok = eq & (apb <= beta_a[:, :, None, None])
    return ok.flatten(-2).any(-1)


# ---------------------------------------------------------------------------
# Serial oracle (numpy) — faithful transcription of the paper's step 4
# ---------------------------------------------------------------------------

def recover_serial(prob: RecoveryProblem) -> np.ndarray:
    """Greedy in-order recovery per subtask; returns status[m] (numpy).

    Each recovered row ``i`` skips every later open row of its subtask
    that it strictly-similarity marks: ``(uu & vv) | (uv & vu)``, each a
    test of some ancestor pair ``(a, b)`` with ``a + b <= beta[i]`` equal.
    The tests take only those pairs, one signature column at a time, and
    ``vv`` (``vu``) only on the rows that ``uu`` (``uv``) found."""
    sig_u = prob.sig_u.cpu().numpy()
    sig_v = prob.sig_v.cpu().numpy()
    beta = prob.beta.cpu().numpy()
    seg = prob.seg.cpu().numpy()
    m = seg.shape[0]
    status = np.full(m, STATUS_SKIPPED, dtype=np.int8)
    status[seg >= 0] = STATUS_OPEN

    bounds = np.flatnonzero(np.diff(np.concatenate([[-2], seg])) != 0)
    bounds = np.concatenate([bounds, [m]])
    c1 = sig_u.shape[1]
    cols_u, cols_v = np.ascontiguousarray(sig_u.T), np.ascontiguousarray(
        sig_v.T)                                          # [c1, m]

    def in_hood(sig_x, ys, b):
        """[R]: some ancestor pair of ``sig_x`` and a column of ``ys [c1,
        R]`` with ``a + bb <= b`` is equal."""
        hit = np.zeros(ys.shape[1], dtype=bool)
        for a in range(min(b, c1 - 1) + 1):
            for bb in range(min(b - a, c1 - 1) + 1):
                hit |= ys[bb] == sig_x[a]
        return hit

    for s in range(len(bounds) - 1):
        lo, hi = bounds[s], bounds[s + 1]
        if lo >= m or seg[lo] < 0:
            continue
        for i in range(lo, hi):
            if status[i] != STATUS_OPEN:
                continue
            status[i] = STATUS_RECOVERED
            rest = np.arange(i + 1, hi)
            rest = rest[status[rest] == STATUS_OPEN]
            if rest.size == 0:
                continue
            b = int(beta[i])
            yu, yv = cols_u[:, rest], cols_v[:, rest]
            sim = np.zeros(rest.size, dtype=bool)
            uu = np.flatnonzero(in_hood(sig_u[i], yu, b))
            sim[uu[in_hood(sig_v[i], yv[:, uu], b)]] = True
            uv = np.flatnonzero(in_hood(sig_u[i], yv, b))
            sim[uv[in_hood(sig_v[i], yu[:, uv], b)]] = True
            status[rest[sim]] = STATUS_SKIPPED
    return status


# ---------------------------------------------------------------------------
# Round engine
# ---------------------------------------------------------------------------

class RoundStats(NamedTuple):
    rounds: int            # number of rounds executed
    candidates: int        # total candidates examined
    killed_in_block: int   # candidates killed inside blocks


# fixpoint passes between host tests in _resolve_block
_BLOCK_CHECK_EVERY = 4
# rows marked in one batched op (bounds the [rows, block, c1, c1] temporaries)
_MARK_ROWS = 1 << 16


def _resolve_block(sim: torch.Tensor) -> torch.Tensor:
    """``killed[i]`` of the in-order greedy over a block whose ``sim[j, i]``
    (only j < i set) says candidate j marks candidate i.

    Iterates ``killed = any_j(alive[j] & sim[j, :])`` from all-alive to its
    fixpoint, which is the in-order scan's result."""
    simf = sim.to(torch.float32)
    killed = torch.zeros(sim.shape[0], dtype=torch.bool, device=sim.device)
    while True:
        for _ in range(_BLOCK_CHECK_EVERY):
            prev = killed
            killed = ((~killed).to(torch.float32) @ simf) > 0
        if not bool((killed != prev).any()):     # host sync
            return killed


def recover_rounds(prob: RecoveryProblem, target: int = 2**31 - 1, *,
                   block_size: int = 16, max_candidates: int = 128,
                   stop_at_target: bool = False, chunk: int = 2048,
                   use_kernel: Optional[bool] = None):
    """Round-based parallel recovery.  Returns (status[m] int8, RoundStats).

    With ``stop_at_target=False`` the result is bit-identical to
    :func:`recover_serial`.  With ``stop_at_target=True`` rounds stop as
    soon as the number of recovered edges reaches ``target``.

    ``use_kernel=True`` runs each round's marking pass through kernel K4
    (:func:`repro_torch.kernels.ops.similarity_mark`) over all ``m`` rows
    against all ``max_candidates`` candidates, one launch per round, as
    the reference does (``recovery.py:241-245``); ``False`` marks only the
    active chunks.  ``None`` (the default) takes K4 on a CUDA problem and
    the chunked pass on a CPU problem.  Both give the same status.
    """
    m = prob.m
    K, B = max_candidates, block_size
    dev = prob.seg.device
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    seg, beta = prob.seg, prob.beta
    sig_u, sig_v = prob.sig_u, prob.sig_v
    is_edge = seg >= 0
    status = torch.where(is_edge, STATUS_OPEN, STATUS_SKIPPED).to(torch.int8)
    if m % chunk:
        raise ValueError(f"problem rows {m} are not a multiple of chunk "
                         f"{chunk}")

    # Loop-invariant tensors: each row's segment start and chunk ranges.
    # The start is the last run start at or before the row, so subtask ids
    # may be any ints (an outer shard keeps its subtasks' global ids).
    arange_m = torch.arange(m, dtype=torch.int32, device=dev)
    first_of_seg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                              seg[1:] != seg[:-1]])
    seg_row0 = torch.cummax(torch.where(first_of_seg, arange_m.long(), 0),
                            0).values          # first row of each row's seg
    chunks = seg.view(-1, chunk)
    chunk_lo, chunk_hi = chunks[:, 0], chunks.max(dim=1).values
    chunk_rows = torch.arange(chunk, device=dev)
    kidx = torch.arange(K, device=dev)
    later = kidx[None, :] > kidx[:, None]

    rounds = 0
    n_cand = torch.zeros((), dtype=torch.int64, device=dev)
    n_killed = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        # ---- cond, tested on the host every round -------------------------
        open_left = (status == STATUS_OPEN).any()
        if stop_at_target:
            n_rec = (status == STATUS_RECOVERED).sum()
            go = torch.stack([open_left.long(), n_rec]).tolist()
            if not (go[0] and go[1] < target):
                break
        elif not bool(open_left):
            break
        rounds += 1

        # ---- candidates: first B open rows per segment, first K overall ---
        avail = status == STATUS_OPEN
        ones = avail.to(torch.int32)
        cums = torch.cumsum(ones, 0, dtype=torch.int32)
        excl = cums - ones
        rank = excl - excl[seg_row0]
        cand = avail & (rank < B)
        candi = cand.to(torch.int32)
        crank = torch.cumsum(candi, 0, dtype=torch.int32) - candi
        cand = cand & (crank < K)
        cidx = torch.full((K + 1,), m, dtype=torch.int64, device=dev)
        cidx = cidx.scatter(0, torch.where(cand, crank, K).long(),
                            arange_m.long())[:K]
        cvalid = cidx < m
        ci = torch.where(cvalid, cidx, 0)
        csu, csv = sig_u[ci], sig_v[ci]
        cbeta = torch.where(cvalid, beta[ci], -1)
        cseg = torch.where(cvalid, seg[ci], -2)

        # ---- in-block order resolution (Lemma 8) --------------------------
        # Its share of the build is a span of its own; with the tracer on,
        # the queue drains as it opens and closes, so it times this
        # block's work only.
        with synced_span("recovery.in_block", dev):
            sim = strict_similarity_matrix(csu, csv, cbeta, csu, csv)
            same = cseg[:, None] == cseg[None, :]
            sim = sim & same & later & cvalid[:, None] & cvalid[None, :]
            killed = _resolve_block(sim)
        recovered_c = cvalid & ~killed
        new_status = torch.where(recovered_c, STATUS_RECOVERED,
                                 STATUS_SKIPPED).to(torch.int8)
        status = scatter_drop(status, cidx, new_status, cvalid)

        # ---- marking pass: K4 over every row, or the active chunks only ---
        mark_beta = torch.where(recovered_c, cbeta, -1)   # -1 disables
        if use_kernel:
            kill = kops.similarity_mark(csu, csv, mark_beta, cseg, sig_u,
                                        sig_v, seg, tile_m=chunk)
            kill = kill & (status == STATUS_OPEN)
            status = torch.where(kill, STATUS_SKIPPED, status).to(torch.int8)
        else:
            status = _mark_active_chunks(status, seg, sig_u, sig_v, cseg,
                                         csu, csv, mark_beta, recovered_c,
                                         chunk_lo, chunk_hi, chunk_rows,
                                         chunk, B)

        n_cand = n_cand + cvalid.sum()
        n_killed = n_killed + (cvalid & killed).sum()
    stats = RoundStats(rounds=rounds, candidates=int(n_cand),
                       killed_in_block=int(n_killed))
    return status, stats


def _mark_active_chunks(status, seg, sig_u, sig_v, cseg, csu, csv,
                        mark_beta, recovered_c, chunk_lo, chunk_hi,
                        chunk_rows, chunk: int, B: int) -> torch.Tensor:
    """Mark the open rows of the chunks whose subtask range holds a newly
    recovered candidate; the other chunks cannot change this round."""
    rseg = torch.where(recovered_c, cseg, -3)
    active = ((rseg[None, :] >= chunk_lo[:, None])
              & (rseg[None, :] <= chunk_hi[:, None])).any(dim=1)
    act = torch.nonzero(active).flatten()             # host sync
    if act.numel():
        rows = (act[:, None] * chunk + chunk_rows[None, :]).flatten()
        for lo in range(0, rows.numel(), _MARK_ROWS):
            r = rows[lo:lo + _MARK_ROWS]
            kill = _mark_rows(r, status, seg, sig_u, sig_v, cseg, csu, csv,
                              mark_beta, B)
            status = scatter_drop(status, r, STATUS_SKIPPED, kill)
    return status


def _mark_rows(rows, status, seg, sig_u, sig_v, cseg, csu, csv, mark_beta,
               B: int) -> torch.Tensor:
    """Open rows among ``rows`` that a recovered candidate of their own
    subtask strictly-similarity-marks.  Candidates are sorted by row, so
    one subtask's (at most ``B``) candidates sit together in the block."""
    K = cseg.shape[0]
    eseg = seg[rows]
    # valid candidates form a prefix; push the rest past every subtask id
    # so the search key stays sorted
    ckey = torch.where(cseg >= 0, cseg, torch.iinfo(torch.int32).max)
    first = torch.searchsorted(ckey.contiguous(), eseg.contiguous())
    slot = first[:, None] + torch.arange(B, device=rows.device)[None, :]
    inside = slot < K
    slot = torch.where(inside, slot, 0)
    mine = inside & (ckey[slot] == eseg[:, None])
    sbeta = torch.where(mine, mark_beta[slot], -1)
    esu, esv = sig_u[rows], sig_v[rows]
    su, sv = csu[slot], csv[slot]
    sim = ((_pair_match(su, esu, sbeta) & _pair_match(sv, esv, sbeta))
           | (_pair_match(su, esv, sbeta) & _pair_match(sv, esu, sbeta)))
    return sim.any(dim=1) & (status[rows] == STATUS_OPEN)


def select_top(status, score, target):
    """Keep the ``target`` highest-score recovered edges (deterministic)."""
    recovered = status == STATUS_RECOVERED
    neg_inf = torch.tensor(-float("inf"), dtype=score.dtype,
                           device=score.device)
    order = torch.argsort(-torch.where(recovered, score, neg_inf),
                          stable=True)
    rec_sorted = recovered[order]
    taken = torch.cumsum(rec_sorted.to(torch.int32), 0)
    keep_sorted = rec_sorted & (taken <= target)
    keep = torch.zeros_like(recovered)
    keep[order] = keep_sorted
    return keep
