"""The staged sparsification pipeline: one object, three pluggable stages.

    from repro_torch.pipeline import Pipeline, pdgrass_config

    sparsifier = Pipeline(pdgrass_config(alpha=0.05)).run(graph)

``prepare`` runs the shared steps 1-3 (tree stage, binary lifting, score
stage, subtask grouping) and returns a :class:`Prepared` that any engine
can consume.  Both methods take ``device=`` (default ``"cuda"``).  Their
``pipeline.*`` spans sync ``device`` while the tracer is on
(:func:`repro_torch.obs.device.synced_span`), so each stage's device work
is charged to that stage.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import lifting as lift_mod
from repro_torch.core import recovery as rec_mod
from repro_torch.core.graph import Graph
from repro_torch.core.sparsify import Prepared, Sparsifier
from repro_torch.obs import get_metrics
from repro_torch.obs.device import synced_span
from repro_torch.pipeline.config import PipelineConfig, validate
from repro_torch.pipeline.stages import (RECOVERY_ENGINES, SCORE_STAGES,
                                         TREE_STAGES)


class Pipeline:
    """A configured sparsification pipeline; stateless apart from its config."""

    def __init__(self, config: Optional[PipelineConfig] = None):
        self.config = validate(config if config is not None
                               else PipelineConfig())

    def __repr__(self) -> str:
        c = self.config
        return (f"Pipeline(tree={c.tree.kind!r}, score={c.score.kind!r}, "
                f"recovery={c.recovery.kind!r}, alpha={c.alpha})")

    # -- steps 1-3: tree, lifting, scores, subtask grouping ------------------

    def prepare(self, graph: Graph, *, device="cuda") -> Prepared:
        """Everything up to (and excluding) edge recovery — engine-agnostic."""
        cfg = self.config
        n, c, chunk = graph.n, cfg.c, cfg.chunk
        with synced_span("pipeline.prepare", device, n=n,
                         m=graph.m) as psp:
            src = torch.tensor(graph.src, device=device)
            dst = torch.tensor(graph.dst, device=device)
            w = torch.tensor(graph.weight, device=device)

            with synced_span("pipeline.tree", device, kind=cfg.tree.kind):
                tree = TREE_STAGES[cfg.tree.kind](n, src, dst, w, cfg.tree)
            with synced_span("pipeline.lifting", device):
                lift = lift_mod.build_lifting(n, tree.parent, tree.parent_w,
                                              tree.depth)

            in_tree = tree.in_tree.cpu().numpy()
            off_ids = np.flatnonzero(~in_tree)
            off_t = torch.as_tensor(off_ids, device=device)
            ou, ov, ow = src[off_t], dst[off_t], w[off_t]

            with synced_span("pipeline.scores", device,
                             kind=cfg.score.kind,
                             m_off=int(off_ids.shape[0])):
                l = lift_mod.lca(lift, ou, ov)
                r_t = lift_mod.resistance_distance(lift, ou, ov, l)
                score = SCORE_STAGES[cfg.score.kind](
                    ow, r_t, cfg.score, graph=graph, in_tree=in_tree,
                    u=graph.src[off_ids], v=graph.dst[off_ids])

                depth = lift.depth
                dl = depth[l.long()]
                beta = torch.clamp(torch.minimum(depth[ou.long()] - dl,
                                                 depth[ov.long()] - dl),
                                   max=c).to(torch.int32)
                sig = lift_mod.ancestor_signatures(tree.parent, c)
                sig_u, sig_v = sig[ou.long()], sig[ov.long()]

            with synced_span("pipeline.grouping", device):
                # Host-side ordering: LCA ascending, score descending
                # (stable) — the reference's np.lexsort.
                l_np = l.cpu().numpy()
                score_np = score.cpu().numpy()
                order = np.lexsort((-score_np, l_np))
                l_sorted = l_np[order]
                if len(l_sorted):
                    seg_change = np.concatenate(
                        [[True], l_sorted[1:] != l_sorted[:-1]])
                    seg_ids = np.cumsum(seg_change) - 1
                    n_subtasks = int(seg_ids[-1]) + 1
                else:  # graph is a tree — no off-tree edges, no subtasks
                    seg_ids = np.zeros(0, dtype=np.int64)
                    n_subtasks = 0
                sizes = np.bincount(seg_ids, minlength=max(n_subtasks, 1))

                m_off = off_ids.shape[0]
                m_pad = max(chunk, int(math.ceil(m_off / chunk)) * chunk)
                pad = m_pad - m_off
                order_t = torch.as_tensor(order, device=device)

                def pad_rows(x, fill):
                    shape = (pad,) + tuple(x.shape[1:])
                    return torch.cat([x, torch.full(shape, fill,
                                                    dtype=x.dtype,
                                                    device=x.device)])

                problem = rec_mod.RecoveryProblem(
                    sig_u=pad_rows(sig_u[order_t], -1),
                    sig_v=pad_rows(sig_v[order_t], -1),
                    beta=pad_rows(beta[order_t], -1),
                    seg=pad_rows(torch.as_tensor(seg_ids.astype(np.int32),
                                                 device=device), -1),
                    score=pad_rows(score[order_t], -float("inf")),
                )
            psp.set(n_subtasks=n_subtasks, m_off=int(m_off))
        get_metrics().inc("pipeline.prepares")
        return Prepared(
            graph=graph, tree=tree, lift=lift,
            off_edge_id=off_ids[order],
            problem=problem, n_subtasks=n_subtasks,
            subtask_sizes=sizes,
        )

    # -- step 4: recovery through the configured engine ----------------------

    def run(self, graph: Graph, prepared: Optional[Prepared] = None, *,
            device="cuda", **ctx) -> Sparsifier:
        """Full pipeline -> :class:`Sparsifier` on ``device``."""
        cfg = self.config
        prep = (prepared if prepared is not None
                else self.prepare(graph, device=device))
        target = min(int(math.ceil(cfg.alpha * graph.n)), prep.m_off)

        engine = RECOVERY_ENGINES[cfg.recovery.kind]
        with synced_span("pipeline.recovery", device,
                         kind=cfg.recovery.kind, target=target) as rsp:
            recovered_mask, engine_stats = engine(prep, target, cfg, **ctx)
            rsp.set(n_recovered=int(recovered_mask.sum()))
        m = get_metrics()
        m.inc("pipeline.runs")
        m.inc(f"pipeline.engine.{cfg.recovery.kind}")

        stats = dict(engine_stats)
        stats.setdefault("passes", 1)
        stats.update(
            n_recovered=int(recovered_mask.sum()),
            target=target,
            n_subtasks=prep.n_subtasks,
            max_subtask=int(prep.subtask_sizes.max()) if prep.n_subtasks
            else 0,
        )
        return Sparsifier(graph=graph,
                          tree_mask=prep.tree.in_tree.cpu().numpy(),
                          recovered_mask=recovered_mask, stats=stats,
                          device=torch.device(prep.problem.seg.device))


def run_pipeline(graph: Graph, config: Optional[PipelineConfig] = None, *,
                 device="cuda", **ctx) -> Sparsifier:
    """One-shot convenience: ``Pipeline(config).run(graph, device=...)``."""
    return Pipeline(config).run(graph, device=device, **ctx)
