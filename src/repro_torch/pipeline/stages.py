"""Stage registries: named, pluggable implementations for each stage.

Three registries, looked up by the ``kind`` strings in
:mod:`repro_torch.pipeline.config`:

  * ``TREE_STAGES``      — ``(n, src, dst, weight, TreeConfig) -> TreeResult``
  * ``SCORE_STAGES``     — ``(w_off, r_tree, ScoreConfig, **ctx) ->
                             score [m_off]``
  * ``RECOVERY_ENGINES`` — ``(prep, target, PipelineConfig, **ctx) ->
                             (recovered_mask [graph.m] bool, stats dict)``

Ported: ``low_stretch``/``boruvka``, ``w_times_r``/``r`` and
``rounds``/``serial``/``multipass``.  ``er_sample``, ``er_exact`` and
``distributed`` are registered, so every config of the reference
validates, but raise :class:`NotImplementedError` when run.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import recovery as rec_mod
from repro_torch.core import spanning_tree as st_mod
from repro_torch.pipeline.config import (PipelineConfig, ScoreConfig,
                                         TreeConfig)

TREE_STAGES: dict = {}
SCORE_STAGES: dict = {}
RECOVERY_ENGINES: dict = {}


def register(registry: dict, name: str):
    def deco(fn):
        registry[name] = fn
        return fn
    return deco


def _not_ported(registry: dict, name: str):
    def stage(*args, **kwargs):
        raise NotImplementedError(
            f"stage {name!r} is not yet ported to repro_torch")
    registry[name] = stage


# -- tree stages (paper step 1) ----------------------------------------------

@register(TREE_STAGES, "low_stretch")
def tree_low_stretch(n, src, dst, weight, cfg: TreeConfig):
    """feGRASS Definition 1: max-ST over effective weights (low-stretch)."""
    return st_mod.build_spanning_tree(n, src, dst, weight,
                                      mode="low_stretch")


@register(TREE_STAGES, "boruvka")
def tree_boruvka(n, src, dst, weight, cfg: TreeConfig):
    """Plain maximum-weight spanning tree (Boruvka on the raw weights)."""
    return st_mod.build_spanning_tree(n, src, dst, weight, mode="boruvka")


# -- score stages (paper step 2) ---------------------------------------------

@register(SCORE_STAGES, "w_times_r")
def score_w_times_r(w, r_t, cfg: ScoreConfig, **_):
    """Spectral criticality w(e) * R_T(e) — the feGRASS/pdGRASS default."""
    return w * r_t


@register(SCORE_STAGES, "r")
def score_r(w, r_t, cfg: ScoreConfig, **_):
    """Raw tree resistance distance (ignores the edge weight)."""
    return r_t


_not_ported(SCORE_STAGES, "er_sample")
_not_ported(SCORE_STAGES, "er_exact")


# -- recovery engines (paper step 4) -----------------------------------------

def mask_from_status(prep, status, target) -> np.ndarray:
    """Top-``target`` recovered rows by score -> [graph.m] bool edge mask."""
    status = torch.as_tensor(status, device=prep.problem.score.device)
    keep = rec_mod.select_top(status, prep.problem.score, target)
    keep = keep[: prep.m_off].cpu().numpy()
    mask = np.zeros(prep.graph.m, dtype=bool)
    mask[prep.off_edge_id[keep]] = True
    return mask


@register(RECOVERY_ENGINES, "rounds")
def engine_rounds(prep, target, cfg: PipelineConfig, **ctx):
    """The round engine (strict similarity, single logical pass)."""
    r = cfg.recovery
    status, stats = rec_mod.recover_rounds(
        prep.problem, int(target), block_size=r.block_size,
        max_candidates=r.max_candidates, stop_at_target=r.stop_at_target,
        chunk=cfg.chunk)
    return mask_from_status(prep, status, target), {
        "rounds": stats.rounds,
        "candidates": stats.candidates,
        "killed_in_block": stats.killed_in_block,
    }


@register(RECOVERY_ENGINES, "serial")
def engine_serial(prep, target, cfg: PipelineConfig, **ctx):
    """The numpy oracle — the paper's sequential per-subtask greedy."""
    status = rec_mod.recover_serial(prep.problem)
    return mask_from_status(prep, status, target), {"rounds": -1}


_not_ported(RECOVERY_ENGINES, "distributed")


@register(RECOVERY_ENGINES, "multipass")
def engine_multipass(prep, target, cfg: PipelineConfig, **ctx):
    """feGRASS recovery: loose (vertex-cover) similarity, multi-pass, host.

    The baseline the paper measures against (its Table II); under the same
    ``Pipeline`` harness, pdGRASS against feGRASS is a recovery-stage diff.
    """
    from repro_torch.core.fegrass import loose_multipass_recover

    return loose_multipass_recover(prep, target, c=cfg.c,
                                   max_passes=cfg.recovery.max_passes)
