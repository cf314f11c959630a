"""Stage registries: named, pluggable implementations for each stage.

Three registries, looked up by the ``kind`` strings in
:mod:`repro_torch.pipeline.config`:

  * ``TREE_STAGES``      — ``(n, src, dst, weight, TreeConfig) -> TreeResult``
  * ``SCORE_STAGES``     — ``(w_off, r_tree, ScoreConfig, **ctx) ->
                             score [m_off]``
  * ``RECOVERY_ENGINES`` — ``(prep, target, PipelineConfig, **ctx) ->
                             (recovered_mask [graph.m] bool, stats dict)``

Every stage of the reference is ported: ``low_stretch``/``boruvka``,
``w_times_r``/``r``/``er_sample``/``er_exact`` and ``rounds``/``serial``/
``distributed``/``multipass``.

``ctx`` carries runtime-only objects that don't belong in a serializable
config: for score stages, the host ``graph``, the tree membership mask,
and the off-tree endpoints ``u``/``v`` that ``er_exact`` solves against;
for the ``distributed`` engine, the ``mesh``.
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


_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``x0``/``x1`` under
    the key ``(k1, k2)``, as ``jax._src.prng``'s; the uint32 words are kept
    in int64 tensors and reduced mod 2^32 after every addition."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = x0 ^ (((x1 << r) | (x1 >> (32 - r))) & _MASK32)
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def random_bits(seed: int, n: int, device) -> torch.Tensor:
    """``jax.random.bits(jax.random.PRNGKey(seed), (n,))`` as int64 values
    in ``[0, 2^32)``: the key ``(0, seed mod 2^32)`` of a 32-bit seed, and
    the partitionable counter layout (``jax_threefry_partitionable``, the
    default since jax 0.5): element ``i`` hashes the 64-bit counter ``i``
    split into its high and low words, and its bits are the XOR of the
    two output words."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = _threefry2x32(0, int(seed) & _MASK32, i >> 32, i & _MASK32)
    return x0 ^ x1


def gumbel(seed: int, n: int, device) -> torch.Tensor:
    """``jax.random.gumbel(PRNGKey(seed), (n,), float32)`` (``mode="low"``):
    23 random mantissa bits under the exponent of 1.0, minus 1, scaled into
    ``[tiny, 1)``, then ``-log(-log(u))``.  The bits equal JAX's; the
    values may part from XLA's by the ULP of its ``log``."""
    tiny = float(np.finfo(np.float32).tiny)
    mant = (random_bits(seed, n, device) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    scale = float(np.float32(1.0) - np.float32(tiny))   # maxval - minval
    u = torch.clamp(floats * scale + tiny, min=tiny)
    return -torch.log(-torch.log(u))


@register(SCORE_STAGES, "er_sample")
def score_er_sample(w, r_t, cfg: ScoreConfig, **_):
    """Effective-resistance sampling order (Spielman-Srivastava style).

    Gumbel-top-k: ranking by ``log(w * R_T) + Gumbel(seed)`` and keeping the
    top ``target`` draws a sample *without replacement* with inclusion
    probability proportional to w(e) * R_T(e) — the leverage-score proxy —
    instead of the deterministic top scores.  Deterministic per seed, with
    the reference's noise (:func:`gumbel`), on ``w``'s device.
    """
    if w.dtype != torch.float32:
        raise TypeError(f"er_sample draws float32 noise, got w of {w.dtype}")
    noise = gumbel(cfg.seed, w.shape[0], w.device)
    return torch.log(torch.clamp(w * r_t, min=1e-30)) + noise


@register(SCORE_STAGES, "er_exact")
def score_er_exact(w, r_t, cfg: ScoreConfig, *, graph=None, in_tree=None,
                   u=None, v=None, **_):
    """True leverage scores w(e) * R_G(e) from batched Laplacian solves.

    Replaces the tree-resistance proxy ``R_T`` (an upper bound that can
    badly over-rank edges shortcut elsewhere) with the exact effective
    resistance of the *full* graph, computed on the spanning-tree-
    preconditioned solver on ``w``'s device — the ground truth
    ``er_sample`` approximates.  ``cfg.tol`` is the per-column solve
    tolerance.
    """
    if graph is None:
        raise ValueError("er_exact needs graph context (graph, in_tree, "
                         "u, v) from the pipeline; bare calls only get "
                         "the tree proxy")
    # Late import: pipeline <- spectral <- solver <- pipeline would cycle
    # at module load; by call time every module is initialized.
    from repro_torch.spectral.resistance import exact_offtree_resistances

    r = exact_offtree_resistances(graph, in_tree, u, v, tol=cfg.tol,
                                  device=w.device)
    return w * torch.as_tensor(r, dtype=w.dtype, device=w.device)


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


@register(RECOVERY_ENGINES, "distributed")
def engine_distributed(prep, target, cfg: PipelineConfig, mesh=None, **ctx):
    """The mixed outer/inner mesh engine of
    :mod:`repro_torch.core.distributed`.

    ``mesh`` comes through the runtime context (``Pipeline.run(...,
    mesh=m)``); without one, a 1-shard mesh on the problem's device."""
    from repro_torch.core import distributed as dist_mod
    from repro_torch.launch.mesh import make_mesh

    r = cfg.recovery
    if mesh is None:
        mesh = make_mesh((1,), (r.axis,), device=prep.problem.seg.device)
    status = dist_mod.recover_mixed(
        prep, mesh, axis=r.axis, block_size=r.block_size,
        max_candidates=r.max_candidates, chunk=cfg.chunk, cutoff=r.cutoff)
    return mask_from_status(prep, status, target), {
        "rounds": -1, "n_shards": int(mesh.shape[r.axis])}


@register(RECOVERY_ENGINES, "multipass")
def engine_multipass(prep, target, cfg: PipelineConfig, **ctx):
    """feGRASS recovery: loose (vertex-cover) similarity, multi-pass, host.

    The baseline the paper measures against (its Table II); under the same
    ``Pipeline`` harness, pdGRASS against feGRASS is a recovery-stage diff.
    """
    from repro_torch.core.fegrass import loose_multipass_recover

    return loose_multipass_recover(prep, target, c=cfg.c,
                                   max_passes=cfg.recovery.max_passes)
