"""pdGRASS data structures + back-compat entry points.

The pipeline orchestration (Algorithm 1: tree -> lifting -> scores ->
subtasks -> recovery) lives in :mod:`repro_torch.pipeline`.  This module
keeps the shared data structures — :class:`Prepared` (steps 1-3 output) and
:class:`Sparsifier` (the result, with device-resident Laplacian views) —
and :func:`prepare` / :func:`pdgrass`, thin wrappers over the pipeline:

    sparsifier = pdgrass(graph, alpha=0.05, device="cuda")
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import lifting as lift_mod
from repro_torch.core import recovery as rec_mod
from repro_torch.core import spanning_tree as st_mod
from repro_torch.core.graph import Graph


@dataclasses.dataclass(frozen=True)
class Prepared:
    """Everything up to (and excluding) edge recovery — shared by engines."""

    graph: Graph
    tree: st_mod.TreeResult           # device tensors
    lift: lift_mod.Lifting
    off_edge_id: np.ndarray           # [m_off] undirected edge id (sorted)
    problem: rec_mod.RecoveryProblem  # padded to chunk multiple
    n_subtasks: int
    subtask_sizes: np.ndarray         # [n_subtasks] int64

    @property
    def m_off(self) -> int:
        return int(self.off_edge_id.shape[0])


@dataclasses.dataclass(frozen=True)
class Sparsifier:
    graph: Graph
    tree_mask: np.ndarray       # [m] bool — spanning tree edges
    recovered_mask: np.ndarray  # [m] bool — recovered off-tree edges
    stats: dict
    device: torch.device = torch.device("cuda")

    @property
    def edge_mask(self) -> np.ndarray:
        return self.tree_mask | self.recovered_mask

    @functools.cached_property
    def device_graph(self):
        """Device-resident view of the sparsifier (kept edges only), built
        once per sparsifier."""
        from repro_torch.core.device_graph import DeviceGraph

        return DeviceGraph.from_graph(self.graph, edge_mask=self.edge_mask,
                                      device=self.device)

    def to_ell(self):
        """Sparsifier Laplacian as device ELL [n, L] slabs."""
        return self.device_graph.to_ell()

    def laplacian_matvec(self, x):
        """``y = L_P x`` on the device ([n] or [n, k])."""
        return self.device_graph.laplacian_matvec(x)

    def laplacian(self):
        """Sparsifier Laplacian as scipy CSR (host-side reference path)."""
        import scipy.sparse as sp

        g = self.graph
        keep = self.edge_mask
        s, d, w = g.src[keep], g.dst[keep], g.weight[keep].astype(np.float64)
        i = np.concatenate([s, d, np.arange(g.n)])
        j = np.concatenate([d, s, np.arange(g.n)])
        deg = np.zeros(g.n)
        np.add.at(deg, s, w)
        np.add.at(deg, d, w)
        v = np.concatenate([-w, -w, deg])
        return sp.csr_matrix((v, (i, j)), shape=(g.n, g.n))


def prepare(graph: Graph, c: int = 8, chunk: int = 2048,
            score_mode: str = "w_times_r", *, device="cuda") -> Prepared:
    """Steps 1-3: tree, lifting, scores, subtask grouping."""
    from repro_torch.pipeline import Pipeline, pdgrass_config

    return Pipeline(
        pdgrass_config(c=c, chunk=chunk, score_mode=score_mode)
    ).prepare(graph, device=device)


def pdgrass(
    graph: Graph,
    alpha: float = 0.02,
    *,
    c: int = 8,
    engine: str = "rounds",
    score_mode: str = "w_times_r",
    block_size: int = 16,
    max_candidates: int = 128,
    stop_at_target: bool = True,
    chunk: int = 2048,
    prepared: Optional[Prepared] = None,
    device="cuda",
) -> Sparsifier:
    """Run the full pdGRASS pipeline and return the sparsifier."""
    from repro_torch.pipeline import Pipeline, pdgrass_config

    cfg = pdgrass_config(
        alpha=alpha, c=c, chunk=chunk, engine=engine, score_mode=score_mode,
        block_size=block_size, max_candidates=max_candidates,
        stop_at_target=stop_at_target)
    return Pipeline(cfg).run(graph, prepared=prepared, device=device)
