"""Device-resident companion to the host :class:`repro_torch.core.graph.Graph`.

``Graph`` is numpy + CSR, the substrate for host-side construction and
validation.  :class:`DeviceGraph` is its tensor twin: flat edge tensors plus
the Laplacian diagonal on one device.  ``laplacian_matvec`` is
scatter-add work and ``to_ell`` emits the [n, L] ELL slabs that the CUDA
kernels and the V-cycle levels consume.

Float sums here (the diagonal, the matvec) go through
:func:`repro_torch.core.graph_ops.ordered_segment_sum`: each vertex's terms
are added in edge order, as XLA's sequential scatter-add does, so the
diagonal that feeds the smoother and the spectral radius estimate has the
same bits on every run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph_ops import ordered_segment_sum


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Flat device edge tensors of an undirected weighted graph.

    Attributes:
      n:      vertex count.
      src/dst: ``[m]`` int32 endpoints, ``src < dst``.
      weight: ``[m]`` float32 positive edge weights.
      diag:   ``[n]`` float32 weighted degrees (the Laplacian diagonal).
    """

    n: int
    src: torch.Tensor
    dst: torch.Tensor
    weight: torch.Tensor
    diag: torch.Tensor

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    @classmethod
    def from_graph(cls, graph, edge_mask: Optional[np.ndarray] = None, *,
                   device="cuda") -> "DeviceGraph":
        """Upload a host Graph (optionally only its ``edge_mask`` edges)."""
        if edge_mask is not None:
            keep = np.asarray(edge_mask, dtype=bool)
            src_h, dst_h, w_h = (graph.src[keep], graph.dst[keep],
                                 graph.weight[keep])
        else:
            src_h, dst_h, w_h = graph.src, graph.dst, graph.weight
        return cls.from_arrays(
            graph.n,
            torch.tensor(np.asarray(src_h, np.int32), device=device),
            torch.tensor(np.asarray(dst_h, np.int32), device=device),
            torch.tensor(np.asarray(w_h, np.float32), device=device))

    @classmethod
    def from_arrays(cls, n: int, src, dst, weight) -> "DeviceGraph":
        """Build from device edge tensors; the diagonal sums each vertex's
        weights in the reference's order (``src`` side, then ``dst``)."""
        diag = ordered_segment_sum(torch.cat([weight, weight]),
                                   torch.cat([src, dst]), n)
        return cls(n=n, src=src, dst=dst, weight=weight, diag=diag)

    def laplacian_matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``y = L x`` for ``x`` of shape [n] or [n, k]."""
        w, d = self.weight, self.diag
        if x.dim() == 2:
            w, d = w[:, None], d[:, None]
        terms = torch.cat([-w * x[self.dst.long()], -w * x[self.src.long()]])
        return ordered_segment_sum(terms, torch.cat([self.src, self.dst]),
                                   self.n, init=d * x)

    def to_ell(self, width: Optional[int] = None):
        """Laplacian in ELL [n, L] (column-index, value) slab layout.

        Row v holds its ``-w`` neighbor entries, then the diagonal, then
        padding slots that gather the row's own x with value 0.  The only
        host sync is the slab width ``L``."""
        n, m = self.n, self.m
        dev = self.device
        rows = torch.arange(n, dtype=torch.int32, device=dev)
        if m == 0:
            L = width or 1
            return (rows[:, None].expand(n, L).contiguous(),
                    torch.zeros((n, L), dtype=self.weight.dtype, device=dev))
        heads = torch.cat([self.src, self.dst]).long()
        tails = torch.cat([self.dst, self.src])
        ws = torch.cat([self.weight, self.weight])
        deg = torch.bincount(heads, minlength=n)
        L = int(deg.max()) + 1 if width is None else int(width)

        order = torch.argsort(heads, stable=True)
        h, t, v = heads[order], tails[order], ws[order]
        start = torch.cumsum(deg, 0) - deg           # first slot of each row
        slot = torch.arange(2 * m, device=dev) - start[h]

        idx = rows[:, None].expand(n, L).contiguous()
        idx[h, slot] = t
        val = torch.zeros((n, L), dtype=self.weight.dtype, device=dev)
        val[h, slot] = -v
        val[rows.long(), deg] = self.diag
        return idx, val
