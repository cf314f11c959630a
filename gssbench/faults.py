"""Faults planted under the program's timed path: each has to make
``correct`` come out false.  The tests drive a run with each
(``gssbench/tests/test_gssbench_faults.py``) and ``gssbench/readings.py``
reads them on the card at a cell's size.  The benchmark's own runs never
import this module.

Each fault is ``plant(setattr)``, with ``setattr(owner, name, value)``
replacing an attribute of the program (pytest's ``monkeypatch.setattr``,
or :class:`Patch`).

Solve faults:

* ``unchanged``: the PCG hands back its starting iterate;
* ``half_batch``: the PCG solves the first half of the columns and
  returns zeros for the rest;
* ``altered_answer``: a ticket resolves with its solution perturbed,
  still reporting convergence;
* ``stale_build``: every cycle gets the first cycle's hierarchy.

Build faults (the pdGRASS arithmetic under a cycle's build):

* ``k4_marks_nothing``: the recovery rounds' marking pass (kernel K4 on
  the card, its chunked pass on the CPU) marks no edge;
* ``no_similarity_filter``: recovery takes every off-tree edge, so the
  sparsifier keeps the top-score ones;
* ``coarse_weights_halved``: the contraction hands the next level half
  of each coarse edge's summed weight.
"""
from __future__ import annotations

import numpy as np


class Patch:
    """``setattr`` that remembers, and :meth:`undo` that restores."""

    def __init__(self):
        self._saved = []

    def __call__(self, owner, name, value):
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        while self._saved:
            owner, name, value = self._saved.pop()
            setattr(owner, name, value)


def unchanged(setattr_):
    from repro_torch.solver import device_pcg

    def pcg(matvec, b, msolve=None, tol=1e-5, maxiter=2000):
        k = b.shape[-1]
        return device_pcg.BatchedPCGResult(
            x=b * 0, iters=b.new_zeros(k).int(),
            relres=b.new_ones(k), converged=b.new_zeros(k).bool())

    setattr_(device_pcg, "batched_pcg", pcg)


def half_batch(setattr_):
    from repro_torch.solver import device_pcg

    real = device_pcg.batched_pcg

    def pcg(matvec, b, msolve=None, tol=1e-5, maxiter=2000):
        res = real(matvec, b, msolve, tol=tol, maxiter=maxiter)
        x = res.x.clone()
        x[:, b.shape[-1] // 2:] = 0
        return res._replace(x=x)

    setattr_(device_pcg, "batched_pcg", pcg)


def altered_answer(setattr_):
    from repro_torch.solver.requests import SolveTicket

    real = SolveTicket._resolve

    def resolve(self, response):
        x = np.asarray(response.x)
        noise = np.random.default_rng(0).standard_normal(x.shape)
        response.x = x + 1e-2 * np.linalg.norm(x) / np.sqrt(x.size) * noise
        real(self, response)

    setattr_(SolveTicket, "_resolve", resolve)


def stale_build(setattr_):
    from repro_torch.solver import service

    real, first = service.build_hierarchy, []

    def build(graph, **kw):
        if not first:
            first.append(real(graph, **kw))
        return first[0]

    setattr_(service, "build_hierarchy", build)


def k4_marks_nothing(setattr_):
    import torch

    from repro_torch.core import recovery
    from repro_torch.kernels import ops

    def mark(csu, csv, cbeta, cseg, esu, esv, eseg, **kw):
        return torch.zeros(esu.shape[0], dtype=torch.bool,
                           device=esu.device)

    def chunks(status, *args, **kw):
        return status

    setattr_(ops, "similarity_mark", mark)
    setattr_(recovery, "_mark_active_chunks", chunks)


def no_similarity_filter(setattr_):
    import torch

    from repro_torch.core import recovery

    def rounds(prob, target=2 ** 31 - 1, **kw):
        status = torch.where(prob.seg >= 0, recovery.STATUS_RECOVERED,
                             recovery.STATUS_SKIPPED).to(torch.int8)
        return status, recovery.RoundStats(0, 0, 0)

    setattr_(recovery, "recover_rounds", rounds)


def coarse_weights_halved(setattr_):
    from repro_torch.solver import hierarchy

    real = hierarchy.coalesce_edges

    def coalesce(src, dst, weight, labels, num_labels):
        csrc, cdst, cw, m_coarse = real(src, dst, weight, labels,
                                        num_labels)
        return csrc, cdst, cw * 0.5, m_coarse

    setattr_(hierarchy, "coalesce_edges", coalesce)


SOLVE = {"unchanged": unchanged, "half_batch": half_batch,
         "altered_answer": altered_answer}
BUILD = {"stale_build": stale_build, "k4_marks_nothing": k4_marks_nothing,
         "no_similarity_filter": no_similarity_filter,
         "coarse_weights_halved": coarse_weights_halved}
