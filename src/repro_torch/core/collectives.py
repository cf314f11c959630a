"""Collectives over the shards of a :class:`repro_torch.launch.Mesh`.

The only place where shards exchange data.  A sharded value is a stacked
tensor whose leading axis is the shard axis: shard ``s`` holds ``v[s]``.
Every shard of a mesh lives on one device, so each collective is a
reduction or a reshape over that leading axis, taken in shard order
0..P-1: the result has the same bits on every run, and is the value that
every shard holds afterwards (replicated).

:func:`count_collectives` counts what the collectives return, the port's
counterpart of the reference's HLO parse (``launch.roofline.
collective_bytes``): while it is active each call adds the bytes of one
shard's result under the reference's kind name, ``"all-gather"`` or
``"all-reduce"``.  Counting reads shapes only; it changes no result, and
when no count is active a collective tests one attribute and goes on.

A transport across cards would replace these functions, and the stacked
layout with one tensor per card (ROADMAP queue 1, "mesh across cards").
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

_active = threading.local()   # .count: the CollectiveCount being filled


class CollectiveCount:
    """Per-shard result bytes of the collectives called while it was
    active, by kind, and the number of calls by kind."""

    def __init__(self):
        self.per_kind: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}

    def add(self, kind: str, nbytes: int) -> None:
        self.per_kind[kind] = self.per_kind.get(kind, 0) + nbytes
        self.calls[kind] = self.calls.get(kind, 0) + 1

    @property
    def total(self) -> int:
        return sum(self.per_kind.values())


@contextlib.contextmanager
def count_collectives():
    """Count this thread's collectives inside the block; yields the
    :class:`CollectiveCount`.  One block at a time: it does not nest."""
    if getattr(_active, "count", None) is not None:
        raise RuntimeError("count_collectives is already active")
    _active.count = count = CollectiveCount()
    try:
        yield count
    finally:
        _active.count = None


def _counted(kind: str, result: torch.Tensor, shard_result_elems: int):
    count = getattr(_active, "count", None)
    if count is not None:
        count.add(kind, shard_result_elems * result.element_size())
    return result


def _fold(v: torch.Tensor, op) -> torch.Tensor:
    acc = v[0]
    for s in range(1, v.shape[0]):
        acc = op(acc, v[s])
    return _counted("all-reduce", acc, acc.numel())


def psum(v: torch.Tensor) -> torch.Tensor:
    """``v[0] + v[1] + ... + v[P-1]``, added left to right."""
    return _fold(v, torch.add)


def pmax(v: torch.Tensor) -> torch.Tensor:
    """Elementwise maximum over the shards."""
    return _fold(v, torch.maximum)


def pmin(v: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum over the shards."""
    return _fold(v, torch.minimum)


def all_gather(v: torch.Tensor, tiled: bool = False) -> torch.Tensor:
    """Every shard's block, in shard order: ``[P, ...]`` as given, or with
    ``tiled`` the blocks concatenated along their first axis.  Each shard
    receives all ``P`` blocks."""
    out = v.reshape((-1,) + tuple(v.shape[2:])) if tiled else v
    return _counted("all-gather", out, v.numel())
