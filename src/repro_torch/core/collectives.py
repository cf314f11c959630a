"""Collectives over the shards of a :class:`repro_torch.launch.Mesh`.

The only place where shards exchange data.  A sharded value is a stacked
tensor whose leading axis is the shard axis: shard ``s`` holds ``v[s]``.
Every shard of a mesh lives on one device, so each collective is a
reduction or a reshape over that leading axis, taken in shard order
0..P-1: the result has the same bits on every run, and is the value that
every shard holds afterwards (replicated).

A transport across cards would replace these functions, and the stacked
layout with one tensor per card (ROADMAP queue 1, "mesh across cards").
"""
from __future__ import annotations

import torch


def _fold(v: torch.Tensor, op) -> torch.Tensor:
    acc = v[0]
    for s in range(1, v.shape[0]):
        acc = op(acc, v[s])
    return acc


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
    ``tiled`` the blocks concatenated along their first axis."""
    return v.reshape((-1,) + tuple(v.shape[2:])) if tiled else v
