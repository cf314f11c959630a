"""5-point 2-D grid: the landscape and road-grid family.

A frozen copy of ``grid2d`` in ``src/repro_torch/core/graph.py`` (as of
the port's fourteenth slice): the same edges in the same order and the
same weights from the same seed, returned as plain edge arrays, without
the program's ``build_graph``.
"""
from __future__ import annotations

import numpy as np


def generate(params: dict, seed: int):
    """``(n, src, dst, weight)`` of a ``rows x cols`` grid; weights uniform
    in ``[weight_low, weight_high)``."""
    rows, cols = int(params["rows"]), int(params["cols"])
    rng = np.random.default_rng(seed)
    idx = np.arange(rows * cols).reshape(rows, cols)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)
    e = np.concatenate([right, down])
    w = rng.uniform(float(params["weight_low"]), float(params["weight_high"]),
                    size=len(e)).astype(np.float32)
    return rows * cols, e[:, 0], e[:, 1], w
