"""FSDP and tensor-parallel placements of the model's parameters.

The port of ``repro.dist.sharding``.  :func:`param_pspecs` names, for each
of the port's parameters, the mesh axes each of its dimensions is split
over (None: replicated), by the reference's rules, keyed on the
parameter's name with divisibility guards:

  * ``model``: tensor parallel (heads, the ffn and expert dims);
  * ``data`` (with ``pod``): FSDP, the largest remaining divisible dim.

The reference applies its rules to stacked ``[L, ...]`` leaves, and two
of them read that rank (FSDP skips the layer dim when ``ndim >= 3``; the
TP dims count from the end).  So the rules run here on the reference's
shape, the layer dim added back, and that dim is dropped from the
answer.

These are placements only.  One card holds every parameter whole, so
they cannot be applied there; putting them on DTensor or FSDP2 waits for
the mesh across cards (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
from torch import nn

from repro_torch.models.weights import reference_leaf, stacked

# TP over the *last* dim (output-expanding projections).
_TP_LAST = {"w1", "w3", "router", "in_proj", "x_proj", "lm_head",
            "frontend_proj"}
# TP over the head dim [..., d, heads, hd] (QKV projections).
_TP_HEAD = {"wq", "wk", "wv"}
# TP over dim -2 (input-contracting projections; output needs a psum).
_TP_IN = {"wo", "w2", "out_proj", "dt_proj"}
# MoE tensors carry a leading [layers, experts, ...] pair.
_MOE = {"w1", "w2", "w3", "router"}

Axis = Optional[Union[str, Tuple[str, ...]]]


def _rule(name: str, in_moe: bool, shape: Tuple[int, ...],
          mesh_shape: Mapping[str, int], expert_shard: bool
          ) -> Tuple[Axis, ...]:
    """The reference's rule on one leaf of the reference's ``shape``."""
    ndim = len(shape)
    dims: list = [None] * ndim
    if ndim < 2:
        return tuple(dims)   # norms / biases / scalars: replicate
    fsdp = tuple(a for a in ("pod", "data") if a in mesh_shape)
    fsdp_size = int(np.prod([mesh_shape[a] for a in fsdp])) if fsdp else 1
    fsdp_spec = fsdp if len(fsdp) > 1 else (fsdp[0] if fsdp else None)
    tp_size = int(mesh_shape.get("model", 1))

    tp_dim = None
    if tp_size > 1:
        if in_moe and expert_shard and name in _MOE and ndim >= 3:
            tp_dim = 1                     # [layers, E, ...] expert dim
        elif name in _TP_HEAD and ndim >= 3:
            tp_dim = ndim - 2
        elif name in _TP_LAST:
            tp_dim = ndim - 1
        elif name in _TP_IN:
            tp_dim = ndim - 2
        elif name == "embed":
            tp_dim = 0                     # vocab-sharded embedding
        if tp_dim is not None and shape[tp_dim] % tp_size == 0:
            dims[tp_dim] = "model"
        else:
            tp_dim = None

    if fsdp and fsdp_size > 1:
        start = 1 if ndim >= 3 else 0
        cands = [d for d in range(start, ndim)
                 if d != tp_dim and shape[d] % fsdp_size == 0
                 and shape[d] >= fsdp_size]
        if cands:
            dims[max(cands, key=lambda d: shape[d])] = fsdp_spec
    return tuple(dims)


def leaf_pspecs(model: nn.Module, mesh_shape: Mapping[str, int],
                expert_shard: bool = False
                ) -> Dict[str, Tuple[Tuple[int, ...], Tuple[Axis, ...]]]:
    """``{reference leaf: (its shape, axes per dim)}``: the reference's
    tree as its rules see it, a per-layer leaf stacked ``[L, ...]``
    (:func:`repro_torch.models.weights.reference_leaf` names it), for
    ``model`` (on any device, ``meta`` too) on a mesh of ``mesh_shape``
    (axis name -> size, as ``Mesh.shape``).  ``expert_shard`` true shards
    the MoE expert tensors over ``model`` on the expert dim instead of
    their ffn dim."""
    out = {}
    for full, p in model.named_parameters():
        leaf = reference_leaf(full)
        if leaf in out:
            continue
        parts = full.split(".")
        shape = tuple(p.shape)
        if stacked(full):   # the reference's [L, ...] leaf
            shape = (len(getattr(model, parts[0])),) + shape
        out[leaf] = (shape, _rule(parts[-1], "moe" in parts, shape,
                                  mesh_shape, expert_shard))
    return out


def param_pspecs(model: nn.Module, mesh_shape: Mapping[str, int],
                 expert_shard: bool = False) -> Dict[str, Tuple[Axis, ...]]:
    """``{parameter name: axes per dim}`` for ``model``: each parameter's
    part of its leaf's placement (:func:`leaf_pspecs`), the layer dim of
    a stacked leaf dropped."""
    leaves = leaf_pspecs(model, mesh_shape, expert_shard)
    out = {}
    for full, _ in model.named_parameters():
        spec = leaves[reference_leaf(full)][1]
        out[full] = spec[1:] if stacked(full) else spec
    return out
