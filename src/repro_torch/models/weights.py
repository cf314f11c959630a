"""Carry weights between the reference's tree and the port.

:func:`params_from_reference` takes the reference's param pytree
(``repro.models.model.init_params``) as numpy arrays — the caller converts,
e.g. ``jax.tree.map(np.asarray, params)``, so this module never imports JAX
— and returns the port's :class:`~repro_torch.models.model.LM` with equal
values, the reference's stacked ``[L, ...]`` leaves unstacked into one
module per layer.  :func:`tree_to_reference` is its inverse, for the
parameters or their gradients.
"""
from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM

#: the model's per-layer module lists; the reference stacks each of their
#: leaves ``[L, ...]`` across the layers
STACKS = ("layers", "encoder")


def stacked(name: str) -> bool:
    """Whether parameter ``name`` is one layer's slice of a stacked leaf
    of the reference (a leaf of one more dimension)."""
    return name.partition(".")[0] in STACKS


def reference_leaf(name: str) -> str:
    """The reference's leaf that parameter ``name`` belongs to: the layer
    index dropped (``layers.3.mlp.w1`` -> ``layers.mlp.w1``)."""
    if not stacked(name):
        return name
    head, _, rest = name.partition(".")
    return f"{head}.{rest.partition('.')[2]}"


def params_from_reference(tree, cfg: ModelConfig, *, device="cuda") -> LM:
    """``tree``: ``{"embed", "final_norm", "lm_head" (untied),
    "frontend_proj", "enc_norm", "layers": {...}, "encoder": {...}}`` of
    numpy arrays, the family's subset.  A layer stack (``layers``,
    ``encoder``) holds ``ln1``, ``ln2``, ``ln1_post``, ``ln2_post``,
    ``ln_x`` and the groups ``attn``, ``xattn``, ``mlp``, ``moe``
    (``router``, ``w1``, ``w2``, ``w3`` of every expert, ``[L, E, ...]``)
    and ``ssm``, each leaf stacked ``[L, ...]``.  Raises on a missing,
    extra or misshapen leaf."""
    stacks = {"layers": cfg.n_layers, "encoder": cfg.enc_layers}
    state = {k: v for k, v in tree.items() if k not in stacks}
    for stack, n_layers in stacks.items():
        for key, group in tree.get(stack, {}).items():
            leaves = (group.items() if isinstance(group, dict)
                      else [(None, group)])
            for name, leaf in leaves:
                path = key if name is None else f"{key}.{name}"
                if len(leaf) != n_layers:
                    raise ValueError(f"{stack}.{path} stacks {len(leaf)} "
                                     f"layers, the config {n_layers}")
                for i in range(n_layers):
                    state[f"{stack}.{i}.{path}"] = leaf[i]
    model = LM(cfg, device="meta")
    model.load_state_dict(
        {k: torch.as_tensor(np.array(v), device=device)
         for k, v in state.items()}, strict=True, assign=True)
    return model


def tree_to_reference(model_or_grads: Union[nn.Module, Mapping], cfg:
                      ModelConfig) -> dict:
    """The reference's param tree, numpy float32 (or the tensors' dtype),
    from the port: an :class:`LM`'s parameters, or a ``{parameter name:
    tensor}`` mapping of the same names (gradients, optimizer moments).
    Per-layer leaves are stacked ``[L, ...]`` in layer order, under
    ``layers`` and ``encoder`` as :func:`params_from_reference` reads
    them."""
    named = (dict(model_or_grads.named_parameters())
             if isinstance(model_or_grads, nn.Module) else model_or_grads)
    stacks = {"layers": cfg.n_layers, "encoder": cfg.enc_layers}
    tree: dict = {}
    per_layer: dict = {}
    for name, t in named.items():
        arr = t.detach().cpu().numpy()
        if not stacked(name):
            tree[name] = arr
            continue
        head, _, rest = name.partition(".")
        i, _, path = rest.partition(".")
        per_layer.setdefault((head, path), {})[int(i)] = arr
    for (stack, path), leaves in per_layer.items():
        if sorted(leaves) != list(range(stacks[stack])):
            raise ValueError(f"{stack}.{path}: layers {sorted(leaves)}, the "
                             f"config has {stacks[stack]}")
        node = tree.setdefault(stack, {})
        *groups, leaf = path.split(".")
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = np.stack([leaves[i] for i in range(stacks[stack])])
    return tree
