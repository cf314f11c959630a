"""Carry the reference's weights into the port.

:func:`params_from_reference` takes the reference's param pytree
(``repro.models.model.init_params``) as numpy arrays — the caller converts,
e.g. ``jax.tree.map(np.asarray, params)``, so this module never imports JAX
— and returns the port's :class:`~repro_torch.models.model.LM` with equal
values, the reference's stacked ``[L, ...]`` leaves unstacked into one
module per layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM


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
