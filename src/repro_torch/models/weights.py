"""Carry the reference's weights into the port.

:func:`params_from_reference` takes the reference's param pytree
(``repro.models.model.init_params``) as numpy arrays — the caller converts,
e.g. ``jax.tree.map(np.asarray, params)``, so this module never imports JAX
— and returns the port's :class:`~repro_torch.models.model.MambaLM` with
equal values, the reference's stacked ``[L, ...]`` leaves unstacked into
one module per layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import MambaLM


def params_from_reference(tree, cfg: ModelConfig, *,
                          device="cuda") -> MambaLM:
    """``tree``: ``{"embed", "final_norm", "layers": {"ln1", "ssm": {...}}}``
    of numpy arrays, per-layer leaves ``[L, ...]``.  Raises on a missing,
    extra or misshapen leaf."""
    state = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    layers = tree["layers"]
    for i in range(cfg.n_layers):
        state[f"layers.{i}.ln1"] = layers["ln1"][i]
        for name, leaf in layers["ssm"].items():
            state[f"layers.{i}.ssm.{name}"] = leaf[i]
    model = MambaLM(cfg, device="meta")
    model.load_state_dict(
        {k: torch.as_tensor(np.array(v), device=device)
         for k, v in state.items()}, strict=True, assign=True)
    return model
