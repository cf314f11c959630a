"""Architecture registry of the port: ``--arch <id>`` resolves through here.

The port's own copy of ``repro.configs`` (the same ``ARCHS``, configs and
``reduced``), so the port never imports the JAX package.  ``get_config(name)``
accepts dashed or underscored ids.  ``reduced(cfg)`` shrinks any config to a
CPU-smokeable size of the same family (small layers/width, few experts, tiny
vocab) — used by the parity tests.  The full configs are built on the card
(``chip_smoke.py``) or, for their shapes alone, on the ``meta`` device.
The graph workload's config is ``repro_torch.configs.pdgrass_graph``
(``PdGrassConfig``, ``CONFIG``), outside ``ARCHS``: it is not an LM.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS = [
    "falcon-mamba-7b",
    "arctic-480b",
    "mixtral-8x22b",
    "qwen3-4b",
    "phi3-medium-14b",
    "gemma2-2b",
    "starcoder2-15b",
    "phi-3-vision-4.2b",
    "hymba-1.5b",
    "seamless-m4t-medium",
]


def _modname(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-")
    if key not in [a for a in ARCHS]:
        # allow exact underscore ids too
        matches = [a for a in ARCHS if _modname(a) == _modname(name)]
        if not matches:
            raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
        key = matches[0]
    mod = importlib.import_module(f"repro_torch.configs.{_modname(key)}")
    return mod.CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=2,
        d_model=64,
        vocab=512,
        d_ff=128 if cfg.d_ff else 0,
        ssm_chunk=16,
        moe_group=64,
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=2, head_dim=16)
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2), moe_d_ff=128)
    if cfg.ssm_state:
        kw.update(ssm_state=4, ssm_dt_rank=8)
    if cfg.window:
        kw.update(window=8)
    if cfg.enc_layers:
        kw.update(enc_layers=2)
    if cfg.frontend:
        kw.update(frontend_dim=32,
                  frontend_len=4 if cfg.frontend_len else 0)
    return dataclasses.replace(cfg, **kw).validate()


__all__ = ["ARCHS", "get_config", "reduced"]
