"""Models of the port: the ``ssm`` family (falcon-mamba-7b) for serving.

  config.py  — ``ModelConfig``, the port's copy of the reference's.
  layers.py  — ``rmsnorm`` and the Mamba1 block (K6 carries its scan on
               the card); ``MambaMixer``.
  model.py   — ``MambaLM``, ``init_params``, ``prefill``, ``decode_step``.
  weights.py — ``params_from_reference``: the reference's weights, unstacked.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (MambaLM, cast_for_compute,
                                      decode_step, embed_tokens, init_cache,
                                      init_params, param_count, prefill,
                                      vocab_padded)
from repro_torch.models.weights import params_from_reference

__all__ = ["ModelConfig", "MambaLM", "init_params", "param_count",
           "vocab_padded", "embed_tokens", "init_cache", "prefill",
           "decode_step", "cast_for_compute", "params_from_reference"]
