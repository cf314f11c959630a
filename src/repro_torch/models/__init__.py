"""Models of the port, every family for serving and training: ``ssm``
(falcon-mamba-7b), ``hybrid`` (hymba-1.5b), ``dense`` (qwen3-4b,
gemma2-2b, phi3-medium-14b, starcoder2-15b), ``moe`` (mixtral-8x22b,
arctic-480b), ``vlm`` (phi-3-vision-4.2b), ``encdec``
(seamless-m4t-medium).

  config.py  — ``ModelConfig``, the port's copy of the reference's.
  layers.py  — ``rmsnorm``, ``rope``, blockwise, decode, encoder and
               cross-attention, the MLPs, the MoE (``moe_ffn``) and the
               Mamba1 block (K6 carries its scan on the card);
               ``Attention``, ``MLP``, ``MoE``, ``MambaMixer``.
  model.py   — ``LM`` (alias ``MambaLM``), ``init_params``,
               ``forward_hidden``, ``chunked_ce_loss``, ``loss_fn``,
               ``prefill``, ``decode_step``.
  weights.py — ``params_from_reference``: the reference's weights,
               unstacked; ``tree_to_reference``: back to its tree.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (LM, MambaLM, cast_for_compute,
                                      chunked_ce_loss, decode_step,
                                      embed_tokens, forward_hidden,
                                      init_cache, init_params, loss_fn,
                                      param_count, prefill, vocab_padded)
from repro_torch.models.weights import (params_from_reference,
                                        tree_to_reference)

__all__ = ["ModelConfig", "LM", "MambaLM", "init_params", "param_count",
           "vocab_padded", "embed_tokens", "init_cache", "prefill",
           "decode_step", "cast_for_compute", "forward_hidden",
           "chunked_ce_loss", "loss_fn", "params_from_reference",
           "tree_to_reference"]
