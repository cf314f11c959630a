"""The LM dry run's cells: the four input shapes, which architectures run
them, the inputs' stand-ins and the step each cell runs.

The port of ``repro.launch.shapes``, with the same names.  LM shapes are
seq_len x global batch.  ``decode_*`` and ``long_*`` run ``serve_step``
(one new token against a seq_len-deep cache), not ``train_step``.
``long_500k`` needs attention whose cost does not grow with the square of
the context (a sliding window or an SSM) and is skipped, with the
reference's reason, for architectures of full attention.

Where the reference builds ``ShapeDtypeStruct``s, :func:`input_specs`
builds tensors on a device: on ``meta`` (the default) they hold shapes
and types only, as the reference's stand-ins do; on a real device they
are zeros that the caller may fill.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models import model as model_mod
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# decoder-side cross-attention source length used for enc-dec decode cells
ENCDEC_DECODE_SRC = 4096


def applicability(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the skip reason (the
    reference's words)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return ("full quadratic attention (no SWA/SSM path) — 500k decode "
                "excluded per assignment; see DESIGN.md")
    return None


def input_specs(cfg: ModelConfig, shape: ShapeSpec, device="meta") -> Dict:
    """The inputs of this cell's step as tensors on ``device``, zeros where
    the device holds data, with the reference's shapes and types.

    train and prefill: ``tokens`` (and for train ``labels``) ``[B, S_txt]``
    int32, where a VLM's patch prefix takes ``frontend_len`` of the
    sequence, a VLM's ``frontend [B, frontend_len, frontend_dim]`` and an
    encoder-decoder's ``src [B, S, frontend_dim or d_model]``, float32.
    decode: ``token [B, 1]`` int32, ``pos`` a 0-dim int32 and ``caches``,
    the port's :func:`~repro_torch.models.model.init_cache` at cache
    length S (an encoder-decoder's cross-attention caches hold
    :data:`ENCDEC_DECODE_SRC` source frames)."""
    B, S = shape.batch, shape.seq

    def zeros(shp, dtype):
        return torch.zeros(shp, dtype=dtype, device=device)

    if shape.kind in ("train", "prefill"):
        S_txt = S - (cfg.frontend_len if cfg.frontend and not cfg.enc_layers
                     else 0)
        batch = {"tokens": zeros((B, S_txt), torch.int32),
                 "labels": zeros((B, S_txt), torch.int32)}
        if cfg.frontend and cfg.enc_layers == 0:
            batch["frontend"] = zeros((B, cfg.frontend_len, cfg.frontend_dim),
                                      torch.float32)
        if cfg.enc_layers:
            batch["src"] = zeros((B, S, cfg.frontend_dim or cfg.d_model),
                                 torch.float32)
        if shape.kind == "prefill":
            del batch["labels"]
        return batch
    src_len = ENCDEC_DECODE_SRC if cfg.enc_layers else 0
    return {"token": zeros((B, 1), torch.int32),
            "pos": zeros((), torch.int32),
            "caches": model_mod.init_cache(cfg, B, S, src_len=src_len,
                                           device=device)}


def make_step_fn(cfg: ModelConfig, shape: ShapeSpec, tcfg=None):
    """The function each cell runs.

    * train: the port's ``train_step(model, opt_state, ef, batch)``
      (:func:`repro_torch.train.trainer.make_train_step`; the model's
      parameters are updated in place).
    * prefill: ``prefill_step(model, batch) -> (logits [B, vocab_padded]
      float32, caches)``: the port's serving prefill
      (:func:`~repro_torch.models.model.prefill`) over the batch, caches
      as deep as the sequence.  The reference's ``prefill_step`` returns
      the last position's logits and the per-layer K/V of every position;
      the port's fills its serving caches (a windowed layer's last
      ``window`` positions) and applies the final logit softcap, as its
      serving does.
    * decode: ``serve_step(model, caches, token, pos) ->
      (logits, caches)``, one token at position ``pos`` (a Python int:
      the rolling cache's slot is picked on the host) through
      :func:`~repro_torch.models.model.decode_step`; K/V caches are
      written in place."""
    if shape.kind == "train":
        from repro_torch.train.trainer import TrainConfig, make_train_step

        return make_train_step(cfg, tcfg or TrainConfig())
    if shape.kind == "prefill":
        def prefill_step(model, batch):
            tokens = batch["tokens"]
            S_all = tokens.shape[1] + (batch["frontend"].shape[1]
                                       if "frontend" in batch else 0)
            return model_mod.prefill(model, cfg, tokens, S_all,
                                     frontend=batch.get("frontend"),
                                     src=batch.get("src"))

        return prefill_step

    def serve_step(model, caches, token, pos: int):
        return model_mod.decode_step(model, cfg, caches, token, pos)

    return serve_step
