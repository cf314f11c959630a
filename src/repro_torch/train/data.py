"""Synthetic deterministic data pipeline (numpy only).

The port's copy of ``repro.train.data``, kept here so the port imports
nothing of the JAX package; batches are bitwise equal to the reference's
for every family.  Next-token-prediction batches from a seeded
Markov-ish stream: enough structure that the loss decreases, fully
deterministic given (seed, step), and shardable per host
(:func:`host_slice`: each host makes only its own slice of the batch).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


def _tokens(rng: np.random.Generator, B: int, S: int, vocab: int):
    """Cheap structured stream: blockwise token-ramps + noise (learnable)."""
    base = rng.integers(0, vocab, (B, 1))
    step = rng.integers(1, 7, (B, 1))
    ramp = (base + step * np.arange(S + 1)[None, :]) % vocab
    noise = rng.integers(0, vocab, (B, S + 1))
    take = rng.random((B, S + 1)) < 0.1
    return np.where(take, noise, ramp).astype(np.int32)


def make_batch(cfg: ModelConfig, B: int, S: int, step: int, seed: int = 0,
               src_len: Optional[int] = None) -> Dict[str, np.ndarray]:
    """``tokens``, ``labels`` [B, S] int32 (the stream shifted by one); a
    VLM's ``frontend [B, frontend_len, frontend_dim]`` and an
    encoder-decoder's ``src [B, src_len or S, frontend_dim or d_model]``,
    float32 normals from the same generator."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    toks = _tokens(rng, B, S, cfg.vocab)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend and cfg.enc_layers == 0:
        batch["frontend"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    if cfg.enc_layers:
        batch["src"] = rng.standard_normal(
            (B, src_len or S, cfg.frontend_dim or cfg.d_model)
        ).astype(np.float32)
    return batch


def host_slice(batch: Dict[str, np.ndarray], host_id: int, n_hosts: int):
    """The per-host shard of a global batch (batch dim split)."""
    def sl(x):
        per = x.shape[0] // n_hosts
        return x[host_id * per:(host_id + 1) * per]

    return {k: sl(v) for k, v in batch.items()}


def batches(cfg: ModelConfig, B: int, S: int, seed: int = 0,
            start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """:func:`make_batch` at steps ``start_step, start_step + 1, ...``."""
    step = start_step
    while True:
        yield make_batch(cfg, B, S, step, seed)
        step += 1
