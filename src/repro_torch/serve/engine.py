"""Batched serving engine: prefill, then one decode step a token.

The port of ``repro.serve.engine``.  Requests fill the engine's batch
(left-padded to the longest prompt), prefill runs the full-sequence layers
and fills each layer's cache, and ``decode_step`` advances every slot one
token per tick, greedily or by seeded sampling (``np.random.default_rng``).
It serves every family; as the reference's, it passes no VLM patch
prefix and no encoder source, so those models take them through
:func:`~repro_torch.models.model.prefill` and ``decode_step`` directly.
On the card each Mamba layer's prefill scan is kernel K6; attention, the
MLPs and the MoE are plain PyTorch.

The engine casts each weight once to the dtype its use casts it to
(:func:`~repro_torch.models.model.cast_for_compute`), which gives the same
bits as casting at each use.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import model as model_mod
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # [S] int32
    max_new: int = 16
    out: Optional[np.ndarray] = None


class Engine:
    def __init__(self, cfg: ModelConfig, params, batch: int, cache_len: int,
                 eos: int = -1, *, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = model_mod.cast_for_compute(params, cfg,
                                                 device=self.device)
        self.B, self.C, self.eos = batch, cache_len, eos

    def generate(self, requests: List[Request], greedy: bool = True,
                 seed: int = 0) -> List[np.ndarray]:
        """Serve a batch of requests (padded to engine batch)."""
        cfg = self.cfg
        assert len(requests) <= self.B
        S = max(len(r.prompt) for r in requests)
        toks = np.zeros((self.B, S), np.int32)
        for i, r in enumerate(requests):
            toks[i, S - len(r.prompt):] = r.prompt  # left-pad
        logits, caches = model_mod.prefill(
            self.params, cfg, torch.as_tensor(toks, device=self.device),
            self.C)
        max_new = max(r.max_new for r in requests)
        outs = [[] for _ in requests]
        rng = np.random.default_rng(seed)
        cur = torch.argmax(logits, -1).cpu().numpy().astype(np.int32)
        for i in range(len(requests)):
            outs[i].append(int(cur[i]))
        pos = S
        for t in range(max_new - 1):
            tok = torch.as_tensor(cur[:, None], device=self.device)
            logits, caches = model_mod.decode_step(self.params, cfg, caches,
                                                   tok, pos)
            if greedy:
                cur = torch.argmax(logits, -1).cpu().numpy().astype(np.int32)
            else:
                p = torch.softmax(logits, -1).cpu().numpy()
                cur = np.array([rng.choice(p.shape[1], p=p[i])
                                for i in range(p.shape[0])], np.int32)
            pos += 1
            for i, r in enumerate(requests):
                if len(outs[i]) < r.max_new:
                    outs[i].append(int(cur[i]))
        return [np.asarray(o, np.int32) for o in outs]
