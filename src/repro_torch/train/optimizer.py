"""AdamW and its schedule over the model's parameters.

The port of ``repro.train.optimizer``.  The reference works on its param
pytree and returns a new one; here the state is keyed by the model's
parameter names and :func:`adamw_update` writes the new parameters and
moments in place (no second copy of a 1.6 B-parameter model and its
moments).  Every scalar (the step, the learning rate, the clip scale)
stays a tensor on the device, so a step reads nothing back to the host.
Moments may be kept in bf16 (``state_dtype``); the update runs in float32.

Weight decay follows the reference's rule, ``p.ndim >= 2``, read on the
reference's leaf: its per-layer leaves are stacked ``[L, ...]``, so every
per-layer parameter is decayed (norms, ``D``, ``dt_bias``, ``conv_b``
and ``A_log`` included) and of the top-level ones only the matrices
(``final_norm`` and ``enc_norm`` are not).  The port's per-layer
parameters have one dimension fewer, so :func:`decays` adds it back
(:func:`reference_ndim`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple

import torch
from torch import nn

from repro_torch.models.weights import stacked


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"   # or "bfloat16" to halve optimizer memory


class OptState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: torch.Tensor             # int32, 0-dim, on the device


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """The rank of ``name``'s leaf in the reference's tree: one more for a
    per-layer parameter (stacked ``[L, ...]`` there)."""
    return p.dim() + (1 if stacked(name) else 0)


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether AdamW decays ``name``: the reference's ``p.ndim >= 2`` on
    its own leaf."""
    return reference_ndim(name, p) >= 2


def init_opt_state(model: nn.Module, cfg: AdamWConfig) -> OptState:
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                for n, p in params.items()}

    return OptState(m=zeros(), v=zeros(),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``: float32, on
    ``step``'s device, in the reference's order of operations."""
    step = step.float()

    def const(x):   # a true division on every device (CUDA multiplies by
        # the reciprocal of a Python scalar divisor)
        return torch.full((), x, dtype=torch.float32, device=step.device)

    warm = torch.clamp(step / const(max(cfg.warmup_steps, 1)), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / const(max(cfg.total_steps - cfg.warmup_steps, 1)),
                    0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum over leaves of sum(g^2))`` in float32."""
    total = None
    for g in grads.values():
        s = torch.sum(g.float() ** 2)
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(model: nn.Module, grads: Mapping[str, torch.Tensor],
                 state: OptState, cfg: AdamWConfig):
    """One AdamW step with global-norm clipping and decoupled weight decay
    (:func:`decays`).  ``grads`` maps every parameter name to its gradient.
    Writes the new parameters and moments in place; returns (the new
    state, ``{"lr", "grad_norm"}``), all tensors on the device."""
    step = state.step + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    clip = torch.full((), cfg.clip_norm, dtype=torch.float32,
                      device=gnorm.device)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for name, p in model.named_parameters():
        m, v = state.m[name], state.v[name]
        g = grads[name].float() * scale
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * g * g
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if decays(name, p):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return OptState(state.m, state.v, step), {"lr": lr, "grad_norm": gnorm}
