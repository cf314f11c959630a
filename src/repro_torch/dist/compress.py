"""int8 gradient compression with error feedback.

The port of ``repro.dist.compress``.  Gradients that cross a slow link
are quantized to int8 (a quarter of float32's bytes); error feedback
(Seide et al. 2014, Karimireddy et al. 2019) adds each step's
quantization error back in before the next quantization, so the errors
telescope instead of compounding.  The error state is bf16: the residual
is at most one quantization step.

    g_q, ef = compress_grads(grads, ef)     # {name: tensor} dicts

The scale is per tensor, and the reference's tensor is its stacked
``[L, ...]`` leaf: so the port's per-layer gradients of one leaf share one
scale, their largest magnitude over the layers
(:func:`repro_torch.models.weights.reference_leaf` names the group).  A
scale per layer would round most elements to another quantum.  ``q`` is
then bitwise equal to the reference's: ``x / scale * 127`` divides then
multiplies, and ``torch.round`` rounds half to even as ``jnp.round``
does.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import torch
from torch import nn

from repro_torch.models.weights import reference_leaf


class Quantized(NamedTuple):
    q: torch.Tensor       # int8 payload
    scale: torch.Tensor   # f32 per-tensor max-abs scale


def quantize(x: torch.Tensor, amax=None) -> Quantized:
    """Symmetric per-tensor int8: q = round(x / scale * 127), ``scale`` the
    largest ``|x|``, or ``amax`` where the tensor is a slice of a larger
    one whose largest magnitude that is."""
    x = x.float()
    if amax is None:
        amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(x / scale * 127.0), -127, 127).to(torch.int8)
    return Quantized(q=q, scale=scale)


def dequantize(z: Quantized) -> torch.Tensor:
    # a tensor divisor: a true division on every device (CUDA multiplies
    # by the reciprocal of a Python scalar divisor)
    step = z.scale / torch.full((), 127.0, dtype=torch.float32,
                                device=z.scale.device)
    return z.q.float() * step


def init_error_feedback(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Zero residual state, one bf16 buffer per parameter."""
    return {n: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
            for n, p in model.named_parameters()}


def compress_grads(grads: Mapping[str, torch.Tensor],
                   ef_state: Mapping[str, torch.Tensor]):
    """Quantize-dequantize every gradient with error feedback, the layers'
    slices of one reference leaf on one scale.  Returns (the compressed
    float32 gradients, the new bf16 errors), keyed as ``grads``.
    Invariant (tested): the compressed gradients summed over steps plus
    the last error equal the true gradients summed, up to the residual's
    bf16 rounding."""
    def total(name):
        return grads[name].float() + ef_state[name].float()

    amax: Dict[str, torch.Tensor] = {}
    for name in grads:     # a first pass for the shared scales
        m = torch.max(torch.abs(total(name)))
        key = reference_leaf(name)
        amax[key] = m if key not in amax else torch.maximum(amax[key], m)
    out, ef = {}, {}
    for name in grads:
        t = total(name)
        y = dequantize(quantize(t, amax[reference_leaf(name)]))
        out[name], ef[name] = y, (t - y).to(torch.bfloat16)
    return out, ef
