"""Model layers of the port: the Mamba1 (selective SSM) block.

The port of the Mamba section of ``repro.models.layers`` (with the
``rmsnorm`` it needs): pure functions over a dict of one layer's weights,
as the reference's, and :class:`MambaMixer`, the ``nn.Module`` that holds
them.  Attention, MLP and MoE layers are not ported yet (ROADMAP queue 1,
item 10).

Arithmetic follows the reference as its serving path runs it.  Its
prefill runs eagerly, so each bf16 operation rounds its result to bf16, as
PyTorch does; but its selective scan is compiled (``lax.scan``) and its
decode step jitted, and there XLA keeps the bf16 product ``dt * B`` in
float32 (excess precision), where it is exact.  So :func:`_ssm_step` casts
``dt`` and ``B`` to float32 before it multiplies them.  With bf16 inputs
``(dt * B) * x`` (this order) and ``(dt * x) * B`` (K6's) are then both
exact in float32, and the CPU scan equals K6 bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels._launch import on_cuda
from repro_torch.kernels.ref import ssm_readout
from repro_torch.models.config import ModelConfig


def rmsnorm(x, w, eps=1e-6, plus_one=False):
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (y * scale).to(dt)


def softcap(x, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def softplus(x):
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it,
    ``logaddexp(x, 0)`` (``F.softplus`` takes another formula)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Mamba1 (selective SSM)
# ---------------------------------------------------------------------------

def _causal_conv(x, w, b, ssm_conv: int):
    """Depthwise causal conv over S.  x [B,S,di]; w [di,k]; b [di]."""
    k = ssm_conv
    pad = F.pad(x, (0, 0, k - 1, 0))
    y = sum(pad[:, j:j + x.shape[1]] * w[:, j].to(x.dtype)
            for j in range(k))
    return y + b.to(x.dtype)


def _ssm_inputs(x1, p, cfg: ModelConfig):
    """x1 [B,S,di] -> dt [B,S,di], Bm/Cm [B,S,state], A [di,state], D [di]."""
    xdbc = x1 @ p["x_proj"].to(x1.dtype)        # [B,S,dt_rank+2*state]
    r, st = cfg.dt_rank, cfg.ssm_state
    dt_in, Bm, Cm = xdbc[..., :r], xdbc[..., r:r + st], xdbc[..., r + st:]
    dt = softplus(dt_in @ p["dt_proj"].to(x1.dtype)
                  + p["dt_bias"].to(x1.dtype))  # [B,S,di]
    A = -torch.exp(p["A_log"].float())          # [di,state]
    return dt, Bm, Cm, A, p["D"].float()


def _ssm_step(h, x_t, dt_t, B_t, C_t, A):
    """One recurrence step.  h [B,di,state]; the sum over state in
    ascending order (:func:`~repro_torch.kernels.ref.ssm_readout`)."""
    dt32 = dt_t.float()
    da = torch.exp(dt32[..., None] * A)                       # [B,di,st]
    dbx = (dt32[..., None] * B_t.float()[:, None, :]) \
        * x_t.float()[..., None]
    h = da * h + dbx
    return h, ssm_readout(h, C_t.float())                     # [B,di]


def mamba_scan(x1, dt, Bm, Cm, A, D, h0, chunk: int):
    """Selective scan with the D skip.  x1 [B,S,di] -> y [B,S,di] f32, h.

    On CUDA tensors it launches K6 (:func:`repro_torch.kernels.ops.ssm_scan`)
    and adds the D skip; on CPU tensors it runs the scan step by step
    (:func:`_ssm_step`).  ``chunk`` is the reference's rematerialisation
    unit, which an eager scan has no use for; its ``S % chunk == 0`` check
    is kept on both routes."""
    B, S, di = x1.shape
    chunk = min(chunk, S)
    assert S % chunk == 0
    if on_cuda(x1, dt, Bm, Cm, A, h0):
        y, h = kops.ssm_scan(x1, dt, Bm, Cm, A, h0)
    else:
        y = torch.empty((B, S, di), dtype=torch.float32, device=x1.device)
        h = h0
        for t in range(S):
            h, y[:, t] = _ssm_step(h, x1[:, t], dt[:, t], Bm[:, t], Cm[:, t],
                                   A)
    y = y + D[None, None, :] * x1.float()
    return y, h


def mamba_block(x, p, cfg: ModelConfig, h0=None, conv_buf=None,
                decode: bool = False):
    """Mamba1 block.  Train: x [B,S,d].  Decode: x [B,1,d] + carried state.

    Returns (y, h, conv_buf) — conv_buf is None in train mode.
    """
    B = x.shape[0]
    di, st = cfg.d_inner, cfg.ssm_state
    xz = x @ p["in_proj"].to(x.dtype)          # [B,S,2*di]
    x1, z = xz[..., :di], xz[..., di:]

    if not decode:
        x1 = F.silu(_causal_conv(x1, p["conv_w"], p["conv_b"], cfg.ssm_conv))
        dt, Bm, Cm, A, D = _ssm_inputs(x1, p, cfg)
        if h0 is None:
            h0 = torch.zeros((B, di, st), dtype=torch.float32,
                             device=x.device)
        y, h = mamba_scan(x1, dt, Bm, Cm, A, D, h0, cfg.ssm_chunk)
        y = y.to(x.dtype) * F.silu(z)
        return y @ p["out_proj"].to(x.dtype), h, None

    # decode: conv_buf [B, k-1, di] carries the last k-1 pre-conv inputs
    k = cfg.ssm_conv
    window = torch.cat([conv_buf, x1], dim=1)               # [B,k,di]
    xc = sum(window[:, j] * p["conv_w"][:, j].to(x.dtype)
             for j in range(k)) + p["conv_b"].to(x.dtype)
    xc = F.silu(xc)[:, None, :]                             # [B,1,di]
    dt, Bm, Cm, A, D = _ssm_inputs(xc, p, cfg)
    h, y = _ssm_step(h0, xc[:, 0], dt[:, 0], Bm[:, 0], Cm[:, 0], A)
    y = y + D[None, :] * xc[:, 0].float()
    y = y[:, None, :].to(x.dtype) * F.silu(z)
    return y @ p["out_proj"].to(x.dtype), h, window[:, 1:]


class MambaMixer(nn.Module):
    """One Mamba1 block's weights (the reference's ``layers.ssm`` leaves of
    one layer, same names and shapes, float32) and :func:`mamba_block`
    over them.  :func:`repro_torch.models.model.init_params` fills them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, di, st, r, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                           cfg.dt_rank, cfg.ssm_conv)
        shapes = {"in_proj": (d, 2 * di), "conv_w": (di, k), "conv_b": (di,),
                  "x_proj": (di, r + 2 * st), "dt_proj": (r, di),
                  "dt_bias": (di,), "A_log": (di, st), "D": (di,),
                  "out_proj": (di, d)}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=torch.float32, device=device),
                requires_grad=False))

    def weights(self) -> dict:
        return dict(self.named_parameters(recurse=False))

    def forward(self, x, h0=None, conv_buf=None, decode: bool = False):
        return mamba_block(x, self.weights(), self.cfg, h0=h0,
                           conv_buf=conv_buf, decode=decode)
