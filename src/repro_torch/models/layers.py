"""Model layers of the port: norms, rope, attention, MLPs, MoE and Mamba1.

The port of ``repro.models.layers`` for serving and training every
family: pure functions over a dict of one layer's weights, as the
reference's, and the ``nn.Module``s that hold them (:class:`Attention`,
:class:`MLP`, :class:`MoE`, :class:`MambaMixer`).  Every function is
differentiable: weights are cast at each use (``.to(x.dtype)``), so the
gradient of a float32 weight used in bf16 reaches it in float32, and the
Mamba scan runs through :class:`repro_torch.kernels.ssm_scan.SsmScan` (K6
forward, K6b backward on the card).

Attention is plain PyTorch: the reference computes it outside any Pallas
kernel, and its online softmax over blocks rounds otherwise than one
``scaled_dot_product_attention`` call would.

Arithmetic follows the reference as its serving path runs it.  Its
prefill runs eagerly, so each bf16 operation rounds its result to bf16, as
PyTorch does; but its selective scan is compiled (``lax.scan``) and its
decode step jitted, and there XLA keeps the bf16 product ``dt * B`` in
float32 (excess precision), where it is exact.  So :func:`_ssm_step` (the
decode step) casts ``dt`` and ``B`` to float32 before it multiplies them.
With bf16 inputs ``(dt * B) * x`` (this order) and ``(dt * x) * B`` (K6's,
which the scan runs on both routes) are then both exact in float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ref import ssm_readout
from repro_torch.kernels.ssm_scan import SsmScan
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


def rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: [..., S] int.  Angles in float32;
    a bf16 ``x`` times the float32 ``cos`` is float32, cast back last."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., :, None].float() * freqs       # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]               # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(x, p, cfg: ModelConfig):
    """x [B,S,d] -> q [B,S,H,hd], k/v [B,S,KV,hd] (pre-rope)."""
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"].to(x.dtype).reshape(d, H * hd)).view(B, S, H, hd)
    k = (x @ p["wk"].to(x.dtype).reshape(d, KV * hd)).view(B, S, KV, hd)
    v = (x @ p["wv"].to(x.dtype).reshape(d, KV * hd)).view(B, S, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def repeat_kv(k, rep: int):
    """[B,S,KV,hd] -> [B,S,KV*rep,hd]; head ``h`` is kv head ``h // rep``."""
    if rep == 1:
        return k
    B, S, KV, hd = k.shape
    return k[:, :, :, None, :].expand(B, S, KV, rep, hd).reshape(
        B, S, KV * rep, hd)


def _mask(qp, kp, kind: int, window):
    """[qb, cb] bool: causal, within the window for kind 1, all for kind 2."""
    if kind == 2:                 # bidirectional (encoder)
        return torch.ones((qp.shape[0], kp.shape[0]), dtype=torch.bool,
                          device=qp.device)
    mask = kp[None, :] <= qp[:, None]
    if kind == 1:
        mask = mask & ((qp[:, None] - kp[None, :]) < (window or (1 << 30)))
    return mask


def blockwise_attention(q, k, v, q_pos, k_pos, cfg: ModelConfig, kind: int,
                        q_block: int = 512, kv_block: int = 1024):
    """Online-softmax attention over ``q_block`` x ``kv_block`` tiles, the
    kv blocks in ascending order; never materialises [Sq, Sk].

    q [B,Sq,H,hd]; k/v [B,Sk,KV,hd]; kind: 0 global-causal, 1 windowed,
    2 bidirectional.  Returns [B, Sq, H*hd] in ``q.dtype``.  Masked scores
    are -1e30 and the running max starts at -inf, as in the reference: a
    window row whose first kv block is all masked carries ``exp(0)`` terms
    until the next block's correction ``exp(m - m_new) = 0`` clears them.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    k = repeat_kv(k, H // KV)
    v = repeat_kv(v, H // KV)
    scale = 1.0 / math.sqrt(hd)
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Sk)
    assert Sq % q_block == 0 and Sk % kv_block == 0
    # [B, H, S, hd]: the score and value products as batched matmuls
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    outs = []
    for q0 in range(0, Sq, q_block):
        qb = qh[:, :, q0:q0 + q_block]
        qpb = q_pos[q0:q0 + q_block]
        m = torch.full((B, H, q_block), -torch.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, q_block), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, H, q_block, hd), dtype=q.dtype,
                          device=q.device)
        for k0 in range(0, Sk, kv_block):
            kb = kh[:, :, k0:k0 + kv_block]
            vb = vh[:, :, k0:k0 + kv_block]
            s = (qb @ kb.transpose(-1, -2)).float()       # [B,H,qb,cb]
            s = softcap(s * scale, cfg.attn_softcap)
            mask = _mask(qpb, k_pos[k0:k0 + kv_block], kind, cfg.window)
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p_ = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p_.sum(-1)
            pv = p_.to(vb.dtype) @ vb
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
        outs.append(out.transpose(1, 2).reshape(B, q_block, H * hd))
    return torch.cat(outs, dim=1)


def attention_train(x, p, cfg: ModelConfig, kind: int, positions=None,
                    return_kv: bool = False):
    """Full-sequence attention for training and prefill: x [B,S,d] ->
    [B,S,d] (with ``return_kv`` also the roped k and the v, [B,S,KV,hd]).
    ``positions`` [S] default to ``0..S-1``."""
    S = x.shape[1]
    pos = (positions if positions is not None
           else torch.arange(S, device=x.device))
    q, k, v = _qkv(x, p, cfg)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    o = blockwise_attention(q, k, v, pos, pos, cfg, kind)
    out = o @ p["wo"].to(x.dtype)
    return (out, (k, v)) if return_kv else out


def attention_decode(x, p, cfg: ModelConfig, kind: int, cache_k, cache_v,
                     cache_pos, pos: int):
    """Single-token decode.  x [B,1,d]; caches [B,C,KV,hd]; ``pos`` int.

    Rolling buffer: the new K/V lands at slot ``pos % C``, written into the
    caches in place (they are returned too); masking is by the absolute
    positions in ``cache_pos`` [B, C] (-1 = empty).  Works for full caches
    (C = max_len) and windowed ones (C = window)."""
    B, C = cache_k.shape[0], cache_k.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rep = H // KV
    q, k, v = _qkv(x, p, cfg)
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    slot = pos % C
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    cache_pos[:, slot] = pos

    qh = q.reshape(B, KV, rep, hd)
    s = torch.einsum("bkrh,bckh->bkrc", qh, cache_k).float()
    s = softcap(s / math.sqrt(hd), cfg.attn_softcap)
    valid = (cache_pos >= 0) & (cache_pos <= pos)
    if kind == 1:
        valid = valid & ((pos - cache_pos) < (cfg.window or (1 << 30)))
    s = torch.where(valid[:, None, None, :], s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrc,bckh->bkrh", w.to(cache_v.dtype), cache_v)
    out = o.reshape(B, 1, H * hd) @ p["wo"].to(x.dtype)
    return out, cache_k, cache_v, cache_pos


def cross_attention(x, p, cfg: ModelConfig, enc_k, enc_v):
    """Decoder-to-encoder attention, blockwise and unmasked (kind 2).
    x [B,S,d]; ``enc_k``/``enc_v`` [B,Ss,KV,hd], computed once a
    generation from the encoder's output."""
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"].to(x.dtype).reshape(d, H * hd)).view(B, S, H, hd)
    dev = x.device
    o = blockwise_attention(q, enc_k, enc_v, torch.arange(S, device=dev),
                            torch.arange(enc_k.shape[1], device=dev), cfg, 2)
    return o @ p["wo"].to(x.dtype)


def encoder_attention(x, p, cfg: ModelConfig):
    """Bidirectional self-attention of the encoder (kind 2), with rope."""
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    q, k, v = _qkv(x, p, cfg)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    o = blockwise_attention(q, k, v, pos, pos, cfg, 2)
    return o @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation; F.gelu's is not
    return F.gelu(x, approximate="tanh")


def mlp(x, p, cfg: ModelConfig):
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w1"].to(x.dtype)) * (x @ p["w3"].to(x.dtype))
    elif cfg.mlp_type == "geglu":   # gemma2
        h = _gelu(x @ p["w1"].to(x.dtype)) * (x @ p["w3"].to(x.dtype))
    elif cfg.mlp_type == "gelu":
        h = _gelu(x @ p["w1"].to(x.dtype))
    else:
        raise ValueError(cfg.mlp_type)
    return h @ p["w2"].to(x.dtype)


# ---------------------------------------------------------------------------
# MoE (GShard grouped capacity dispatch)
# ---------------------------------------------------------------------------

class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor


class MoERoute(NamedTuple):
    """A group's routing: ``gate_w``/``gate_i`` [ng, G, k] (softmaxed
    weights, expert ids), ``pos``/``keep`` [ng, G*k, E] (each (token,
    slot) pair's capacity position in each expert, token-major, and
    whether it holds an expert's slot below the capacity), the capacity
    ``C`` and the aux loss."""

    gate_w: torch.Tensor
    gate_i: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    C: int
    aux_loss: torch.Tensor


def one_hot(x, n: int, dtype):
    """``jax.nn.one_hot``: all zeros where ``x`` lies outside ``[0, n)``
    (``F.one_hot`` raises there)."""
    return (x[..., None] == torch.arange(n, device=x.device)).to(dtype)


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest, descending,
    the lower index first among equal values.  A stable descending sort
    keeps equal values in index order; ``torch.topk`` promises no order
    among ties on CUDA."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(logits, cfg: ModelConfig) -> MoERoute:
    """Router top-k, capacity positions and the Switch aux loss over
    float32 ``logits`` [ng, G, E]."""
    ng, G, E = logits.shape
    k = cfg.top_k
    C = max(int(np.ceil(G * k * cfg.capacity_factor / E)), 1)
    gate_w, gate_i = top_k(logits, k)                      # [ng,G,k]
    gate_w = torch.softmax(gate_w, dim=-1)
    # aux load-balance loss (Switch): E * mean_e(frac_tokens * mean_prob)
    probs = torch.softmax(logits, dim=-1)
    frac_tok = one_hot(gate_i[..., 0], E, torch.float32).mean(dim=1)
    frac_prob = probs.mean(dim=1)
    aux = E * torch.mean(torch.sum(frac_tok * frac_prob, -1))
    # capacity positions over flattened (token, slot) pairs, token-major
    af = one_hot(gate_i, E, torch.int32).reshape(ng, G * k, E)
    pos = torch.cumsum(af, dim=1, dtype=torch.int32) - af
    keep = (pos < C) & (af > 0)
    return MoERoute(gate_w, gate_i, pos, keep, C, aux)


def _expert_compute(xe, p, cfg: ModelConfig):
    """xe [g,E,C,d] -> ye [g,E,C,d] through each expert's FFN."""
    w1 = p["w1"].to(xe.dtype)                              # [E,d,f]
    w2 = p["w2"].to(xe.dtype)                              # [E,f,d]
    if cfg.mlp_type in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_type == "swiglu" else _gelu
        h = act(torch.einsum("gecd,edf->gecf", xe, w1))
        h = h * torch.einsum("gecd,edf->gecf", xe, p["w3"].to(xe.dtype))
    else:
        h = _gelu(torch.einsum("gecd,edf->gecf", xe, w1))
    return torch.einsum("gecf,efd->gecd", h, w2)


def moe_ffn(x, p, cfg: ModelConfig) -> MoEOut:
    """x [B,S,d] -> [B,S,d].  Router top-k and capacity-limited dispatch
    over groups of ``G = min(moe_group, B*S)`` tokens, each expert taking
    at most ``C = ceil(G k capacity_factor / E)`` (token, slot) pairs in
    token order; the rest are dropped (their slot adds nothing).  So a
    token's output depends on the other tokens of its group.

    Two dispatch forms, as the reference's: ``moe_impl="onehot"`` (GShard:
    einsums against one-hot dispatch and combine tensors) and
    ``"gather"`` (slot tables: gather the tokens' rows into [E, C, d] and
    gather each (token, slot)'s expert row back).  Plain PyTorch: the
    reference computes both outside any kernel."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = min(cfg.moe_group, T)
    assert T % G == 0, (T, G)
    ng = T // G
    xt = x.reshape(ng, G, d)
    logits = (xt @ p["router"].to(x.dtype)).float()
    r = moe_route(logits, cfg)
    C = r.C

    if cfg.moe_impl == "gather":
        gi = r.gate_i.reshape(ng, G * k)
        pos_tk = torch.gather(r.pos, 2, gi[..., None])[..., 0]
        keep_tk = torch.gather(r.keep, 2, gi[..., None])[..., 0]
        # slot tables: slot_token[g, e, c] = the token feeding that slot; a
        # dropped pair writes a spare slot past the end, so no shape hangs
        # on the routing (no host read; the step runs on ``meta`` too)
        tok = (torch.arange(G * k, device=x.device) // k).expand(ng, G * k)
        g_idx = torch.arange(ng, device=x.device)[:, None].expand(ng, G * k)
        slot = torch.where(keep_tk, (g_idx * E + gi) * C + pos_tk, ng * E * C)
        slot_token = torch.zeros(ng * E * C + 1, dtype=torch.int64,
                                 device=x.device)
        slot_token.index_put_((slot.reshape(-1),), tok.reshape(-1))
        slot_token = slot_token[:-1]
        xe = torch.gather(xt, 1, slot_token.reshape(ng, E * C, 1)
                          .expand(ng, E * C, d)).reshape(ng, E, C, d)
        ye = _expert_compute(xe, p, cfg)
        # combine: each (token, slot)'s expert row
        idx = torch.where(keep_tk, gi * C + torch.clamp(pos_tk, max=C - 1), 0)
        rows = torch.gather(ye.reshape(ng, E * C, d), 1,
                            idx[..., None].expand(ng, G * k, d))
        rows = rows * keep_tk[..., None].to(rows.dtype)
        wf = r.gate_w.reshape(ng, G * k)[..., None].to(rows.dtype)
        y = (rows * wf).reshape(ng, G, k, d).sum(2)
        return MoEOut(y.reshape(B, S, d), r.aux_loss)

    pos_oh = one_hot(r.pos, C, x.dtype) * r.keep[..., None].to(x.dtype)
    disp = pos_oh.reshape(ng, G, k, E, C)                  # one-hot [..E,C]
    wf = r.gate_w.to(x.dtype)[..., None, None]             # [ng,G,k,1,1]
    combine = (disp * wf).sum(2)                           # [ng,G,E,C]
    disp_t = disp.sum(2)                                   # [ng,G,E,C]
    xe = torch.einsum("gtec,gtd->gecd", disp_t, xt)        # dispatch
    ye = _expert_compute(xe, p, cfg)
    y = torch.einsum("gecd,gtec->gtd", ye, combine)        # combine
    return MoEOut(y.reshape(B, S, d), r.aux_loss)


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

    The scan is :class:`~repro_torch.kernels.ssm_scan.SsmScan`: K6 forward
    and K6b backward on CUDA tensors, their plain versions on CPU tensors.
    ``chunk`` is the reference's rematerialisation unit, which the port has
    no use for (K6b recomputes the states itself); its ``S % chunk == 0``
    check is kept on both routes."""
    S = x1.shape[1]
    chunk = min(chunk, S)
    assert S % chunk == 0
    y, h = SsmScan.apply(x1, dt, Bm, Cm, A, h0)
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


class _Weights(nn.Module):
    """One layer's weights of one kind, float32 leaves named and shaped as
    the reference's; :func:`repro_torch.models.model.init_params` or
    :func:`~repro_torch.models.weights.params_from_reference` fill them."""

    def __init__(self, cfg: ModelConfig, shapes: dict, device=None):
        super().__init__()
        self.cfg = cfg
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=torch.float32, device=device),
                requires_grad=False))

    def weights(self) -> dict:
        return dict(self.named_parameters(recurse=False))


class Attention(_Weights):
    """The reference's ``layers.attn`` leaves of one layer: ``wq [d, H,
    hd]``, ``wk``/``wv [d, KV, hd]``, ``wo [H*hd, d]``, and ``q_norm``/
    ``k_norm [hd]`` with qk-norm."""

    def __init__(self, cfg: ModelConfig, device=None):
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        shapes = {"wq": (d, H, hd), "wk": (d, KV, hd), "wv": (d, KV, hd),
                  "wo": (H * hd, d)}
        if cfg.qk_norm:
            shapes.update(q_norm=(hd,), k_norm=(hd,))
        super().__init__(cfg, shapes, device)


class MLP(_Weights):
    """The reference's ``layers.mlp`` leaves: ``w1 [d, ff]``, ``w3 [d, ff]``
    (swiglu, geglu), ``w2 [ff, d]``; :func:`mlp` over them."""

    def __init__(self, cfg: ModelConfig, device=None):
        d, ff = cfg.d_model, cfg.d_ff
        shapes = {"w1": (d, ff), "w2": (ff, d)}
        if cfg.mlp_type in ("swiglu", "geglu"):
            shapes["w3"] = (d, ff)
        super().__init__(cfg, shapes, device)

    def forward(self, x):
        return mlp(x, self.weights(), self.cfg)


class MoE(_Weights):
    """The reference's ``layers.moe`` leaves of one layer: ``router [d,
    E]``, ``w1 [E, d, f]``, ``w3 [E, d, f]`` (swiglu, geglu), ``w2 [E, f,
    d]``; :func:`moe_ffn` over them."""

    def __init__(self, cfg: ModelConfig, device=None):
        d, E, f = cfg.d_model, cfg.n_experts, cfg.eff_moe_d_ff
        shapes = {"router": (d, E), "w1": (E, d, f), "w2": (E, f, d)}
        if cfg.mlp_type in ("swiglu", "geglu"):
            shapes["w3"] = (E, d, f)
        super().__init__(cfg, shapes, device)

    def forward(self, x) -> MoEOut:
        return moe_ffn(x, self.weights(), self.cfg)


class MambaMixer(_Weights):
    """One Mamba1 block's weights (the reference's ``layers.ssm`` leaves of
    one layer) and :func:`mamba_block` over them."""

    def __init__(self, cfg: ModelConfig, device=None):
        d, di, st, r, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                           cfg.dt_rank, cfg.ssm_conv)
        super().__init__(cfg, {
            "in_proj": (d, 2 * di), "conv_w": (di, k), "conv_b": (di,),
            "x_proj": (di, r + 2 * st), "dt_proj": (r, di),
            "dt_bias": (di,), "A_log": (di, st), "D": (di,),
            "out_proj": (di, d)}, device)

    def forward(self, x, h0=None, conv_buf=None, decode: bool = False):
        return mamba_block(x, self.weights(), self.cfg, h0=h0,
                           conv_buf=conv_buf, decode=decode)
