"""Model assembly of the port: init, prefill, decode.

The port of ``repro.models.model`` for the ``ssm`` (falcon-mamba-7b),
``hybrid`` (hymba-1.5b) and ``dense`` (qwen3-4b, gemma2-2b,
phi3-medium-14b, starcoder2-15b) families, tied or untied head.  The
reference stacks per-layer leaves ``[L, ...]`` for ``lax.scan``; here the
model is an ``nn.Module`` (:class:`LM`) with one :class:`Layer` per layer in
an ``nn.ModuleList``, and the layer loop is a Python loop.  The functions
keep the reference's signatures with the model in place of the param
pytree.

One deliberate parting: :func:`prefill` writes position ``p`` of a layer's
K/V at cache slot ``p % C``, the slot :func:`~repro_torch.models.layers.
attention_decode` reads and overwrites.  The reference writes the last
``C`` positions at slots ``0..C-1``, which agrees only when ``S <= C`` or
``C`` divides ``S``; at other lengths its first decode steps overwrite
positions still inside a window (ROADMAP queue 3).

The ``moe``, ``vlm`` and ``encdec`` families raise ``NotImplementedError``
(ROADMAP queue 1, item 1), and so does training (``forward_hidden``,
``loss_fn``, ``chunked_ce_loss`` are not ported yet).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

PORTED_FAMILIES = ("ssm", "hybrid", "dense")

# weights that every use casts to the compute dtype (``.to(x.dtype)`` in
# layers.py and here); A_log, D and the norms (q_norm, k_norm too) are used
# in float32
_COMPUTE_CAST = ("embed", "lm_head", "in_proj", "conv_w", "conv_b", "x_proj",
                 "dt_proj", "dt_bias", "out_proj", "wq", "wk", "wv", "wo",
                 "w1", "w2", "w3")


def vocab_padded(cfg: ModelConfig) -> int:
    return int(np.ceil(cfg.vocab / 512)) * 512


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP queue 1, item 1: MoE, VLM, enc-dec); the port "
            f"serves {', '.join(repr(f) for f in PORTED_FAMILIES)} models")


def _cdtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _kinds(cfg: ModelConfig):
    return cfg.layer_kinds() if cfg.family != "ssm" else (0,) * cfg.n_layers


def _vector(d: int, device):
    return nn.Parameter(torch.empty(d, device=device), requires_grad=False)


class Layer(nn.Module):
    """One residual block.  ``ssm``: ``x + mamba(rmsnorm(x, ln1))``.  Else
    ``x + attn`` (hybrid: ``0.5 * (attn + mamba)`` on the same normed
    input), then ``x + mlp(rmsnorm(x, ln2))``; with sandwich norms each
    branch's output is normed again (``ln1_post``, ``ln2_post``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _vector(d, device)
        if cfg.family != "ssm":
            self.ln2 = _vector(d, device)
            if cfg.sandwich_norm:
                self.ln1_post = _vector(d, device)
                self.ln2_post = _vector(d, device)
            self.attn = L.Attention(cfg, device=device)
            self.mlp = L.MLP(cfg, device=device)
        if cfg.family in ("ssm", "hybrid"):
            self.ssm = L.MambaMixer(cfg, device=device)


class LM(nn.Module):
    """A decoder-only LM: the token embedding, the layers, the final norm
    and, when the config does not tie it, ``lm_head [d, Vp]``; float32 as
    the config's ``param_dtype``.  Built empty; :func:`init_params` or
    :func:`repro_torch.models.weights.params_from_reference` fill it."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        Vp = vocab_padded(cfg)
        self.embed = nn.Parameter(torch.empty(Vp, cfg.d_model, device=device),
                                  requires_grad=False)
        self.final_norm = _vector(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty(cfg.d_model, Vp, device=device),
                requires_grad=False)
        self.layers = nn.ModuleList(
            Layer(cfg, device=device) for _ in range(cfg.n_layers))


MambaLM = LM   # the ssm-only model's earlier name


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_params(cfg: ModelConfig, *, generator=None, device="cuda") -> LM:
    """Random weights with the reference's shapes, scales and constants:
    normal(0, 0.02) matrices (conv 0.1; ``wo``, ``w2`` and ``out_proj``
    0.02/sqrt(2L)), ``A_log = log(1..state)``, ``dt_bias = -4.6``
    (softplus^-1(0.01)), ``D = 1``, ``conv_b = 0``, norms 1.  The draws come
    from ``generator`` (a ``torch.Generator`` on ``device``); on
    ``device="meta"`` only the shapes exist and no generator is needed."""
    model = LM(cfg, device=device)
    if torch.device(device).type != "meta" and generator is None:
        raise ValueError("init_params needs an explicit torch.Generator")
    out_scale = 0.02 / np.sqrt(2 * cfg.n_layers)

    def normal(t, scale=0.02):
        t.normal_(0.0, scale, generator=generator)

    normal(model.embed)
    model.final_norm.fill_(1.0)
    if not cfg.tie_embeddings:
        normal(model.lm_head)
    if cfg.family in ("ssm", "hybrid"):
        a_log = torch.log(torch.arange(1, cfg.ssm_state + 1,
                                       dtype=torch.float32, device=device))
    for layer in model.layers:
        for name, w in layer.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.startswith(("ln", "attn.q_norm", "attn.k_norm")):
                w.fill_(1.0)
            elif leaf in ("wo", "w2", "out_proj"):
                normal(w, out_scale)
            elif leaf == "conv_w":
                normal(w, 0.1)
            elif leaf == "conv_b":
                w.zero_()
            elif leaf == "dt_bias":
                w.fill_(-4.6)
            elif leaf == "A_log":
                w.copy_(a_log.expand(cfg.d_inner, cfg.ssm_state))
            elif leaf == "D":
                w.fill_(1.0)
            else:
                normal(w)
    return model


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def cast_for_compute(model: LM, cfg: ModelConfig, device=None) -> LM:
    """An :class:`LM` whose weights are cast once, on ``device``, to the
    dtype each of their uses casts them to; casting at each use gives the
    same bits.  Weights already of that dtype and device are shared, not
    copied; ``model`` is left as it is."""
    cd = _cdtype(cfg)
    state = {}
    for name, w in model.state_dict().items():
        dtype = cd if name.rsplit(".", 1)[-1] in _COMPUTE_CAST else w.dtype
        state[name] = w.detach().to(device=device or w.device, dtype=dtype)
    view = LM(cfg, device="meta")
    view.load_state_dict(state, assign=True)
    return view


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def embed_tokens(model: LM, cfg: ModelConfig, tokens):
    # gather, then cast: the same bits as the reference's cast, then gather
    x = model.embed[tokens].to(_cdtype(cfg))
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def init_cache(cfg: ModelConfig, B: int, cache_len: int, *,
               device="cuda") -> list:
    """Per-layer cache list: the SSM state ``h`` and conv window (``ssm``,
    ``hybrid``), and ``k``, ``v`` [B, C, KV, hd] with their absolute
    positions ``pos`` [B, C] (-1 = empty) for attention, where a windowed
    layer holds ``C = min(cache_len, window)``."""
    _require_ported(cfg)
    dt = _cdtype(cfg)
    KV, hd = cfg.n_kv_heads, cfg.hd
    caches = []
    for kind in _kinds(cfg):
        c = {}
        if cfg.family in ("ssm", "hybrid"):
            c["h"] = torch.zeros((B, cfg.d_inner, cfg.ssm_state),
                                 dtype=torch.float32, device=device)
            c["conv"] = torch.zeros((B, cfg.ssm_conv - 1, cfg.d_inner),
                                    dtype=dt, device=device)
        if cfg.family != "ssm":
            C = cache_len
            if kind == 1 and cfg.window:
                C = min(cache_len, cfg.window)
            c["k"] = torch.zeros((B, C, KV, hd), dtype=dt, device=device)
            c["v"] = torch.zeros((B, C, KV, hd), dtype=dt, device=device)
            c["pos"] = torch.full((B, C), -1, dtype=torch.int32,
                                  device=device)
        caches.append(c)
    return caches


def _norm(x, w, cfg: ModelConfig, post: bool = False):
    return L.rmsnorm(x, w, cfg.norm_eps, plus_one=post or cfg.sandwich_norm)


def _logits(model: LM, cfg: ModelConfig, x):
    """Final norm and the LM head on ``x [B, d]``: ``[B, Vp]`` f32."""
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    W = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = (x @ W.to(x.dtype)).float()
    return L.softcap(logits, cfg.logit_softcap)


def _mlp_branch(layer: Layer, cfg: ModelConfig, x, o):
    """The attention branch's output ``o`` added, then the MLP's."""
    if cfg.sandwich_norm:
        o = _norm(o, layer.ln1_post, cfg, post=True)
    x = x + o
    o = layer.mlp(_norm(x, layer.ln2, cfg))
    if cfg.sandwich_norm:
        o = _norm(o, layer.ln2_post, cfg, post=True)
    return x + o


@torch.no_grad()
def decode_step(model: LM, cfg: ModelConfig, caches, token, pos: int):
    """One-token decode.  token [B,1] int; ``pos`` the token's position (an
    SSM layer does not read it).  K/V caches are written in place.
    Returns (logits [B, vocab_padded], new_caches)."""
    _require_ported(cfg)
    x = embed_tokens(model, cfg, token)
    new_caches = []
    for layer, kind, c in zip(model.layers, _kinds(cfg), caches):
        c = dict(c)
        h = _norm(x, layer.ln1, cfg)
        if cfg.family in ("ssm", "hybrid"):
            s, c["h"], c["conv"] = layer.ssm(h, h0=c["h"], conv_buf=c["conv"],
                                             decode=True)
        if cfg.family == "ssm":
            x = x + s
        else:
            o, c["k"], c["v"], c["pos"] = L.attention_decode(
                h, layer.attn.weights(), cfg, kind, c["k"], c["v"], c["pos"],
                pos)
            if cfg.family == "hybrid":
                o = 0.5 * (o + s)
            x = _mlp_branch(layer, cfg, x, o)
        new_caches.append(c)
    return _logits(model, cfg, x[:, 0, :]), new_caches


def _ssm_prefill(mixer: L.MambaMixer, cfg: ModelConfig, h):
    """The Mamba branch over the whole prompt: (output, final state, the
    last ``k - 1`` pre-conv inputs)."""
    p = mixer.weights()
    B, S, _ = h.shape
    di, k = cfg.d_inner, cfg.ssm_conv
    xz = h @ p["in_proj"].to(h.dtype)
    x1 = xz[..., :di]
    conv_in = torch.nn.functional.silu(
        L._causal_conv(x1, p["conv_w"], p["conv_b"], k))
    dt, Bm, Cm, A, D = L._ssm_inputs(conv_in, p, cfg)
    y, hfin = L.mamba_scan(
        conv_in, dt, Bm, Cm, A, D,
        torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32,
                    device=h.device), cfg.ssm_chunk)
    y = y.to(h.dtype) * torch.nn.functional.silu(xz[..., di:])
    # a copy: a view would keep the layer's whole xz alive
    return y @ p["out_proj"].to(h.dtype), hfin, x1[:, S - (k - 1):].clone()


@torch.no_grad()
def prefill(model: LM, cfg: ModelConfig, tokens, cache_len: int):
    """Run the full-sequence layers over ``tokens [B, S]`` and fill the
    caches: each SSM layer's final state and last ``k - 1`` pre-conv inputs;
    each attention layer's K/V of the last ``min(C, S)`` positions, position
    ``p`` at slot ``p % C``.  Returns (last-position logits [B,
    vocab_padded], caches)."""
    _require_ported(cfg)
    B, S = tokens.shape
    caches = init_cache(cfg, B, cache_len, device=tokens.device)
    x = embed_tokens(model, cfg, tokens)
    pos = torch.arange(S, device=tokens.device)
    for layer, kind, c in zip(model.layers, _kinds(cfg), caches):
        h = _norm(x, layer.ln1, cfg)
        if cfg.family in ("ssm", "hybrid"):
            s, c["h"], c["conv"] = _ssm_prefill(layer.ssm, cfg, h)
        if cfg.family == "ssm":
            x = x + s
            continue
        p = layer.attn.weights()
        q, kk, vv = L._qkv(h, p, cfg)
        q = L.rope(q, pos, cfg.rope_theta)
        kk = L.rope(kk, pos, cfg.rope_theta)
        o = L.blockwise_attention(q, kk, vv, pos, pos, cfg, kind)
        o = o @ p["wo"].to(x.dtype)
        C = c["k"].shape[1]
        keep = pos[S - min(C, S):]
        c["k"][:, keep % C] = kk[:, keep]
        c["v"][:, keep % C] = vv[:, keep]
        c["pos"][:, keep % C] = keep.to(torch.int32)
        if cfg.family == "hybrid":
            o = 0.5 * (o + s)
        x = _mlp_branch(layer, cfg, x, o)
    return _logits(model, cfg, x[:, -1, :]), caches
