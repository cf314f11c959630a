"""Model assembly of the port: init, the training forward and loss,
prefill, decode.

The port of ``repro.models.model`` for serving and training every
family: ``ssm``
(falcon-mamba-7b), ``hybrid`` (hymba-1.5b), ``dense`` (qwen3-4b,
gemma2-2b, phi3-medium-14b, starcoder2-15b), ``moe`` (mixtral-8x22b,
arctic-480b with its dense residual), ``vlm`` (phi-3-vision-4.2b: a
projected patch prefix before the text) and ``encdec``
(seamless-m4t-medium: an encoder stack, cross-attention and its
``ek``/``ev`` caches), tied or untied head.  The reference stacks
per-layer leaves ``[L, ...]`` for ``lax.scan``; here the model is an
``nn.Module`` (:class:`LM`) with one :class:`Layer` per layer in an
``nn.ModuleList`` (and the encoder's in another), and the layer loop is a
Python loop.  The functions keep the reference's signatures with the
model in place of the param pytree.

One deliberate parting: :func:`prefill` writes position ``p`` of a layer's
K/V at cache slot ``p % C``, the slot :func:`~repro_torch.models.layers.
attention_decode` reads and overwrites.  The reference writes the last
``C`` positions at slots ``0..C-1``, which agrees only when ``S <= C`` or
``C`` divides ``S``; at other lengths its first decode steps overwrite
positions still inside a window (ROADMAP queue 3).

Training: :func:`forward_hidden` (the backbone over a batch: a VLM's
patch prefix masked out of the loss, an encoder-decoder's ``src`` through
:func:`encode`, the MoE aux loss summed over layers),
:func:`chunked_ce_loss` (4096-token chunks, the padded vocabulary masked)
and :func:`loss_fn`.  With ``remat`` every layer runs under
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint``: only each layer's input is kept, and the
layer is run again in the backward; every CE chunk runs so always, as
the reference's do.  The parameters are built with
``requires_grad=False`` (serving needs no graph); a trainer turns
gradients on.  One parting in bf16 compute: the reference casts every
per-layer leaf to the compute dtype before its layer scan, norms,
``A_log`` and ``D`` included; the port keeps those in float32, as its
serving path does (float32 compute, where the parity tests run, is the
same).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

PORTED_FAMILIES = ("ssm", "hybrid", "dense", "moe", "vlm", "encdec")

# weights that every use casts to the compute dtype (``.to(x.dtype)`` in
# layers.py and here); A_log, D and the norms (q_norm, k_norm too) are used
# in float32
_COMPUTE_CAST = ("embed", "lm_head", "in_proj", "conv_w", "conv_b", "x_proj",
                 "dt_proj", "dt_bias", "out_proj", "wq", "wk", "wv", "wo",
                 "w1", "w2", "w3", "router", "frontend_proj")


def vocab_padded(cfg: ModelConfig) -> int:
    return int(np.ceil(cfg.vocab / 512)) * 512


def _cdtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _kinds(cfg: ModelConfig):
    return cfg.layer_kinds() if cfg.family != "ssm" else (0,) * cfg.n_layers


def _vector(d: int, device):
    return nn.Parameter(torch.empty(d, device=device), requires_grad=False)


class Layer(nn.Module):
    """One residual block.  ``ssm``: ``x + mamba(rmsnorm(x, ln1))``.  Else
    ``x + attn`` (hybrid: ``0.5 * (attn + mamba)`` on the same normed
    input), then in a decoder of an encoder-decoder ``x +
    xattn(rmsnorm(x, ln_x))``, then ``x + ffn(rmsnorm(x, ln2))``: the MLP,
    or the MoE (with ``dense_residual`` plus the MLP); with sandwich norms
    each branch's output is normed again (``ln1_post``, ``ln2_post``).
    ``decoder=False`` is an encoder layer of the same config."""

    def __init__(self, cfg: ModelConfig, device=None, decoder: bool = True):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _vector(d, device)
        if cfg.family != "ssm":
            self.ln2 = _vector(d, device)
            if cfg.sandwich_norm:
                self.ln1_post = _vector(d, device)
                self.ln2_post = _vector(d, device)
            self.attn = L.Attention(cfg, device=device)
            if cfg.family == "moe":
                self.moe = L.MoE(cfg, device=device)
            if cfg.family != "moe" or cfg.dense_residual:
                self.mlp = L.MLP(cfg, device=device)
        if cfg.family in ("ssm", "hybrid"):
            self.ssm = L.MambaMixer(cfg, device=device)
        if decoder and cfg.enc_layers:
            self.xattn = L.Attention(cfg, device=device)
            self.ln_x = _vector(d, device)


class LM(nn.Module):
    """An LM: the token embedding, the layers, the final norm and, when the
    config does not tie it, ``lm_head [d, Vp]``; with encoder layers the
    ``encoder`` stack and ``enc_norm``; with a frontend ``frontend_proj
    [frontend_dim, d]``.  float32 as the config's ``param_dtype``.  Built
    empty; :func:`init_params` or
    :func:`repro_torch.models.weights.params_from_reference` fill it."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"{cfg.name}: no such family {cfg.family!r}")
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
        if cfg.enc_layers:
            self.encoder = nn.ModuleList(
                Layer(cfg, device=device, decoder=False)
                for _ in range(cfg.enc_layers))
            self.enc_norm = _vector(cfg.d_model, device)
        if cfg.frontend:
            self.frontend_proj = nn.Parameter(
                torch.empty(cfg.frontend_dim, cfg.d_model, device=device),
                requires_grad=False)


MambaLM = LM   # the ssm-only model's earlier name


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_params(cfg: ModelConfig, *, generator=None, device="cuda") -> LM:
    """Random weights with the reference's shapes, scales and constants:
    normal(0, 0.02) matrices, the router and the frontend projection too
    (conv 0.1; ``wo``, ``w2`` and ``out_proj`` 0.02/sqrt(2L), the experts'
    ``w2`` and the encoder's too), ``A_log = log(1..state)``, ``dt_bias = -4.6``
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
    if cfg.enc_layers:
        model.enc_norm.fill_(1.0)
    if cfg.frontend:
        normal(model.frontend_proj)
    if cfg.family in ("ssm", "hybrid"):
        a_log = torch.log(torch.arange(1, cfg.ssm_state + 1,
                                       dtype=torch.float32, device=device))
    layers = list(model.layers) + list(getattr(model, "encoder", ()))
    for layer in layers:
        for name, w in layer.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.startswith(("ln", "attn.q_norm", "attn.k_norm",
                                "xattn.q_norm", "xattn.k_norm")):
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
               src_len: int = 0, device="cuda") -> list:
    """Per-layer cache list: the SSM state ``h`` and conv window (``ssm``,
    ``hybrid``), and ``k``, ``v`` [B, C, KV, hd] with their absolute
    positions ``pos`` [B, C] (-1 = empty) for attention, where a windowed
    layer holds ``C = min(cache_len, window)``; with encoder layers the
    cross-attention's ``ek``, ``ev`` [B, src_len, KV, hd]."""
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
        if cfg.enc_layers:
            c["ek"] = torch.zeros((B, src_len, KV, hd), dtype=dt,
                                  device=device)
            c["ev"] = torch.zeros((B, src_len, KV, hd), dtype=dt,
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


def _ffn(layer: Layer, cfg: ModelConfig, h):
    """The feed-forward branch on the normed ``h``: the MLP, or the MoE
    (plus the MLP with ``dense_residual``).  Returns (output, the MoE's
    aux loss or None); serving drops the aux loss."""
    if cfg.family != "moe":
        return layer.mlp(h), None
    mo = layer.moe(h)
    o = mo.y + layer.mlp(h) if cfg.dense_residual else mo.y
    return o, mo.aux_loss


def _enc_kv(layer: Layer, cfg: ModelConfig, enc_out):
    """A decoder layer's cross-attention ``ek``, ``ev`` [B, Ss, KV, hd]
    from the encoder's output."""
    xp = layer.xattn.weights()
    d, KV, hd = cfg.d_model, cfg.n_kv_heads, cfg.hd
    shape = enc_out.shape[:2] + (KV, hd)
    return tuple((enc_out @ xp[w].to(enc_out.dtype).reshape(d, KV * hd))
                 .view(shape) for w in ("wk", "wv"))


def _rest_of_layer(layer: Layer, cfg: ModelConfig, x, o, enc_kv=None):
    """The attention branch's output ``o`` added, then the cross-attention
    on ``enc_kv = (ek, ev)`` (a decoder of an encoder-decoder), then the
    feed-forward branch's.  Returns (x, the MoE's aux loss or None)."""
    if cfg.sandwich_norm:
        o = _norm(o, layer.ln1_post, cfg, post=True)
    x = x + o
    if enc_kv is not None:
        hx = L.rmsnorm(x, layer.ln_x, cfg.norm_eps)
        x = x + L.cross_attention(hx, layer.xattn.weights(), cfg, *enc_kv)
    o, aux = _ffn(layer, cfg, _norm(x, layer.ln2, cfg))
    if cfg.sandwich_norm:
        o = _norm(o, layer.ln2_post, cfg, post=True)
    return x + o, aux


@torch.no_grad()
def decode_step(model: LM, cfg: ModelConfig, caches, token, pos: int):
    """One-token decode.  token [B,1] int; ``pos`` the token's position
    (after a VLM's patch prefix, counting it; an SSM layer does not read
    it).  K/V caches are written in place.  Returns (logits [B,
    vocab_padded], new_caches).  An MoE layer routes the batch's B tokens
    as one group."""
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
            x, _ = _rest_of_layer(
                layer, cfg, x, o,
                (c["ek"], c["ev"]) if cfg.enc_layers else None)
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


def _encoder_layer(layer: Layer, cfg: ModelConfig, x):
    h = L.rmsnorm(x, layer.ln1, cfg.norm_eps)
    x = x + L.encoder_attention(h, layer.attn.weights(), cfg)
    h = L.rmsnorm(x, layer.ln2, cfg.norm_eps)
    return x + layer.mlp(h)


def encode(model: LM, cfg: ModelConfig, src, remat: bool = False):
    """The encoder stack over the source frames ``src [B, Ss,
    frontend_dim]`` (projected by ``frontend_proj`` where the model has
    one), then ``enc_norm``: ``[B, Ss, d]`` in the compute dtype.  With
    ``remat`` each layer runs under ``checkpoint``."""
    x = src.to(_cdtype(cfg))
    if cfg.frontend:
        x = x @ model.frontend_proj.to(x.dtype)
    for layer in model.encoder:
        fn = functools.partial(_encoder_layer, layer, cfg)
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    return L.rmsnorm(x, model.enc_norm, cfg.norm_eps)


@torch.no_grad()
def prefill(model: LM, cfg: ModelConfig, tokens, cache_len: int,
            frontend=None, src=None):
    """Run the full-sequence layers over ``tokens [B, S]`` and fill the
    caches: each SSM layer's final state and last ``k - 1`` pre-conv inputs;
    each attention layer's K/V of the last ``min(C, S_all)`` positions,
    position ``p`` at slot ``p % C``.  A VLM's ``frontend [B, P,
    frontend_dim]`` is projected and put before the text, so the sequence
    is ``S_all = P + S`` long and decoding goes on at position ``S_all``;
    an encoder-decoder's ``src`` goes through :func:`encode`, and each
    decoder layer's ``ek``/``ev`` are computed once from its output.
    Returns (last-position logits [B, vocab_padded], caches)."""
    B, S = tokens.shape
    caches = init_cache(cfg, B, cache_len,
                        src_len=src.shape[1] if src is not None else 0,
                        device=tokens.device)
    x = embed_tokens(model, cfg, tokens)
    if cfg.frontend and frontend is not None:
        fx = frontend.to(x.dtype) @ model.frontend_proj.to(x.dtype)
        x = torch.cat([fx, x], dim=1)
    enc_out = None
    if cfg.enc_layers and src is not None:
        enc_out = encode(model, cfg, src)
    S_all = x.shape[1]
    pos = torch.arange(S_all, device=tokens.device)
    for layer, kind, c in zip(model.layers, _kinds(cfg), caches):
        h = _norm(x, layer.ln1, cfg)
        if cfg.family in ("ssm", "hybrid"):
            s, c["h"], c["conv"] = _ssm_prefill(layer.ssm, cfg, h)
        if cfg.family == "ssm":
            x = x + s
            continue
        o, (kk, vv) = L.attention_train(h, layer.attn.weights(), cfg, kind,
                                        positions=pos, return_kv=True)
        C = c["k"].shape[1]
        keep = pos[S_all - min(C, S_all):]
        c["k"][:, keep % C] = kk[:, keep]
        c["v"][:, keep % C] = vv[:, keep]
        c["pos"][:, keep % C] = keep.to(torch.int32)
        if cfg.family == "hybrid":
            o = 0.5 * (o + s)
        enc_kv = None
        if enc_out is not None:
            c["ek"], c["ev"] = enc_kv = _enc_kv(layer, cfg, enc_out)
        x, _ = _rest_of_layer(layer, cfg, x, o, enc_kv)
    return _logits(model, cfg, x[:, -1, :]), caches


# ---------------------------------------------------------------------------
# training: forward, chunked loss
# ---------------------------------------------------------------------------

def _train_layer(layer: Layer, cfg: ModelConfig, kind: int, x, enc_out):
    """One layer of the training forward over the whole sequence: the
    block of :class:`Layer` on ``x [B, S, d]``, with ``enc_out`` the
    encoder's output for an encoder-decoder's decoder (else None).
    Returns (x, aux loss): the MoE's, zero elsewhere."""
    h = _norm(x, layer.ln1, cfg)
    if cfg.family in ("ssm", "hybrid"):
        s, _, _ = layer.ssm(h)
    if cfg.family == "ssm":
        return x + s, x.new_zeros((), dtype=torch.float32)
    o = L.attention_train(h, layer.attn.weights(), cfg, kind)
    if cfg.family == "hybrid":
        o = 0.5 * (o + s)
    enc_kv = None if enc_out is None else _enc_kv(layer, cfg, enc_out)
    x, aux = _rest_of_layer(layer, cfg, x, o, enc_kv)
    return x, (x.new_zeros((), dtype=torch.float32) if aux is None
               else aux)


def forward_hidden(model: LM, cfg: ModelConfig, batch, remat: bool = True):
    """The backbone over ``batch`` (tensors on the model's device):
    ``tokens [B, S]``; a VLM's ``frontend [B, P, frontend_dim]``, projected
    and put before the text; an encoder-decoder's ``src [B, Ss,
    frontend_dim]`` through :func:`encode`.  Returns (hidden [B, S_all,
    d] after the final norm, the MoE aux loss summed over layers,
    loss_mask [B, S_all]: False on a VLM's patch positions).  With
    ``remat`` each layer (and encoder layer) runs under ``checkpoint``."""
    tokens = batch["tokens"]
    x = embed_tokens(model, cfg, tokens)
    loss_mask = torch.ones(tokens.shape, dtype=torch.bool,
                           device=tokens.device)
    if cfg.frontend and cfg.enc_layers == 0:    # VLM: patch prefix
        fx = batch["frontend"].to(x.dtype) @ model.frontend_proj.to(x.dtype)
        x = torch.cat([fx, x], dim=1)
        loss_mask = torch.cat([torch.zeros(fx.shape[:2], dtype=torch.bool,
                                           device=tokens.device),
                               loss_mask], dim=1)
    enc_out = (encode(model, cfg, batch["src"], remat) if cfg.enc_layers
               else None)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer, kind in zip(model.layers, _kinds(cfg)):
        fn = functools.partial(_train_layer, layer, cfg, kind)
        x, a = (checkpoint(fn, x, enc_out, use_reentrant=False) if remat
                else fn(x, enc_out))
        aux = aux + a
    return L.rmsnorm(x, model.final_norm, cfg.norm_eps), aux, loss_mask


def _ce_chunk(cfg: ModelConfig, hs, ls, ms, W):
    """One chunk's summed negative log-likelihood and token count:
    ``hs [c, d]``, labels ``ls [c]``, mask ``ms [c]`` float, ``W [d, Vp]``
    in the compute dtype; the padded vocabulary's columns are masked."""
    logits = L.softcap((hs @ W).float(), cfg.logit_softcap)
    pad_col = torch.arange(W.shape[1], device=W.device) >= cfg.vocab
    logits = torch.where(pad_col[None, :], -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    # indexing, not gather: its backward adds with a deterministic kernel
    # under torch.use_deterministic_algorithms
    gold = logits[torch.arange(ls.shape[0], device=ls.device), ls.long()]
    return ((lse - gold) * ms).sum(), ms.sum()


def chunked_ce_loss(model: LM, cfg: ModelConfig, hidden, labels, loss_mask,
                    chunk: int = 4096):
    """Cross-entropy over the text positions (the last ``labels.shape[1]``
    of ``hidden``, behind any modality prefix) without the ``[B, S, V]``
    logits: ``chunk`` tokens at a time (``T % chunk == 0`` is asserted, as
    the reference does), each chunk under ``checkpoint`` (the reference's
    ``jax.checkpoint``, whatever its ``remat``): one chunk's logits live
    at a time.  The mean over the masked-in tokens."""
    W = (model.embed.T if cfg.tie_embeddings else model.lm_head
         ).to(_cdtype(cfg))
    B, S_all, d = hidden.shape
    S_txt = labels.shape[1]
    T = B * S_txt
    hf = hidden[:, S_all - S_txt:, :].reshape(T, d)
    lf = labels.reshape(T)
    mf = loss_mask[:, S_all - S_txt:].reshape(T).float()
    chunk = min(chunk, T)
    assert T % chunk == 0
    fn = functools.partial(_ce_chunk, cfg)
    loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, T, chunk):
        args = (hf[i:i + chunk], lf[i:i + chunk], mf[i:i + chunk], W)
        nll, n = checkpoint(fn, *args, use_reentrant=False)
        loss, cnt = loss + nll, cnt + n
    return loss / torch.clamp(cnt, min=1.0)


def loss_fn(model: LM, cfg: ModelConfig, batch, remat: bool = True,
            aux_weight: float = 0.01):
    """``(ce + aux_weight * aux, {"ce": ce, "aux": aux})`` over ``batch``
    (``tokens``, ``labels [B, S]``, and ``frontend`` or ``src`` where the
    family takes one)."""
    hidden, aux, loss_mask = forward_hidden(model, cfg, batch, remat)
    ce = chunked_ce_loss(model, cfg, hidden, batch["labels"], loss_mask)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}
