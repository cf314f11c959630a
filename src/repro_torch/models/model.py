"""Model assembly of the port for the ``ssm`` family: init, prefill, decode.

The port of ``repro.models.model`` for pure-Mamba models
(falcon-mamba-7b).  The reference stacks per-layer leaves ``[L, ...]`` for
``lax.scan``; here the model is an ``nn.Module`` (:class:`MambaLM`) with one
:class:`MambaLayer` per layer in an ``nn.ModuleList``, and the layer loop is
a Python loop.  The functions keep the reference's signatures with the
model in place of the param pytree.

Every other family raises ``NotImplementedError`` (ROADMAP queue 1, item
10), and so does training (``forward_hidden``, ``loss_fn``,
``chunked_ce_loss`` are not ported yet).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

# weights that every use casts to the compute dtype (``.to(x.dtype)`` in
# layers.py and here); A_log, D and the norms are used in float32
_COMPUTE_CAST = ("embed", "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                 "dt_bias", "out_proj")


def vocab_padded(cfg: ModelConfig) -> int:
    return int(np.ceil(cfg.vocab / 512)) * 512


def _require_ssm(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP queue 1, item 10); the port serves 'ssm' models")


def _cdtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class MambaLayer(nn.Module):
    """One residual block: ``x + mamba(rmsnorm(x, ln1))``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = nn.Parameter(torch.empty(cfg.d_model, device=device),
                                requires_grad=False)
        self.ssm = L.MambaMixer(cfg, device=device)


class MambaLM(nn.Module):
    """A pure-Mamba LM: the token embedding (tied LM head), the layers and
    the final norm, float32 as the config's ``param_dtype``.  Built empty;
    :func:`init_params` or
    :func:`repro_torch.models.weights.params_from_reference` fill it."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _require_ssm(cfg)
        if not cfg.tie_embeddings:
            raise NotImplementedError(f"{cfg.name}: an untied LM head is not "
                                      f"ported yet (ROADMAP queue 1, item 10)")
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.empty(vocab_padded(cfg), cfg.d_model, device=device),
            requires_grad=False)
        self.final_norm = nn.Parameter(torch.empty(cfg.d_model, device=device),
                                       requires_grad=False)
        self.layers = nn.ModuleList(
            MambaLayer(cfg, device=device) for _ in range(cfg.n_layers))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_params(cfg: ModelConfig, *, generator=None,
                device="cuda") -> MambaLM:
    """Random weights with the reference's shapes, scales and constants:
    normal(0, 0.02) matrices (conv 0.1, ``out_proj`` 0.02/sqrt(2L)),
    ``A_log = log(1..state)``, ``dt_bias = -4.6`` (softplus^-1(0.01)),
    ``D = 1``, ``conv_b = 0``, norms 1.  The draws come from ``generator``
    (a ``torch.Generator`` on ``device``); on ``device="meta"`` only the
    shapes exist and no generator is needed."""
    model = MambaLM(cfg, device=device)
    if torch.device(device).type != "meta" and generator is None:
        raise ValueError("init_params needs an explicit torch.Generator")
    out_scale = 0.02 / np.sqrt(2 * cfg.n_layers)
    st = cfg.ssm_state

    def normal(t, scale=0.02):
        t.normal_(0.0, scale, generator=generator)

    normal(model.embed)
    model.final_norm.fill_(1.0)
    a_log = torch.log(torch.arange(1, st + 1, dtype=torch.float32,
                                   device=device))
    for layer in model.layers:
        p = layer.ssm
        layer.ln1.fill_(1.0)
        normal(p.in_proj)
        normal(p.conv_w, 0.1)
        p.conv_b.zero_()
        normal(p.x_proj)
        normal(p.dt_proj)
        p.dt_bias.fill_(-4.6)
        p.A_log.copy_(a_log.expand(cfg.d_inner, st))
        p.D.fill_(1.0)
        normal(p.out_proj, out_scale)
    return model


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def cast_for_compute(model: MambaLM, cfg: ModelConfig, device=None) -> MambaLM:
    """A :class:`MambaLM` whose weights are cast once, on ``device``, to the
    dtype each of their uses casts them to; casting at each use gives the
    same bits.  Weights already of that dtype and device are shared, not
    copied; ``model`` is left as it is."""
    cd = _cdtype(cfg)
    state = {}
    for name, w in model.state_dict().items():
        dtype = cd if name.rsplit(".", 1)[-1] in _COMPUTE_CAST else w.dtype
        state[name] = w.detach().to(device=device or w.device, dtype=dtype)
    view = MambaLM(cfg, device="meta")
    view.load_state_dict(state, assign=True)
    return view


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def embed_tokens(model: MambaLM, cfg: ModelConfig, tokens):
    # gather, then cast: the same bits as the reference's cast, then gather
    x = model.embed[tokens].to(_cdtype(cfg))
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def init_cache(cfg: ModelConfig, B: int, cache_len: int, *,
               device="cuda") -> list:
    """Per-layer cache list: the SSM state ``h`` and the conv window
    (``cache_len`` bounds no SSM cache; the reference's signature)."""
    _require_ssm(cfg)
    dt = _cdtype(cfg)
    return [{"h": torch.zeros((B, cfg.d_inner, cfg.ssm_state),
                              dtype=torch.float32, device=device),
             "conv": torch.zeros((B, cfg.ssm_conv - 1, cfg.d_inner),
                                 dtype=dt, device=device)}
            for _ in range(cfg.n_layers)]


def _logits(model: MambaLM, cfg: ModelConfig, x):
    """Final norm and the tied LM head on ``x [B, d]``: ``[B, Vp]`` f32."""
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = (x @ model.embed.T.to(x.dtype)).float()
    return L.softcap(logits, cfg.logit_softcap)


@torch.no_grad()
def decode_step(model: MambaLM, cfg: ModelConfig, caches, token, pos):
    """One-token decode.  token [B,1] int; ``pos`` is not read by an SSM
    layer.  Returns (logits [B, vocab_padded], new_caches)."""
    _require_ssm(cfg)
    x = embed_tokens(model, cfg, token)
    new_caches = []
    for layer, c in zip(model.layers, caches):
        h = L.rmsnorm(x, layer.ln1, cfg.norm_eps)
        o, hs, conv = layer.ssm(h, h0=c["h"], conv_buf=c["conv"],
                                decode=True)
        x = x + o
        new_caches.append({"h": hs, "conv": conv})
    return _logits(model, cfg, x[:, 0, :]), new_caches


@torch.no_grad()
def prefill(model: MambaLM, cfg: ModelConfig, tokens, cache_len: int):
    """Run the full-sequence layers over ``tokens [B, S]`` and fill the
    caches (each layer's final SSM state and its last ``k - 1`` pre-conv
    inputs).  Returns (last-position logits [B, vocab_padded], caches)."""
    _require_ssm(cfg)
    B, S = tokens.shape
    caches = init_cache(cfg, B, cache_len, device=tokens.device)
    x = embed_tokens(model, cfg, tokens)
    di, k = cfg.d_inner, cfg.ssm_conv
    for layer, c in zip(model.layers, caches):
        p = layer.ssm.weights()
        h = L.rmsnorm(x, layer.ln1, cfg.norm_eps)
        xz = h @ p["in_proj"].to(x.dtype)
        x1 = xz[..., :di]
        conv_in = torch.nn.functional.silu(
            L._causal_conv(x1, p["conv_w"], p["conv_b"], k))
        dt, Bm, Cm, A, D = L._ssm_inputs(conv_in, p, cfg)
        y, hfin = L.mamba_scan(
            conv_in, dt, Bm, Cm, A, D,
            torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32,
                        device=x.device), cfg.ssm_chunk)
        y = y.to(x.dtype) * torch.nn.functional.silu(xz[..., di:])
        x = x + y @ p["out_proj"].to(x.dtype)
        c["h"] = hfin
        # a copy: a view would keep the layer's whole xz alive
        c["conv"] = x1[:, S - (k - 1):, :].clone()
    return _logits(model, cfg, x[:, -1, :]), caches
