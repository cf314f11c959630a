"""The port's MoE, VLM and encoder-decoder families against the JAX
package, on the CPU: mixtral-8x22b and arctic-480b (``moe_ffn`` in both
dispatch forms, the routing integers bitwise; arctic's dense residual),
phi-3-vision-4.2b (the projected patch prefix) and seamless-m4t-medium
(the encoder, cross-attention and its ``ek``/``ev`` caches).

Weights are the reference's ``init_params`` from a seed, carried across by
``params_from_reference``; inputs come from numpy with a seed.  Float32
within rtol = atol = 1e-5, bfloat16 within 2e-2, as in
``tests/test_torch_lm_families.py``, whose helpers these tests share.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from test_torch_lm_families import (BF16, F32, FAMILIES, MOE,  # noqa: E402
                                    _cfg, _close, _close_caches, _jit_decode,
                                    _models, _requests)


@pytest.mark.parametrize("arch", MOE)
def test_moe_engine_greedy_ids_equal_reference_f32(arch):
    """Both engines on the same MoE weights, left-padded prompts of 16, 9
    and 3 tokens: the same greedy ids (decode routes the batch as one
    group in both)."""
    cfg, jp, model = _models(arch, "float32")
    te = tengine.Engine(cfg, model, batch=4, cache_len=32, device="cpu")
    je = jengine.Engine(cfg, jp, batch=4, cache_len=32)
    out_t = te.generate(_requests(cfg, tengine.Request))
    out_j = je.generate(_requests(cfg, jengine.Request))
    assert [o.tolist() for o in out_t] == [o.tolist() for o in out_j]


# -- MoE -----------------------------------------------------------------------

def _moe_inputs(arch, impl, case):
    """A reduced config (E = 4, k = 2, groups of 64 tokens), the
    reference's layer-0 MoE weights and x [2, 64, d] from a seed.
    ``drop``: capacity factor 0.5 (C = 16 of 128 slots an expert: tokens
    drop); ``ties``: the router's expert 1 a copy of expert 0, so their
    logits tie exactly on every token."""
    cfg = dataclasses.replace(_cfg(arch), moe_impl=impl)
    if case == "drop":
        cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    jp = jmodel.init_params(cfg, jax.random.key(0))
    p = {k: np.array(v[0]) for k, v in jp["layers"]["moe"].items()}
    if case == "ties":
        p["router"][:, 1] = p["router"][:, 0]
    x = np.random.default_rng(11).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    return cfg, p, x


def _reference_routing(gate_i, E, C):
    """The reference's capacity positions and kept slots from its expert
    ids (``src/repro/models/layers.py:336-339``)."""
    ng, G, k = gate_i.shape
    af = np.eye(E, dtype=np.int32)[gate_i].reshape(ng, G * k, E)
    pos = np.cumsum(af, axis=1) - af
    return pos, (pos < C) & (af > 0)


@pytest.mark.parametrize("case", ["free", "drop", "ties"])
@pytest.mark.parametrize("impl", ["onehot", "gather"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_routing_and_output_match_reference(monkeypatch, arch, impl,
                                                    case):
    """``gate_i``, ``pos`` and ``keep`` bit-identical to the reference's
    (the reference's top-k read as it runs); ``y`` and ``aux_loss``
    within float32 rtol = atol = 1e-5."""
    cfg, p, x = _moe_inputs(arch, impl, case)
    seen = {}
    top_k = jax.lax.top_k

    def recording(logits, k):
        out = top_k(logits, k)
        seen.update(logits=np.asarray(logits), w=np.asarray(out[0]),
                    i=np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording)
    ref = jlayers.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p), cfg)
    E, k, G = cfg.n_experts, cfg.top_k, cfg.moe_group
    C = int(np.ceil(G * k * cfg.capacity_factor / E))
    pos, keep = _reference_routing(seen["i"], E, C)

    # the port's routing on the reference's logits
    r = tlayers.moe_route(torch.tensor(seen["logits"]), cfg)
    assert r.C == C
    np.testing.assert_array_equal(r.gate_i.numpy(), seen["i"])
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_allclose(r.gate_w.numpy(),
                               np.asarray(jax.nn.softmax(seen["w"])), **F32)

    # the port's own moe_ffn, its routing read as it runs
    routes = []
    route = tlayers.moe_route
    monkeypatch.setattr(tlayers, "moe_route",
                        lambda lg, c: routes.append(route(lg, c))
                        or routes[-1])
    out = tlayers.moe_ffn(torch.as_tensor(x),
                          {n: torch.as_tensor(v) for n, v in p.items()}, cfg)
    np.testing.assert_array_equal(routes[0].gate_i.numpy(), seen["i"])
    np.testing.assert_array_equal(routes[0].keep.numpy(), keep)
    _close(out.y, ref.y, F32)
    _close(out.aux_loss, ref.aux_loss, F32)
    n_kept = int(keep.sum())
    if case == "drop":
        assert n_kept < x.shape[0] * x.shape[1] * k
    if case == "ties":
        logits = seen["logits"]
        assert np.array_equal(logits[..., 0], logits[..., 1])
        both = (seen["i"] == 0).any(-1) & (seen["i"] == 1).any(-1)
        assert both.any()
        # equal values: the lower index first
        assert (seen["i"][both] == [0, 1]).all()


# -- the other families, prefill and decode ------------------------------------

def _family_inputs(cfg, rng, B=2, S=16):
    """Token ids, and a VLM's patch prefix or an encoder-decoder's source
    frames (8 of them), from ``rng``."""
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    front = src = None
    if cfg.frontend and not cfg.enc_layers:
        front = rng.standard_normal(
            (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    if cfg.enc_layers:
        src = rng.standard_normal((B, 8, cfg.frontend_dim)).astype(
            np.float32)
    return toks, front, src


def _opt(x, to):
    return None if x is None else to(x)


@pytest.mark.parametrize("arch,dtype,impl", [
    (a, "float32", "onehot") for a in FAMILIES] + [
    ("mixtral-8x22b", "float32", "gather"),
    ("phi-3-vision-4.2b", "bfloat16", "onehot"),
    ("seamless-m4t-medium", "bfloat16", "onehot")])
def test_family_prefill_and_decode_match_reference(arch, dtype, impl):
    """Prefill (with the VLM's 4-patch prefix or the encoder-decoder's 8
    source frames) and two decode steps of the reference's jitted
    ``decode_step``, weights through ``params_from_reference``: logits and
    every cache leaf (``ek``/``ev`` too) within the dtype's tolerance.
    The MoE models are held in float32 only: in bf16 the router's logits
    round to near-ties that the two packages' products break otherwise."""
    cfg, jp, model = _models(arch, dtype)
    if impl != cfg.moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=impl)
        model = tmodel.cast_for_compute(model, cfg)
    tol = F32 if dtype == "float32" else BF16
    rng = np.random.default_rng(5)
    toks, front, src = _family_inputs(cfg, rng)
    lj, cj = jmodel.prefill(jp, cfg, jnp.asarray(toks), 32,
                            frontend=_opt(front, jnp.asarray),
                            src=_opt(src, jnp.asarray))
    lt, ct = tmodel.prefill(model, cfg, torch.as_tensor(toks), 32,
                            frontend=_opt(front, torch.as_tensor),
                            src=_opt(src, torch.as_tensor))
    _close(lt, lj, tol)
    _close_caches(ct, cj, tol)
    if cfg.enc_layers:
        assert ct[0]["ek"].shape == (2, 8, cfg.n_kv_heads, cfg.hd)
    start = toks.shape[1] + (cfg.frontend_len if front is not None else 0)
    dec = _jit_decode(cfg)
    for step in range(2):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        lj, cj = dec(jp, cj, jnp.asarray(tok), jnp.int32(start + step))
        lt, ct = tmodel.decode_step(model, cfg, ct, torch.as_tensor(tok),
                                    start + step)
        _close(lt, lj, tol)
        _close_caches(ct, cj, tol)


def test_vlm_prefix_shifts_the_text_positions():
    """The patch prefix takes positions 0..P-1 of every cache; the text
    follows at P.  Without a prefix the model reads the text alone."""
    cfg, jp, model = _models("phi-3-vision-4.2b", "float32")
    toks, front, _ = _family_inputs(cfg, np.random.default_rng(7), S=8)
    _, ct = tmodel.prefill(model, cfg, torch.as_tensor(toks), 16,
                           frontend=torch.as_tensor(front))
    P = cfg.frontend_len
    assert ct[0]["pos"][0, :P + 8].tolist() == list(range(P + 8))
    plain, _ = tmodel.prefill(model, cfg, torch.as_tensor(toks), 16)
    want, _ = jmodel.prefill(jp, cfg, jnp.asarray(toks), 16)
    _close(plain, want, F32)
