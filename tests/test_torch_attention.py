"""The port's attention stack and MLPs (``repro_torch.models.layers``)
against the JAX package's, on the CPU.

Inputs come from numpy with a seed and go through both packages.
Tolerances: float32 rtol 1e-5 and atol 1e-5 (the frameworks sum in other
orders); bfloat16 rtol 2e-2 and atol 2e-2 (the reference's compiled loops
keep bf16 intermediates in float32, eager PyTorch rounds each).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
_DT = {"float32": (torch.float32, jnp.float32, F32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _both(a, dtype):
    """One array in both frameworks, rounded to ``dtype`` alike."""
    tdt, jdt, _ = _DT[dtype]
    j = jnp.asarray(a, jdt)
    return torch.from_numpy(_np(j).copy()).to(tdt), j


def _cfg(**kw):
    base = jconfigs.reduced(jconfigs.get_config("gemma2-2b"))
    return dataclasses.replace(base, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(dtype, theta):
    rng = np.random.default_rng(1)
    xt, xj = _both(rng.standard_normal((2, 40, 3, 16)), dtype)
    tol = _DT[dtype][2]
    pos = np.arange(40) + 2000          # large angles
    out = tlayers.rope(xt, torch.as_tensor(pos), theta)
    assert out.dtype == xt.dtype
    np.testing.assert_allclose(_np(out), _np(jlayers.rope(
        xj, jnp.asarray(pos), theta)), **tol)
    # decode's [B, 1] positions
    posv = np.full((2, 1), 2047)
    out = tlayers.rope(xt[:, :1], torch.as_tensor(posv), theta)
    np.testing.assert_allclose(_np(out), _np(jlayers.rope(
        xj[:, :1], jnp.asarray(posv), theta)), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("kind", [0, 1, 2])
def test_blockwise_attention_matches_reference(kind, softcap, dtype):
    """GQA (4 heads on 2), several q and kv blocks; window 12 with kv
    blocks of 16, so late rows of kind 1 find their first kv block all
    masked (the exp(0) terms the next block's correction clears)."""
    cfg = _cfg(window=12, attn_softcap=softcap)
    rng = np.random.default_rng(kind)
    B, S, H, KV, hd = 2, 48, 4, 2, 16
    q = _both(rng.standard_normal((B, S, H, hd)), dtype)
    k = _both(rng.standard_normal((B, S, KV, hd)), dtype)
    v = _both(rng.standard_normal((B, S, KV, hd)), dtype)
    pos = np.arange(S)
    got = tlayers.blockwise_attention(
        q[0], k[0], v[0], torch.as_tensor(pos), torch.as_tensor(pos), cfg,
        kind, q_block=8, kv_block=16)
    want = jlayers.blockwise_attention(
        q[1], k[1], v[1], jnp.asarray(pos), jnp.asarray(pos), cfg, kind,
        q_block=8, kv_block=16)
    assert got.shape == (B, S, H * hd) and got.dtype == q[0].dtype
    np.testing.assert_allclose(_np(got), _np(want), **_DT[dtype][2])
    assert np.isfinite(_np(got)).all()
    with pytest.raises(AssertionError):   # the reference's block asserts
        tlayers.blockwise_attention(
            q[0][:, :44], k[0][:, :44], v[0][:, :44],
            torch.as_tensor(pos[:44]), torch.as_tensor(pos[:44]), cfg, kind,
            q_block=8, kv_block=16)


def _attn_weights(cfg, rng):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shapes = {"wq": (d, H, hd), "wk": (d, KV, hd), "wv": (d, KV, hd),
              "wo": (H * hd, d), "q_norm": (hd,), "k_norm": (hd,)}
    w = {n: (0.2 * rng.standard_normal(s)).astype(np.float32)
         for n, s in shapes.items()}
    w["q_norm"] += 1.0
    w["k_norm"] += 1.0
    return ({n: torch.from_numpy(a) for n, a in w.items()},
            {n: jnp.asarray(a) for n, a in w.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["half_empty", "wrapped_global",
                                  "wrapped_window"])
def test_attention_decode_matches_reference(case, dtype):
    """A buffer of 16 slots half filled (positions 0-7, new token at 8),
    and a rolling buffer of 8 slots that has wrapped (positions 12-19 in
    place, new token at 20 overwrites 12), as a global and a windowed
    (window 6) layer; qk-norm and the attention softcap on."""
    cfg = _cfg(window=6, qk_norm=True, attn_softcap=5.0)
    kind = 1 if case == "wrapped_window" else 0
    rng = np.random.default_rng(7)
    tw, jw = _attn_weights(cfg, rng)
    B, KV, hd = 2, cfg.n_kv_heads, cfg.hd
    C, filled, pos = (16, 8, 8) if case == "half_empty" else (8, 8, 20)
    ck = rng.standard_normal((B, C, KV, hd))
    cv = rng.standard_normal((B, C, KV, hd))
    cpos = np.full((B, C), -1, np.int32)
    for p in range(pos - filled, pos):
        cpos[:, p % C] = p
    x = _both(rng.standard_normal((B, 1, cfg.d_model)), dtype)
    k, v = _both(ck, dtype), _both(cv, dtype)
    got = tlayers.attention_decode(x[0], tw, cfg, kind, k[0].clone(),
                                   v[0].clone(), torch.as_tensor(cpos), pos)
    want = jlayers.attention_decode(x[1], jw, cfg, kind, k[1], v[1],
                                    jnp.asarray(cpos), jnp.int32(pos))
    tol = _DT[dtype][2]
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(_np(a), _np(b), **tol)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[3][0, pos % C]) == pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(mlp_type, dtype):
    cfg = _cfg(mlp_type=mlp_type)
    rng = np.random.default_rng(3)
    d, ff = cfg.d_model, cfg.d_ff
    w = {n: (0.1 * rng.standard_normal(s)).astype(np.float32)
         for n, s in (("w1", (d, ff)), ("w3", (d, ff)), ("w2", (ff, d)))}
    if mlp_type == "gelu":
        del w["w3"]
    x = _both(rng.standard_normal((2, 5, d)), dtype)   # unit RMS, as normed
    got = tlayers.mlp(x[0], {n: torch.from_numpy(a) for n, a in w.items()},
                      cfg)
    want = jlayers.mlp(x[1], {n: jnp.asarray(a) for n, a in w.items()}, cfg)
    np.testing.assert_allclose(_np(got), _np(want), **_DT[dtype][2])
    module = tlayers.MLP(cfg)
    assert {n: tuple(p.shape) for n, p in module.named_parameters()} == {
        n: a.shape for n, a in w.items()}
