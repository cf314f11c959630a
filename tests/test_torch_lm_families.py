"""The port's attention families against the JAX package, on the CPU:
hymba-1.5b (hybrid: parallel attention and Mamba heads, global and
sliding-window layers), qwen3-4b (qk-norm), gemma2-2b (softcaps, sandwich
norms, geglu, local/global layers, embedding scale), phi3-medium-14b and
starcoder2-15b (untied heads; starcoder2's gelu MLP); and the full-width
shapes and the card's cuts of the MoE, VLM and encoder-decoder families,
whose parity is in ``tests/test_torch_moe_vlm_encdec.py``.

Weights are the reference's ``init_params`` from a seed, carried across by
``params_from_reference``; token ids come from numpy with a seed.
Tolerances are those of ``tests/test_torch_models.py``: float32 rtol 1e-5
and atol 1e-5, bfloat16 rtol 2e-2 and atol 2e-2.  ``reduced()`` gives
hymba two layers, both global, so hymba runs with four (kinds 0, 1, 0, 0:
window 8 in layer 1); gemma2's two layers already hold a windowed one.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.weights import params_from_reference  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
ARCHS = ["hymba-1.5b", "qwen3-4b", "gemma2-2b", "phi3-medium-14b",
         "starcoder2-15b"]
FAMILIES = ["mixtral-8x22b", "arctic-480b", "phi-3-vision-4.2b",
            "seamless-m4t-medium"]
MOE = ["mixtral-8x22b", "arctic-480b"]
# full-width parameter counts (the reference's init, by jax.eval_shape)
FULL_PARAMS = {"hymba-1.5b": 1_611_368_000, "qwen3-4b": 4_022_795_776,
               "gemma2-2b": 2_614_341_888,
               "starcoder2-15b": 15_955_630_080}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _cfg(arch, dtype="float32"):
    cfg = jconfigs.reduced(jconfigs.get_config(arch))
    if arch == "hymba-1.5b":
        cfg = dataclasses.replace(cfg, n_layers=4)
    return dataclasses.replace(cfg, dtype=dtype)


_MODELS = {}


def _models(arch, dtype):
    """The reference's reduced weights (seed 0) and the port's copy."""
    key = (arch, dtype)
    if key not in _MODELS:
        cfg = _cfg(arch, dtype)
        jp = jmodel.init_params(cfg, jax.random.key(0))
        _MODELS[key] = (cfg, jp, params_from_reference(
            jax.tree.map(np.asarray, jp), cfg, device="cpu"))
    return _MODELS[key]


def _jit_decode(cfg):
    return jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, cfg, c, t, pos))


def _close_caches(ct, cj, tol):
    for a, b in zip(ct, cj):
        assert set(a) == set(b)
        for name in a:
            if name == "pos":
                np.testing.assert_array_equal(a[name].numpy(),
                                              np.asarray(b[name]))
            else:
                _close(a[name], b[name], tol)


# -- shapes --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + FAMILIES)
def test_full_width_shapes_on_meta_match_reference(arch):
    """Full width on the meta device against ``jax.eval_shape`` of the
    reference's init: every leaf's name, shape and dtype."""
    cfg = tconfigs.get_config(arch)
    model = tmodel.init_params(cfg, device="meta")
    ref = jax.eval_shape(lambda: jmodel.init_params(
        jconfigs.get_config(arch), jax.random.key(0)))
    assert tmodel.param_count(model) == jmodel.param_count(ref)
    if arch in FULL_PARAMS:
        assert tmodel.param_count(model) == FULL_PARAMS[arch]
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        names = [k.key for k in path]
        assert leaf.dtype == jnp.float32
        if names[0] not in ("layers", "encoder"):
            want[".".join(names)] = leaf.shape
            continue
        n = cfg.n_layers if names[0] == "layers" else cfg.enc_layers
        assert leaf.shape[0] == n
        for i in range(n):
            want[".".join([names[0], str(i)] + names[1:])] = leaf.shape[1:]
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in sd.values())
    assert ("lm_head" in sd) == (not cfg.tie_embeddings)


def test_starcoder2_cut_to_8_layers_has_the_card_run_count():
    cfg = dataclasses.replace(tconfigs.get_config("starcoder2-15b"),
                              n_layers=8)
    assert tmodel.param_count(tmodel.init_params(cfg, device="meta")) \
        == 3_674_314_752


@pytest.mark.parametrize("arch,cut,count", [
    ("mixtral-8x22b", dict(n_layers=4), 10_418_903_040),
    ("arctic-480b", dict(n_layers=2, n_experts=32), 7_601_097_728),
    ("phi-3-vision-4.2b", {}, 3_825_404_928),
    ("seamless-m4t-medium", {}, 878_770_176),
    ("hymba-1.5b", dict(n_layers=8), 441_550_400)])
def test_card_run_cuts_have_their_counts(arch, cut, count):
    """The parameter counts ``chip_smoke.py`` gates, at the cuts it
    serves, equal to the reference's at the same config."""
    cfg = dataclasses.replace(tconfigs.get_config(arch), **cut)
    assert tmodel.param_count(tmodel.init_params(cfg, device="meta")) \
        == count
    jcfg = dataclasses.replace(jconfigs.get_config(arch), **cut)
    assert jmodel.param_count(jax.eval_shape(
        lambda: jmodel.init_params(jcfg, jax.random.key(0)))) == count


def test_params_from_reference_raises_on_a_bad_tree():
    cfg, jp, _ = _models("phi3-medium-14b", "float32")
    tree = jax.tree.map(np.asarray, jp)
    missing = dict(tree)
    missing.pop("lm_head")
    with pytest.raises(RuntimeError):
        params_from_reference(missing, cfg, device="cpu")
    extra = dict(tree, frontend_proj=np.zeros((4, cfg.d_model), np.float32))
    with pytest.raises(RuntimeError):
        params_from_reference(extra, cfg, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"]["attn"]["wq"] = bad["layers"]["attn"]["wq"][:, :, :1]
    with pytest.raises(RuntimeError):
        params_from_reference(bad, cfg, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"]["mlp"]["w1"] = bad["layers"]["mlp"]["w1"][:1]
    with pytest.raises(ValueError):
        params_from_reference(bad, cfg, device="cpu")


def test_init_params_scales_and_constants():
    cfg = _cfg("hymba-1.5b")
    model = tmodel.init_params(
        cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    layer = model.layers[1]
    out_scale = 0.02 / np.sqrt(2 * cfg.n_layers)
    for w, scale in ((layer.attn.wq, 0.02), (layer.mlp.w1, 0.02),
                     (layer.attn.wo, out_scale), (layer.mlp.w2, out_scale),
                     (layer.ssm.out_proj, out_scale)):
        assert 0.8 * scale < float(w.std()) < 1.2 * scale
    for w in (layer.ln1, layer.ln2):
        assert bool((w == 1).all())
    qwen = tmodel.init_params(_cfg("qwen3-4b"),
                              generator=torch.Generator().manual_seed(1),
                              device="cpu")
    assert bool((qwen.layers[0].attn.q_norm == 1).all())
    sc = tmodel.init_params(_cfg("starcoder2-15b"),
                            generator=torch.Generator().manual_seed(1),
                            device="cpu")
    assert 0.016 < float(sc.lm_head.std()) < 0.024


# -- prefill and decode --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch, dtype):
    """Prefill logits and every cache leaf (k, v, pos; h, conv for
    hymba), then three decode steps of the reference's jitted
    ``decode_step``, as its Engine runs them."""
    cfg, jp, model = _models(arch, dtype)
    tol = F32 if dtype == "float32" else BF16
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    lj, cj = jmodel.prefill(jp, cfg, jnp.asarray(toks), 32)
    before = kops.launch_counts()
    lt, ct = tmodel.prefill(model, cfg, torch.as_tensor(toks), 32)
    assert kops.launch_counts() == before      # the CPU runs no kernel
    assert lt.shape == (2, tmodel.vocab_padded(cfg))
    assert lt.dtype == torch.float32
    _close(lt, lj, tol)
    _close_caches(ct, cj, tol)
    dec = _jit_decode(cfg)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        lj, cj = dec(jp, cj, jnp.asarray(tok), jnp.int32(16 + step))
        lt, ct = tmodel.decode_step(model, cfg, ct, torch.as_tensor(tok),
                                    16 + step)
        _close(lt, lj, tol)
        _close_caches(ct, cj, tol)


# -- the rolling window --------------------------------------------------------

def _decode_run(prefill, decode, model, cfg, toks, S, steps):
    """Prefill ``toks[:, :S]``, then decode the next ``steps`` tokens;
    the logits of each decode step."""
    _, caches = prefill(model, cfg, toks[:, :S])
    out = []
    for t in range(steps):
        logits, caches = decode(model, caches, toks[:, S + t:S + t + 1],
                                S + t)
        out.append(_np(logits))
    return out


def test_window_fault_port_keeps_its_own_prefill():
    """Reduced hymba, 4 layers, window 8, prompt S = 12 (C = 8 does not
    divide S).  The port writes position p at slot p % C in prefill, so its
    decode steps equal its own prefill of the extended prompt.  The
    reference writes the last C positions at slots 0..C-1, and its first
    decode step overwrites a position still inside the window: it parts
    from its own prefill by more than 1e-3 (ROADMAP queue 3).  At S = 8
    both layouts agree and the port equals the reference."""
    cfg, jp, model = _models("hymba-1.5b", "float32")
    assert cfg.layer_kinds() == (0, 1, 0, 0) and cfg.window == 8
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 15)).astype(np.int32)
    tt, jt = torch.as_tensor(toks), jnp.asarray(toks)
    jdec = _jit_decode(cfg)
    port = {
        "prefill": lambda m, c, t: tmodel.prefill(m, c, t, 32),
        "decode": lambda m, caches, t, pos: tmodel.decode_step(
            m, cfg, caches, t, pos)}
    ref = {
        "prefill": lambda m, c, t: jmodel.prefill(m, c, t, 32),
        "decode": lambda m, caches, t, pos: jdec(m, caches, t,
                                                 jnp.int32(pos))}
    steps_t = _decode_run(port["prefill"], port["decode"], model, cfg, tt,
                          12, 3)
    steps_j = _decode_run(ref["prefill"], ref["decode"], jp, cfg, jt, 12, 3)
    # the prefills of the extended prompts: the port's stands in for the
    # reference's (equal within 1e-5, shown at S = 13; each new length
    # costs the reference seconds of compiling)
    own = [_np(tmodel.prefill(model, cfg, tt[:, :13 + t], 32)[0])
           for t in range(3)]
    np.testing.assert_allclose(
        own[0], _np(jmodel.prefill(jp, cfg, jt[:, :13], 32)[0]), **F32)
    ref_err = []
    for t in range(3):
        np.testing.assert_allclose(steps_t[t], own[t], **F32)
        ref_err.append(float(np.abs(steps_j[t] - own[t]).max()))
    assert min(ref_err) > 1e-3, ref_err
    # S = 8: the reference's layout is the port's
    steps_t = _decode_run(port["prefill"], port["decode"], model, cfg, tt,
                          8, 3)
    steps_j = _decode_run(ref["prefill"], ref["decode"], jp, cfg, jt, 8, 3)
    for a, b in zip(steps_t, steps_j):
        np.testing.assert_allclose(a, b, **F32)


# -- the engine ----------------------------------------------------------------

def _requests(cfg, req_cls):
    rng = np.random.default_rng(6)
    return [req_cls(prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=m) for n, m in ((16, 6), (9, 4), (3, 6))]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_ids_equal_reference_f32(arch):
    """Both engines on the same weights, left-padded prompts of 16, 9 and
    3 tokens: the same greedy ids (the engine passes each decode step the
    position the reference's does)."""
    cfg, jp, model = _models(arch, "float32")
    te = tengine.Engine(cfg, model, batch=4, cache_len=32, device="cpu")
    je = jengine.Engine(cfg, jp, batch=4, cache_len=32)
    out_t = te.generate(_requests(cfg, tengine.Request))
    out_j = je.generate(_requests(cfg, jengine.Request))
    assert [o.tolist() for o in out_t] == [o.tolist() for o in out_j]
    assert [len(o) for o in out_t] == [6, 4, 6]
