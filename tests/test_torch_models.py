"""The port's LM serving slice (repro_torch.models, repro_torch.configs,
repro_torch.serve) against the JAX package, on the CPU.

Inputs and weights come from a seed (numpy, or the reference's
``init_params`` carried across by ``params_from_reference``) and go through
both packages.  Tolerances: float32 configs rtol 1e-5 and atol 1e-5 (the
frameworks sum in different orders); bfloat16 configs rtol 2e-2 and atol
2e-2, the reference's own prefill-vs-decode bar (``tests/test_archs.py``),
since bf16 rounds at other places in the two (the reference's compiled
scan and jitted decode keep bf16 intermediates in float32, its eager
prefill does not; matmul sums differ).  On the CPU ``mamba_scan`` runs the
plain step-by-step scan; K6 itself is held against its plain version on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.weights import params_from_reference  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _tol(cfg):
    return F32 if cfg.dtype == "float32" else BF16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _cfg(dtype):
    return dataclasses.replace(
        jconfigs.reduced(jconfigs.get_config("falcon-mamba-7b")), dtype=dtype)


_MODELS = {}


def _models(dtype, seed=0):
    """The reference's reduced falcon-mamba weights and the port's copy."""
    key = (dtype, seed)
    if key not in _MODELS:
        cfg = _cfg(dtype)
        jp = jmodel.init_params(cfg, jax.random.key(seed))
        tree = jax.tree.map(np.asarray, jp)
        _MODELS[key] = (cfg, jp, params_from_reference(tree, cfg,
                                                       device="cpu"))
    return _MODELS[key]


def _scan_inputs(seed, B, S, di, state, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((B, S, di)).astype(dtype)
    dt = (0.1 * rng.random((B, S, di))).astype(dtype)
    Bm = rng.standard_normal((B, S, state)).astype(dtype)
    Cm = rng.standard_normal((B, S, state)).astype(dtype)
    A = -np.abs(rng.standard_normal((di, state))).astype(np.float32)
    D = rng.standard_normal(di).astype(np.float32)
    h0 = rng.standard_normal((B, di, state)).astype(np.float32)
    return x1, dt, Bm, Cm, A, D, h0


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_equal_reference(arch):
    assert tconfigs.ARCHS == jconfigs.ARCHS
    for name in (arch, arch.replace("-", "_")):
        full_t, full_j = tconfigs.get_config(name), jconfigs.get_config(name)
        assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
        assert (dataclasses.asdict(tconfigs.reduced(full_t))
                == dataclasses.asdict(jconfigs.reduced(full_j)))
    with pytest.raises(KeyError):
        tconfigs.get_config(arch + "-nope")


# -- weights -------------------------------------------------------------------

def test_full_falcon_mamba_shapes_on_meta_match_reference():
    """Full width on the meta device (no 28 GB allocation) against
    ``jax.eval_shape`` of the reference's init."""
    cfg = tconfigs.get_config("falcon-mamba-7b")
    model = tmodel.init_params(cfg, device="meta")
    assert tmodel.param_count(model) == 7_006_326_784
    assert tmodel.vocab_padded(cfg) == 65024
    ref = jax.eval_shape(lambda: jmodel.init_params(
        jconfigs.get_config("falcon-mamba-7b"), jax.random.key(0)))
    assert jmodel.param_count(ref) == tmodel.param_count(model)
    sd = model.state_dict()
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in sd.values())
    assert tuple(sd["embed"].shape) == ref["embed"].shape
    assert tuple(sd["final_norm"].shape) == ref["final_norm"].shape
    stacked = {"ln1": ref["layers"]["ln1"]} | {
        f"ssm.{k}": v for k, v in ref["layers"]["ssm"].items()}
    assert set(ref["layers"]) == {"ln1", "ssm"}
    for name, leaf in stacked.items():
        assert leaf.dtype == jnp.float32 and leaf.shape[0] == cfg.n_layers
        for i in (0, cfg.n_layers - 1):
            assert tuple(sd[f"layers.{i}.{name}"].shape) == leaf.shape[1:]
    n_leaves = 2 + cfg.n_layers * len(stacked)
    assert len(sd) == n_leaves


def test_init_params_constants_and_seed():
    cfg = tconfigs.reduced(tconfigs.get_config("falcon-mamba-7b"))
    a = tmodel.init_params(cfg, generator=torch.Generator().manual_seed(3),
                           device="cpu")
    b = tmodel.init_params(cfg, generator=torch.Generator().manual_seed(3),
                           device="cpu")
    jp = jax.tree.map(np.asarray, _models("float32")[1])
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    p = a.layers[1].ssm
    ref = jp["layers"]["ssm"]
    for name in ("conv_b", "dt_bias", "D"):
        np.testing.assert_array_equal(getattr(p, name).numpy(), ref[name][1])
    np.testing.assert_allclose(p.A_log.numpy(), ref["A_log"][1], rtol=1e-7)
    np.testing.assert_array_equal(a.final_norm.numpy(), jp["final_norm"])
    for name, scale in (("in_proj", 0.02), ("conv_w", 0.1),
                        ("out_proj", 0.02 / np.sqrt(2 * cfg.n_layers))):
        std = float(getattr(p, name).std())
        assert 0.8 * scale < std < 1.2 * scale, (name, std)
    with pytest.raises(ValueError):
        tmodel.init_params(cfg, device="cpu")


def test_params_from_reference_round_trips_exactly():
    cfg, jp, model = _models("float32")
    ref = jax.tree.map(np.asarray, jp)
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["embed"].numpy(), ref["embed"])
    np.testing.assert_array_equal(sd["final_norm"].numpy(), ref["final_norm"])
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(sd[f"layers.{i}.ln1"].numpy(),
                                      ref["layers"]["ln1"][i])
        for k, v in ref["layers"]["ssm"].items():
            np.testing.assert_array_equal(sd[f"layers.{i}.ssm.{k}"].numpy(),
                                          v[i])
    assert tmodel.param_count(model) == jmodel.param_count(jp)
    bad = jax.tree.map(lambda a: a, ref)
    bad["layers"]["ssm"].pop("D")
    with pytest.raises(RuntimeError):
        params_from_reference(bad, cfg, device="cpu")


# -- the scan ------------------------------------------------------------------

@pytest.mark.parametrize("B,S,di,state,chunk", [
    (2, 32, 16, 4, 8), (1, 16, 24, 16, 16), (3, 8, 8, 8, 4)])
def test_mamba_scan_matches_reference_and_k6_plain(B, S, di, state, chunk):
    x1, dt, Bm, Cm, A, D, h0 = _scan_inputs(B * S + di, B, S, di, state)
    t = [torch.as_tensor(a) for a in (x1, dt, Bm, Cm, A, D, h0)]
    before = kops.launch_counts()
    y, h = tlayers.mamba_scan(*t, chunk)
    assert kops.launch_counts() == before
    yj, hj = jlayers.mamba_scan(*map(jnp.asarray, (x1, dt, Bm, Cm, A, D, h0)),
                                chunk)
    _close(y, yj, F32)
    _close(h, hj, F32)
    yk, hk = kops.ssm_scan(t[0], t[1], t[2], t[3], t[4], t[6])
    _close(y, yk + t[5] * t[0], F32)
    _close(h, hk, F32)
    with pytest.raises(AssertionError):
        tlayers.mamba_scan(*t, S - 1 if S > 2 else 3)


def test_mamba_scan_bf16_inputs_bitwise_equal_to_k6_plain():
    """With bf16 x, dt, B, C the model's order (dt*B)*x and K6's (dt*x)*B
    are both exact in float32, so the CPU scan equals K6's plain version
    plus the D skip bit for bit; both stay within the f32 bar of the
    reference's scan on the same bf16 inputs."""
    x1, dt, Bm, Cm, A, D, h0 = _scan_inputs(5, 2, 32, 16, 4)
    bf = [torch.as_tensor(a).to(torch.bfloat16) for a in (x1, dt, Bm, Cm)]
    A_, D_, h0_ = map(torch.as_tensor, (A, D, h0))
    y, h = tlayers.mamba_scan(*bf, A_, D_, h0_, 16)
    yk, hk = kops.ssm_scan(*bf, A_, h0_)
    assert torch.equal(h, hk)
    assert torch.equal(y, yk + D_ * bf[0].float())
    jb = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in bf]
    yj, hj = jax.jit(jlayers.mamba_scan, static_argnums=7)(
        *jb, jnp.asarray(A), jnp.asarray(D), jnp.asarray(h0), 16)
    _close(y, yj, F32)
    _close(h, hj, F32)


# -- the Mamba block -----------------------------------------------------------

def _block_input(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    cd = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x, cd)
    return xj, torch.from_numpy(_np(xj).copy()).to(tmodel._cdtype(cfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_train_and_decode_match_reference(dtype):
    cfg, jp, model = _models(dtype)
    cd = tmodel._cdtype(cfg)
    view = tmodel.cast_for_compute(model, cfg)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["ssm"])
    for mixer in (model.layers[0].ssm, view.layers[0].ssm):
        xj, xt = _block_input(cfg, 2, 16, 1)
        out, h, conv = mixer(xt)
        oj, hj, _ = jlayers.mamba_block(xj, jl, cfg)
        assert out.dtype == cd and conv is None
        _close(out, oj, _tol(cfg))
        _close(h, hj, _tol(cfg))
        # decode from a carried state and conv window
        rng = np.random.default_rng(2)
        h0 = rng.standard_normal((2, cfg.d_inner, cfg.ssm_state))
        buf = rng.standard_normal((2, cfg.ssm_conv - 1, cfg.d_inner))
        h0j = jnp.asarray(h0, jnp.float32)
        bufj = jnp.asarray(buf, xj.dtype)
        xj1, xt1 = xj[:, :1], xt[:, :1]
        dec = jax.jit(lambda x, h, b: jlayers.mamba_block(
            x, jl, cfg, h0=h, conv_buf=b, decode=True))
        oj, hj, bj = dec(xj1, h0j, bufj)
        out, h, b = mixer(xt1, h0=torch.from_numpy(_np(h0j).copy()),
                          conv_buf=torch.from_numpy(_np(bufj).copy()).to(cd),
                          decode=True)
        _close(out, oj, _tol(cfg))
        _close(h, hj, _tol(cfg))
        _close(b, bj, _tol(cfg))


# -- prefill and decode --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_steps_match_reference(dtype):
    """Prefill logits, every layer's h and conv, then three decode steps
    (the reference's jitted, as its Engine runs them)."""
    cfg, jp, model = _models(dtype)
    tol = _tol(cfg)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    lj, cj = jmodel.prefill(jp, cfg, jnp.asarray(toks), 32)
    lt, ct = tmodel.prefill(model, cfg, torch.as_tensor(toks), 32)
    assert lt.shape == (2, tmodel.vocab_padded(cfg)) and lt.dtype == torch.float32
    _close(lt, lj, tol)
    for a, b in zip(ct, cj):
        _close(a["h"], b["h"], tol)
        _close(a["conv"], b["conv"], tol)
    dec = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, cfg, c, t, pos))
    for step in range(3):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        lj, cj = dec(jp, cj, jnp.asarray(tok), jnp.int32(16 + step))
        lt, ct = tmodel.decode_step(model, cfg, ct, torch.as_tensor(tok),
                                    16 + step)
        _close(lt, lj, tol)
        for a, b in zip(ct, cj):
            _close(a["h"], b["h"], tol)
            _close(a["conv"], b["conv"], tol)


def test_prefill_matches_decode():
    """The reference's prefill-vs-decode property on the port: prefill's
    last logits equal feeding the same tokens one by one (bf16 bar)."""
    cfg = tconfigs.reduced(tconfigs.get_config("falcon-mamba-7b"))
    model = tmodel.init_params(cfg, generator=torch.Generator().manual_seed(2),
                               device="cpu")
    toks = torch.as_tensor(
        np.random.default_rng(2).integers(0, cfg.vocab, (1, 8)),
        dtype=torch.int32)
    lp, cp = tmodel.prefill(model, cfg, toks, 32)
    caches = tmodel.init_cache(cfg, 1, 32, device="cpu")
    for t in range(8):
        ld, caches = tmodel.decode_step(model, cfg, caches, toks[:, t:t + 1], t)
    torch.testing.assert_close(lp, ld, **BF16)
    for a, b in zip(cp, caches):
        torch.testing.assert_close(a["h"], b["h"], **BF16)
        torch.testing.assert_close(a["conv"], b["conv"], atol=0, rtol=0)


# -- the engine ----------------------------------------------------------------

def _requests(cfg, req_cls):
    rng = np.random.default_rng(6)
    return [req_cls(prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=m) for n, m in ((16, 6), (9, 4), (3, 6))]


def _engines(dtype, monkeypatch):
    """Both engines on the same weights; every step's logits recorded."""
    cfg, jp, model = _models(dtype)
    seen = {"t": [], "j": []}

    def record(fn, key):
        def run(*a, **kw):
            logits, caches = fn(*a, **kw)
            seen[key].append(_np(logits))
            return logits, caches
        return run

    monkeypatch.setattr(tmodel, "prefill", record(tmodel.prefill, "t"))
    monkeypatch.setattr(tmodel, "decode_step", record(tmodel.decode_step, "t"))
    monkeypatch.setattr(jmodel, "prefill", record(jmodel.prefill, "j"))
    te = tengine.Engine(cfg, model, batch=4, cache_len=32, device="cpu")
    je = jengine.Engine(cfg, jp, batch=4, cache_len=32)
    je._decode = record(je._decode, "j")
    return cfg, te, je, seen


def test_engine_greedy_ids_equal_reference_f32(monkeypatch):
    cfg, te, je, seen = _engines("float32", monkeypatch)
    out_t = te.generate(_requests(cfg, tengine.Request))
    out_j = je.generate(_requests(cfg, jengine.Request))
    assert [o.tolist() for o in out_t] == [o.tolist() for o in out_j]
    assert [len(o) for o in out_t] == [6, 4, 6]
    assert len(seen["t"]) == len(seen["j"]) == 6
    for lt, lj in zip(seen["t"], seen["j"]):
        np.testing.assert_allclose(lt, lj, **F32)
    # seeded sampling is repeatable and left-padding does not leak
    s1 = te.generate(_requests(cfg, tengine.Request), greedy=False, seed=3)
    s2 = te.generate(_requests(cfg, tengine.Request), greedy=False, seed=3)
    assert [o.tolist() for o in s1] == [o.tolist() for o in s2]


def test_engine_greedy_bf16_logits_and_clear_ids(monkeypatch):
    """bf16: each step's logits within the bf16 bar while a request's
    earlier ids agree, and equal ids wherever the reference's top-2 gap
    exceeds the bar (below it the two may part, and the request's later
    steps see other tokens)."""
    cfg, te, je, seen = _engines("bfloat16", monkeypatch)
    reqs = _requests(cfg, tengine.Request)
    out_t = te.generate(reqs)
    out_j = je.generate(_requests(cfg, jengine.Request))
    checked = 0
    for i, r in enumerate(reqs):
        for t in range(r.max_new):
            lt, lj = seen["t"][t][i], seen["j"][t][i]
            np.testing.assert_allclose(lt, lj, **BF16)
            top2 = np.sort(lj)[-2:]
            bar = BF16["atol"] + BF16["rtol"] * abs(top2[1])
            if top2[1] - top2[0] > 2 * bar:
                assert out_t[i][t] == out_j[i][t], (i, t)
                checked += 1
            if out_t[i][t] != out_j[i][t]:
                break
    assert checked > 0
