"""The port's training (loss, gradients, AdamW steps, data, compression,
sharding rules) against the JAX package's, on the CPU.

Weights come from the reference's ``init_params`` through
``params_from_reference``; batches from ``make_batch`` (numpy, the same
in both).  Tolerances:

  * loss and every leaf's gradient, float32 compute, one reduced config
    of each family (ssm, hybrid on 4 layers for a windowed layer, dense
    tied and untied, gemma2's softcaps, moe in both dispatch forms and
    with a dense residual, vlm, encdec), remat on and off: rtol = atol =
    1e-5 on the loss, and on each leaf a max abs error of at most 1e-5 x
    (1 + max |reference leaf|) (the two frameworks sum in other orders);
  * three ``make_train_step`` steps (lr 1e-2, weight decay 0.1, eps
    1e-6, microbatches 1 and 2, compression on and off): the losses rtol
    1e-5, and every parameter after the steps within 0.01 x lr x 3
    (absolute).  An Adam update ``lr g / (|g| + eps)`` has the slope
    ``lr / eps`` in a gradient element near zero: at the default eps 1e-8
    the frameworks' float32 rounding (some 1e-9 in such an element) moves
    its update by 0.1 lr (3.5e-4 seen after three steps), at eps 1e-6 by
    1e-3 lr.  A wrong weight decay parts by 0.1 x lr x |p| a step, 3e-3
    on a norm after three.  With compression, an element whose float32
    total lies within rounding of a half quantum rounds to the next
    quantum in one framework (one element of 164,928 a step here), its
    update then parts by up to lr, and the next steps carry that on: the
    bar holds there for all but 2e-4 of the elements, and every element
    lies within 3 lr;
  * batches, host slices and the int8 payload ``q`` bitwise; the sharding
    specs equal leaf by leaf on full-size shapes.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.dist import compress as jcompress  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist import compress as tcompress  # noqa: E402
from repro_torch.dist import sharding as tsharding  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.weights import (params_from_reference,  # noqa: E402
                                        tree_to_reference)
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

B, S, SRC = 2, 32, 16

# (case, config, layers, overrides)
FAMILIES = [
    ("ssm", "falcon-mamba-7b", 2, {}),
    ("hybrid", "hymba-1.5b", 4, {}),
    ("dense-tied", "qwen3-4b", 2, {}),
    ("dense-untied", "starcoder2-15b", 2, {}),
    ("dense-softcap", "gemma2-2b", 2, {}),
    ("moe-onehot", "mixtral-8x22b", 2, {}),
    ("moe-gather", "mixtral-8x22b", 2, {"moe_impl": "gather"}),
    ("moe-dense-residual", "arctic-480b", 2, {}),
    ("vlm", "phi-3-vision-4.2b", 2, {}),
    ("encdec", "seamless-m4t-medium", 2, {}),
]


def _cfgs(name, n_layers, **kw):
    kw.update(dtype="float32", n_layers=n_layers)
    return (dataclasses.replace(jconfigs.reduced(jconfigs.get_config(name)),
                                **kw),
            dataclasses.replace(tconfigs.reduced(tconfigs.get_config(name)),
                                **kw))


def _init(jcfg, seed=0):
    """Weights in the reference's tree (its shapes from ``jax.eval_shape``
    of its ``init_params``) with its init's constants (norms and ``D`` 1,
    ``A_log = log(1..state)``, ``dt_bias`` -4.6, ``conv_b`` 0) and normal
    draws from numpy elsewhere (0.02, ``conv_w`` 0.1): the reference's
    init compiled would cost more than the test it feeds."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jmodel.init_params(jcfg,
                                                       jax.random.key(0)))

    def leaf(path, sd):
        name = str(path[-1].key)
        if name.startswith("ln") or name.endswith("norm") or name == "D":
            x = np.ones(sd.shape)
        elif name == "A_log":
            x = np.broadcast_to(np.log(np.arange(1, sd.shape[-1] + 1)),
                                sd.shape)
        elif name == "dt_bias":
            x = np.full(sd.shape, -4.6)
        elif name == "conv_b":
            x = np.zeros(sd.shape)
        else:
            x = rng.standard_normal(sd.shape) * (
                0.1 if name == "conv_w" else 0.02)
        return jnp.asarray(x, sd.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _port(jp, tcfg):
    return params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")


def _batch(cfg, step=0, seed=1, b=B):
    return jdata.make_batch(cfg, b, S, step=step, seed=seed, src_len=SRC)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, tree))[0]


def _at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _assert_tree_close(got_tree, want_tree, rel, what):
    n = 0
    for path, want in _leaves(want_tree):
        got = _at(got_tree, path)
        assert got.shape == want.shape, jax.tree_util.keystr(path)
        err = float(np.abs(got - want).max())
        bar = rel * (1.0 + float(np.abs(want).max()))
        assert err <= bar, (what, jax.tree_util.keystr(path), err, bar)
        n += 1
    assert n == sum(1 for _ in _leaves(got_tree))


@pytest.mark.parametrize("case,name,n_layers,kw", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_loss_and_grads_match_reference(case, name, n_layers, kw):
    jcfg, tcfg = _cfgs(name, n_layers, **kw)
    jp = _init(jcfg)
    b = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p, bb: jmodel.loss_fn(p, jcfg, bb, remat=True),
        has_aux=True))(jp, jb)
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    for remat in (True, False):
        model = _port(jp, tcfg)
        tcfg_t = ttrainer.TrainConfig(remat=remat)
        loss, parts, grads = ttrainer.loss_and_grads(model, tcfg, tcfg_t, tb)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]),
                                   rtol=1e-5, atol=1e-5)
        _assert_tree_close(tree_to_reference(grads, tcfg), jg, 1e-5,
                           f"{case} remat={remat} grad")


STEPS = [(1, False), (2, False), (1, True)]


@pytest.mark.parametrize("mb,compress", STEPS,
                         ids=["plain", "microbatches2", "compressed"])
def test_three_train_steps_match_reference(mb, compress):
    """hymba-1.5b reduced (attention and Mamba, every norm and Mamba
    vector decayed as the reference decays its stacked leaves):
    three steps, lr 1e-2 so the weight decay moves the norms visibly."""
    jcfg, tcfg = _cfgs("hymba-1.5b", 2)
    opt = jopt.AdamWConfig(lr=1e-2, eps=1e-6, warmup_steps=1,
                           total_steps=10, weight_decay=0.1)
    jtc = jtrainer.TrainConfig(opt=opt, microbatches=mb, remat=True,
                               compress_grads=compress)
    ttc = ttrainer.TrainConfig(opt=topt.AdamWConfig(**dataclasses.asdict(
        opt)), microbatches=mb, remat=True, compress_grads=compress)
    jp = _init(jcfg)
    model = _port(jp, tcfg)
    jstate = jopt.init_opt_state(jp, opt)
    jef = (jcompress.init_error_feedback(jp) if compress else
           jax.tree.map(lambda p: jnp.zeros((), jnp.float32), jp))
    jstep = jtrainer.make_train_step(jcfg, jtc)
    tstate = topt.init_opt_state(model, ttc.opt)
    tef = tcompress.init_error_feedback(model) if compress else {}
    tstep = ttrainer.make_train_step(tcfg, ttc)
    for step in range(3):
        b = _batch(jcfg, step=step, b=4)
        jp, jstate, jef, jm = jstep(jp, jstate, jef,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tef, tm = tstep(model, tstate, tef,
                                {k: torch.as_tensor(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 3
    got = tree_to_reference(model, tcfg)
    bar = 0.01 * opt.lr * 3
    err = np.concatenate([np.abs(_at(got, path) - want).ravel()
                          for path, want in _leaves(jp)])
    if compress:
        assert (err > bar).mean() <= 2e-4 and err.max() <= 3 * opt.lr
    else:
        assert err.max() <= bar
    # the norms moved by the decay as the reference's did: ln1 starts at 1
    assert not np.allclose(got["layers"]["ln1"], 1.0)


def test_weight_decay_reads_the_reference_rank():
    _, tcfg = _cfgs("hymba-1.5b", 2)
    model = tmodel.init_params(tcfg, device="meta")
    named = dict(model.named_parameters())
    for name in ("layers.0.ln1", "layers.1.ssm.D", "layers.0.ssm.dt_bias",
                 "layers.0.ssm.conv_b", "layers.0.ssm.A_log",
                 "layers.0.attn.wq", "embed"):
        assert topt.decays(name, named[name]), name
    assert not topt.decays("final_norm", named["final_norm"])
    assert topt.reference_ndim("layers.0.ln1", named["layers.0.ln1"]) == 2


def test_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for s in (0, 1, 5, 10, 11, 37, 55, 99, 100, 150):
        want = float(jopt.schedule(jopt.AdamWConfig(**cfg), jnp.int32(s)))
        got = float(topt.schedule(topt.AdamWConfig(**cfg),
                                  torch.tensor(s, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", jconfigs.ARCHS)
def test_batches_bitwise_equal_reference(name):
    jcfg = jconfigs.reduced(jconfigs.get_config(name))
    tcfg = tconfigs.reduced(tconfigs.get_config(name))
    for step in (0, 3):
        want = jdata.make_batch(jcfg, 8, 16, step=step, seed=7, src_len=12)
        got = tdata.make_batch(tcfg, 8, 16, step=step, seed=7, src_len=12)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        for h in range(4):
            for k, v in jdata.host_slice(want, h, 4).items():
                np.testing.assert_array_equal(tdata.host_slice(got, h, 4)[k],
                                              v)
    jit, tit = (mod.batches(c, 4, 8, seed=2, start_step=5)
                for mod, c in ((jdata, jcfg), (tdata, tcfg)))
    for _ in range(2):
        a, c = next(jit), next(tit)
        for k in a:
            np.testing.assert_array_equal(a[k], c[k])


def test_quantize_bitwise_equal_reference():
    rng = np.random.default_rng(4)
    for x in (rng.standard_normal(1000).astype(np.float32) * 5,
              rng.standard_normal((16, 33)).astype(np.float32) * 1e-3,
              np.zeros(8, np.float32)):
        jz = jcompress.quantize(jnp.asarray(x))
        tz = tcompress.quantize(torch.as_tensor(x))
        np.testing.assert_array_equal(tz.q.numpy(), np.asarray(jz.q))
        assert float(tz.scale) == float(jz.scale)
        np.testing.assert_allclose(tcompress.dequantize(tz).numpy(),
                                   np.asarray(jcompress.dequantize(jz)),
                                   rtol=1e-7, atol=0)
    g = {"a": rng.standard_normal(64).astype(np.float32)}
    e = {"a": (0.01 * rng.standard_normal(64)).astype(np.float32)}
    jq, je = jcompress.compress_grads(
        {"a": jnp.asarray(g["a"])}, {"a": jnp.asarray(e["a"], jnp.bfloat16)})
    tq, te = tcompress.compress_grads(
        {"a": torch.as_tensor(g["a"])},
        {"a": torch.as_tensor(e["a"]).to(torch.bfloat16)})
    np.testing.assert_allclose(tq["a"].numpy(), np.asarray(jq["a"]),
                               rtol=1e-7)
    np.testing.assert_array_equal(te["a"].float().numpy(),
                                  np.asarray(je["a"], np.float32))
    # a stacked [L, ...] leaf is one tensor with one scale in the
    # reference: the port's per-layer gradients of it share that scale
    st = np.stack([rng.standard_normal(64).astype(np.float32),
                   10 * rng.standard_normal(64).astype(np.float32)])
    jq, _ = jcompress.compress_grads(
        {"layers": {"w": jnp.asarray(st)}},
        {"layers": {"w": jnp.zeros(st.shape, jnp.bfloat16)}})
    tq, _ = tcompress.compress_grads(
        {f"layers.{i}.w": torch.as_tensor(st[i]) for i in range(2)},
        {f"layers.{i}.w": torch.zeros(64, dtype=torch.bfloat16)
         for i in range(2)})
    for i in range(2):
        np.testing.assert_allclose(tq[f"layers.{i}.w"].numpy(),
                                   np.asarray(jq["layers"]["w"][i]),
                                   rtol=1e-7)


_MESHES = {"16x16": {"data": 16, "model": 16},
           "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("name", jconfigs.ARCHS)
def test_param_pspecs_match_reference(name):
    """The reference's rules on ``jax.eval_shape(init_params)`` of the
    full-size config against the port's on its model built on ``meta``,
    the layer dim dropped; mixtral with ``expert_shard`` both ways.  The
    reference reads only ``mesh.shape``."""
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    shapes = jax.eval_shape(lambda: jmodel.init_params(jcfg,
                                                       jax.random.key(0)))
    model = tmodel.LM(tcfg, device="meta")
    stacked = {"layers": tcfg.n_layers, "encoder": tcfg.enc_layers}
    for mesh_shape in _MESHES.values():
        mesh = types.SimpleNamespace(shape=mesh_shape)
        for ep in ((False, True) if name == "mixtral-8x22b" else (False,)):
            want = jsharding.param_pspecs(shapes, mesh, expert_shard=ep)
            got = tsharding.param_pspecs(model, mesh_shape, expert_shard=ep)
            n = 0
            for path, spec in jax.tree_util.tree_flatten_with_path(
                    want, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))[0]:
                keys = [k.key for k in path]
                leaf = _at(shapes, path)
                spec = tuple(spec) + (None,) * (leaf.ndim - len(spec))
                if keys[0] in stacked:
                    for i in range(stacked[keys[0]]):
                        port = ".".join([keys[0], str(i)] + keys[1:])
                        assert got[port] == spec[1:], (port, mesh_shape, ep)
                        n += 1
                else:
                    assert got[".".join(keys)] == spec, (keys, mesh_shape)
                    n += 1
            assert n == len(got)
