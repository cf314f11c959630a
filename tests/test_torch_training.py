"""The port's training substrate on its own, on the CPU: the counterparts
of the reference's ``tests/test_training.py`` (schedule, a quadratic,
data and host slices, the quantize bound, error feedback, checkpoints,
the loss going down, a bit-identical crash and restart, gradient
accumulation, compressed training), and the training modules' sync lint.

Weights come from ``init_params`` with a ``torch.Generator`` (the
trainer's own), data from ``make_batch``.  Tolerances are the
reference test's own: schedule values ``pytest.approx`` (1e-6 absolute at
the floor), the quadratic below 0.2, the quantize error within 17.5/127,
the error-feedback residual within 5% of the signal, the loss down by
0.5 over 40 steps, grad accumulation's loss rtol 1e-3 and parameters
rtol 2e-3 / atol 2e-5 (float32; the two sum over the batch in other
orders); the restart and the checkpoint round trip bitwise.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import sync_lint  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.dist.compress import (  # noqa: E402
    compress_grads, dequantize, quantize)
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.data import (  # noqa: E402
    batches, host_slice, make_batch)
from repro_torch.train.optimizer import (AdamWConfig,  # noqa: E402
                                         adamw_update, init_opt_state,
                                         schedule)
from repro_torch.train.trainer import (ResilientTrainer,  # noqa: E402
                                       TrainConfig, make_train_step)

PORT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    tmodel.__file__)))


def test_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in [0, 5, 10, 55, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, abs=1e-6)


def test_adamw_reduces_quadratic():
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.ones(8, 8) * 3.0, requires_grad=False)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=1000, min_lr_frac=1.0)
    st = init_opt_state(model, cfg)
    for _ in range(200):
        st, _ = adamw_update(model, {"w": 2 * model.w}, st, cfg)
    assert float(model.w.abs().max()) < 0.2
    assert int(st.step) == 200


def test_data_determinism_and_host_slicing():
    cfg = reduced(get_config("qwen3-4b"))
    a = make_batch(cfg, 8, 16, step=3, seed=7)
    b = make_batch(cfg, 8, 16, step=3, seed=7)
    assert np.array_equal(a["tokens"], b["tokens"])
    c = make_batch(cfg, 8, 16, step=4, seed=7)
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert np.array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert host_slice(a, 0, 4)["tokens"].shape == (2, 16)
    assert np.array_equal(np.concatenate(
        [host_slice(a, i, 4)["tokens"] for i in range(4)]), a["tokens"])


def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((1000,)).astype(np.float32)) * 5
    z = quantize(x)
    y = dequantize(z)
    assert float((y - x).abs().max()) <= 5 * 3.5 / 127.0
    assert z.q.dtype == torch.int8


def test_error_feedback_preserves_signal():
    """Sum of compressed grads + final error == sum of true grads."""
    rng = np.random.default_rng(1)
    g_true = [torch.as_tensor(rng.standard_normal((64,)).astype(np.float32))
              for _ in range(20)]
    ef = {"g": torch.zeros((64,), dtype=torch.bfloat16)}
    acc = torch.zeros((64,))
    for g in g_true:
        gq, ef = compress_grads({"g": g}, ef)
        acc = acc + gq["g"]
    total_true = sum(g_true)
    resid = acc + ef["g"].float() - total_true
    scale = float(total_true.abs().max())
    assert float(resid.abs().max()) < 0.05 * max(scale, 1.0)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16) / 3},
            "s": torch.tensor(7, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 5, tree)
    assert ckpt.latest_step(str(tmp_path)) == 5
    out = ckpt.restore(str(tmp_path), 5, tree, device="cpu")
    for k in ("a", "s"):
        assert out[k].dtype == tree[k].dtype and torch.equal(out[k], tree[k])
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    ckpt.save(str(tmp_path), 7, tree, blocking=False).join(timeout=60)
    assert ckpt.latest_step(str(tmp_path)) == 7
    ckpt.prune(str(tmp_path), keep=1)
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert not os.path.isdir(os.path.join(str(tmp_path), "step_00000005"))
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 7, {"a": tree["a"]}, device="cpu")
    # a staging directory left by a crash is not a checkpoint
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert ckpt.latest_step(str(tmp_path)) == 7


def _trainer(cfg, tmp, **kw):
    return ResilientTrainer(cfg, TrainConfig(
        opt=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60),
        remat=False, **kw), ckpt_dir=str(tmp), ckpt_every=10_000,
        device="cpu")


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "compressed"])
def test_loss_decreases_small_model(tmp_path, compress):
    """The loss goes down by 0.5 over 40 steps, with int8-compressed
    gradients too (the reference's two tests)."""
    cfg = reduced(get_config("qwen3-4b"))
    tr = _trainer(cfg, tmp_path, compress_grads=compress)
    _, _, losses = tr.run(lambda s: batches(cfg, 8, 16, seed=0,
                                            start_step=s),
                          steps=40, resume=False)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5
    assert len(tr.step_times) == 40


def test_crash_restart_bit_identical(tmp_path):
    """Crash at step 12, restart from the step-10 checkpoint: the losses
    and the parameters equal an uninterrupted run's bit for bit."""
    cfg = reduced(get_config("gemma2-2b"))
    tc = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=50), remat=False)

    def data_fn(s):
        return batches(cfg, 4, 16, seed=3, start_step=s)

    tr1 = ResilientTrainer(cfg, tc, ckpt_dir=str(tmp_path / "a"),
                           ckpt_every=5, device="cpu")
    m1, o1, losses1 = tr1.run(data_fn, steps=20, resume=False, seed=4)
    tr2 = ResilientTrainer(cfg, tc, ckpt_dir=str(tmp_path / "b"),
                           ckpt_every=5, device="cpu")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        tr2.run(data_fn, steps=20, fail_at=12, resume=False, seed=4)
    assert ckpt.latest_step(str(tmp_path / "b")) == 10
    tr3 = ResilientTrainer(cfg, tc, ckpt_dir=str(tmp_path / "b"),
                           ckpt_every=5, device="cpu")
    m3, o3, losses3 = tr3.run(data_fn, steps=20, resume=True, seed=4)
    assert losses3 == losses1[10:]
    for (n, a), (_, b) in zip(m1.named_parameters(), m3.named_parameters()):
        assert torch.equal(a, b), n
    assert int(o1.step) == int(o3.step) == 20
    assert all(torch.equal(o1.m[n], o3.m[n]) and torch.equal(o1.v[n],
                                                               o3.v[n])
               for n in o1.m)
    assert len(tr3.save_seconds) == 2           # steps 15 and 20


def test_grad_accumulation_matches_big_batch():
    cfg = reduced(get_config("starcoder2-15b"))
    b = {k: torch.as_tensor(v) for k, v in
         make_batch(cfg, 8, 16, step=0, seed=0).items()}
    out = []
    for mb in (1, 2):
        model = tmodel.init_params(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        tc = TrainConfig(opt=AdamWConfig(lr=1e-3), microbatches=mb,
                         remat=False)
        st = init_opt_state(model, tc.opt)
        _, _, m = make_train_step(cfg, tc)(model, st, {}, b)
        out.append((model, m))
    (p1, m1), (p2, m2) = out
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-3)
    for a, c in zip(p1.parameters(), p2.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(),
                                   rtol=2e-3, atol=2e-5)


def test_training_keeps_serving_unchanged():
    """The trainer turns gradients on; serving (prefill, decode) runs
    under ``no_grad`` and gives the same logits before and after."""
    cfg = reduced(get_config("hymba-1.5b"))
    model = tmodel.init_params(cfg, generator=torch.Generator().manual_seed(1),
                               device="cpu")
    toks = torch.as_tensor(make_batch(cfg, 2, 16, step=0)["tokens"])
    before, _ = tmodel.prefill(model, cfg, toks, 16)
    assert not any(p.requires_grad for p in model.parameters())
    loss, _ = tmodel.loss_fn(model.requires_grad_(True), cfg,
                             {"tokens": toks, "labels": toks})
    loss.backward()
    assert all(p.grad is not None for p in model.parameters())
    after, _ = tmodel.prefill(model, cfg, toks, 16)
    assert not after.requires_grad and torch.equal(before, after)


def test_training_modules_sync_lint_clean():
    """The step's one designated sync (``float(loss)``) carries its reason;
    nothing else in the training path reads the device back."""
    mods = ["train/trainer.py", "train/optimizer.py", "train/checkpoint.py",
            "train/data.py", "dist/compress.py", "dist/sharding.py",
            "models/model.py", "models/layers.py", "kernels/ssm_scan.py"]
    assert sync_lint.check_tree(PORT_ROOT, mods) == []
    with open(os.path.join(PORT_ROOT, "train/trainer.py")) as f:
        assert "allow(sync-host-sync): the designated sync" in f.read()
