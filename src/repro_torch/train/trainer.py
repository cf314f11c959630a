"""Training loop: the train step and the fault-tolerant run loop.

The port of ``repro.train.trainer``.  :func:`make_train_step` builds the
step:

  * the loss and every parameter's gradient (:func:`repro_torch.models.
    model.loss_fn`, each layer under ``checkpoint`` with ``remat``);
  * optional microbatch accumulation: the batch split along its first
    dim, the gradients summed in float32 and averaged;
  * optional int8 compression with error feedback
    (:mod:`repro_torch.dist.compress`);
  * AdamW, written into the model's parameters in place
    (:mod:`repro_torch.train.optimizer`).

The reference jits the step and donates its buffers; PyTorch runs it
eagerly and updates the parameters in place instead.

:class:`ResilientTrainer` is the control plane in miniature: a checkpoint
every ``ckpt_every`` steps (atomic) and restart from the latest, a
simulated failure (a restart gives a bit-identical trajectory: the data
rewinds to the checkpointed step and nothing in a step is random), and a
per-step wall clock that records stragglers.  Where the reference
restores onto another mesh, one card holds everything: the placements of
:mod:`repro_torch.dist.sharding` wait for the mesh across cards.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.dist import compress as comp_mod
from repro_torch.models import model as model_mod
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1          # gradient accumulation
    remat: bool = True
    compress_grads: bool = False   # int8 + error feedback
    aux_weight: float = 0.01


def loss_and_grads(model, cfg: ModelConfig, tcfg: TrainConfig, batch):
    """``(loss, {"ce", "aux"}, {parameter name: gradient})`` on ``batch``;
    a parameter the loss does not reach gets a zero gradient.  Turns the
    parameters' gradients on (serving runs under ``no_grad``, so this
    changes nothing there)."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    loss, parts = model_mod.loss_fn(model, cfg, batch, remat=tcfg.remat,
                                    aux_weight=tcfg.aux_weight)
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), gs)}
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``train_step(model, opt_state, ef_state, batch) ->
    (opt_state, ef_state, metrics)``; the model's parameters are updated
    in place.  ``batch``: tensors on the model's device.  ``metrics``
    (tensors on the device): ``loss``, ``lr``, ``grad_norm`` and, without
    microbatches, ``ce`` and ``aux``."""

    def train_step(model, opt_state, ef_state, batch):
        mb = tcfg.microbatches
        metrics: Dict[str, Any]
        if mb > 1:
            grads, loss = None, None
            for i in range(mb):
                part = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                        for k, v in batch.items()}
                li, _, g = loss_and_grads(model, cfg, tcfg, part)
                if grads is None:
                    grads = {n: t.float() for n, t in g.items()}
                    loss = li
                else:
                    grads = {n: grads[n] + t for n, t in g.items()}
                    loss = loss + li
            div = torch.full((), mb, dtype=torch.float32, device=loss.device)
            grads = {n: t / div for n, t in grads.items()}
            loss = loss / div
            metrics = {}
        else:
            loss, metrics, grads = loss_and_grads(model, cfg, tcfg, batch)
        if tcfg.compress_grads:
            grads, ef_state = comp_mod.compress_grads(grads, ef_state)
        opt_state, om = adamw_update(model, grads, opt_state, tcfg.opt)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return opt_state, ef_state, metrics

    return train_step


@dataclasses.dataclass
class ResilientTrainer:
    cfg: ModelConfig
    tcfg: TrainConfig
    ckpt_dir: str
    ckpt_every: int = 10
    straggler_factor: float = 3.0   # slower than factor x median: straggler
    device: Any = "cuda"

    def __post_init__(self):
        self.step_times: list = []
        self.stragglers: list = []
        self.save_seconds: list = []
        self._train_step = make_train_step(self.cfg, self.tcfg)

    def init_state(self, seed: int = 0):
        """(model, AdamW state, error feedback) from ``seed``: the weights
        drawn by a ``torch.Generator`` on the device; the error feedback
        is an empty dict without compression."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        model = model_mod.init_params(self.cfg, generator=gen,
                                      device=self.device)
        model.requires_grad_(True)
        opt = init_opt_state(model, self.tcfg.opt)
        ef = (comp_mod.init_error_feedback(model)
              if self.tcfg.compress_grads else {})
        return model, opt, ef

    @staticmethod
    def _tree(model, opt, ef):
        """What a checkpoint holds: (parameters, AdamW m, v, step, error
        feedback)."""
        return dict(model.named_parameters()), opt, ef

    def run(self, data_fn: Callable[[int], Iterator[Dict[str, np.ndarray]]],
            steps: int, fail_at: Optional[int] = None, resume: bool = True,
            seed: int = 0, log_every: int = 0):
        """Train to ``steps``; raise a simulated crash at step ``fail_at``;
        resume from the latest checkpoint if one exists.
        ``data_fn(start_step)`` builds the deterministic input iterator
        from a step, so after a restart the trajectory is bit-identical
        to an uninterrupted run.  Returns (model, AdamW state, losses)."""
        model, opt, ef = self.init_state(seed)
        start = 0
        if resume:
            latest = ckpt_mod.latest_step(self.ckpt_dir)
            if latest is not None:
                params, opt, ef = ckpt_mod.restore(
                    self.ckpt_dir, latest, self._tree(model, opt, ef),
                    device=self.device)
                with torch.no_grad():
                    for name, p in model.named_parameters():
                        p.copy_(params[name])
                start = latest
        data = data_fn(start)
        losses = []
        for step in range(start, steps):
            batch = next(data)
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"simulated node failure at step {step}")
            t0 = time.perf_counter()
            opt, ef, metrics = self._train_step(
                model, opt, ef, {k: torch.as_tensor(v, device=self.device)
                                 for k, v in batch.items()})
            # analysis: allow(sync-host-sync): the designated sync, once a step
            # (step time and stragglers measure completed work)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            med = float(np.median(self.step_times[-20:]))
            if len(self.step_times) > 5 and dt > self.straggler_factor * med:
                self.stragglers.append((step, dt, med))
            losses.append(loss)
            if log_every and step % log_every == 0:
                # analysis: allow(sync-host-sync): logging, after the sync
                lr = float(metrics["lr"])
                print(f"step {step}: loss={loss:.4f} lr={lr:.2e} "
                      f"{dt * 1e3:.0f}ms")
            if (step + 1) % self.ckpt_every == 0:
                t1 = time.perf_counter()
                ckpt_mod.save(self.ckpt_dir, step + 1,
                              self._tree(model, opt, ef))
                ckpt_mod.prune(self.ckpt_dir)
                self.save_seconds.append(time.perf_counter() - t1)
        return model, opt, losses
