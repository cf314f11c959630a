"""Training of the port (every family; the Mamba layers' scan through K6
forward and K6b backward on the card):

  data.py       — the deterministic synthetic batches (numpy; bitwise the
                  reference's).
  optimizer.py  — AdamW, its schedule and global-norm clipping, in place.
  checkpoint.py — atomic checkpoints, one ``.npy`` a leaf.
  trainer.py    — ``TrainConfig``, ``make_train_step``, ``ResilientTrainer``.
"""
from repro_torch.train.data import batches, host_slice, make_batch
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update,
                                         global_norm, init_opt_state,
                                         schedule)
from repro_torch.train.trainer import (ResilientTrainer, TrainConfig,
                                       make_train_step)

__all__ = ["batches", "host_slice", "make_batch", "AdamWConfig", "OptState",
           "adamw_update", "global_norm", "init_opt_state", "schedule",
           "ResilientTrainer", "TrainConfig", "make_train_step"]
