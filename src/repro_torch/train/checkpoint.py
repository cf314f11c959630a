"""Checkpoints: atomic, one ``.npy`` a leaf.

The port of ``repro.train.checkpoint``.  A checkpoint of ``step`` is the
directory ``step_XXXXXXXX`` under ``path``, written as ``.tmp`` and then
renamed, so a crash during a save never leaves a partial checkpoint
behind as the latest.  Each leaf is ``leaf_xxxxx.npy`` (a bf16 tensor as
its ``uint16`` bits, numpy having no bf16), with ``meta.json`` giving
the step, the leaf count and each leaf's dtype.  The device-to-host
copies are made before :func:`save` returns; with ``blocking=False`` the
files are written on a thread, under the next step's compute.

A tree is a tensor, or a dict, list, tuple or NamedTuple of trees; its
leaves are numbered depth-first (a dict's in its insertion order).  The
trainer saves (parameters, AdamW ``m``, ``v``, ``step``, error feedback)
in the port's own order; the reference's checkpoints are not read.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def _rebuild(like, it):
    """``like``'s structure with its leaves taken from ``it`` in order."""
    if isinstance(like, torch.Tensor):
        return next(it)
    if isinstance(like, dict):
        return {k: _rebuild(v, it) for k, v in like.items()}
    items = [_rebuild(t, it) for t in like]
    if hasattr(like, "_fields"):          # NamedTuple
        return type(like)(*items)
    return type(like)(items)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _step_dir(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}")


def save(path: str, step: int, tree: Any, *, blocking: bool = True
         ) -> Optional[threading.Thread]:
    """Write the checkpoint of ``step`` under ``path`` (atomic rename).
    Returns the writing thread with ``blocking=False``, else None."""
    leaves = _leaves(tree)
    dtypes = [str(t.dtype).replace("torch.", "") for t in leaves]
    host = [_host(t) for t in leaves]

    def write():
        final = _step_dir(path, step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        for i, arr in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(host),
                       "dtypes": dtypes}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def _steps(path: str) -> List[int]:
    if not os.path.isdir(path):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(path)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(path: str) -> Optional[int]:
    steps = _steps(path)
    return steps[-1] if steps else None


def restore(path: str, step: int, like: Any, *, device="cuda") -> Any:
    """The checkpoint of ``step`` in the structure of ``like``, each leaf
    in ``like``'s leaf's dtype, on ``device``.  Raises on another leaf
    count or shape."""
    d = _step_dir(path, step)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    ref = _leaves(like)
    if meta["n_leaves"] != len(ref):
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, the "
                         f"tree {len(ref)}")
    loaded = []
    for i, r in enumerate(ref):
        arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
        if meta["dtypes"][i] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if tuple(t.shape) != tuple(r.shape):
            raise ValueError(f"leaf {i}: shape {tuple(t.shape)} != "
                             f"{tuple(r.shape)}")
        loaded.append(t.to(device=device, dtype=r.dtype))
    return _rebuild(like, iter(loaded))


def prune(path: str, keep: int = 3) -> None:
    """Delete all but the ``keep`` latest checkpoints."""
    for s in _steps(path)[:-keep]:
        shutil.rmtree(_step_dir(path, s), ignore_errors=True)
