"""Operand checks and launch plumbing shared by the kernel wrappers.

A wrapper runs its CUDA kernel when its tensors lie on a CUDA device and
its plain PyTorch version when they lie on the CPU (:func:`on_cuda`);
nothing else decides the route.  On the CUDA route it checks every operand
(:func:`require`) and raises on what the kernel does not take.

:data:`launches` holds every kernel's launch count: a wrapper calls
:func:`count` right after it launches its kernel, and nowhere else, so a
run can show which kernels it went through.
"""
from __future__ import annotations

import threading

import torch

launches = dict.fromkeys(("spmv_ell_batched", "cheby_step",
                          "cheby_smooth_zero", "cheby_prolong_step",
                          "restrict_residual", "similarity_mark", "spmv_ell",
                          "ssm_scan", "ssm_scan_bwd", "laplacian_residual",
                          "laplacian_residual_fold"), 0)
# wrappers may launch from several threads (a daemon's flusher beside the
# caller's flush): the read-modify-write of a count takes this lock
launches_lock = threading.Lock()


def count(name: str) -> None:
    with launches_lock:
        launches[name] += 1


def reset_launches() -> None:
    with launches_lock:
        for name in launches:
            launches[name] = 0


def on_cuda(*tensors) -> bool:
    """True when every operand lies on one CUDA device, False on the CPU;
    raises when they are spread over several devices."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"kernel operands on several devices: {devs}")
    return next(iter(devs)).type == "cuda"


def require(t, name: str, dtype, ndim: int):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def slabs(idx, val):
    """Check an ELL ``(idx, val)`` pair; returns its ``(n, L)``."""
    require(idx, "idx", torch.int32, 2)
    require(val, "val", torch.float32, 2)
    if idx.shape != val.shape:
        raise ValueError(f"idx {tuple(idx.shape)} != val {tuple(val.shape)}")
    return idx.shape


def ptr(t):
    return None if t is None else t.data_ptr()


def stream():
    return torch.cuda.current_stream().cuda_stream
