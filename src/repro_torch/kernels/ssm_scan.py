"""Fused Mamba1 selective scan (K6) for the H100.

The port of ``repro.kernels.ssm_scan``.  :func:`ssm_scan` launches the
hand-written CUDA kernel (``kernels/csrc/ssm_scan.cu``) when its tensors lie
on a CUDA device and runs the plain version
(:func:`repro_torch.kernels.ref.ssm_scan_ref`) when they lie on the CPU.
Each launch adds one to its count in
:data:`repro_torch.kernels._launch.launches`.  It carries every Mamba
layer's prefill scan on the card (:func:`repro_torch.models.layers.mamba_scan`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._launch import count, on_cuda, require, stream

STATES = (4, 8, 16)   # the CUDA kernel's template instances


def ssm_scan(x1, dt, Bm, Cm, A, h0):
    """Fused selective scan.  Shapes: x1/dt ``[B, S, di]``; Bm/Cm
    ``[B, S, state]``; A ``[di, state]``; h0 ``[B, di, state]``, any float
    type.  Every input is cast to float32 first, as the reference's wrapper
    does.  Returns y ``[B, S, di]`` (before the D skip) and hT
    ``[B, di, state]``, float32.  Any ``di`` (no block-size multiple)."""
    if not on_cuda(x1, dt, Bm, Cm, A, h0):
        return _ref.ssm_scan_ref(x1, dt, Bm, Cm, A, h0)
    from repro_torch.kernels._build import check, library

    x1, dt, Bm, Cm, A, h0 = (t.float().contiguous()
                             for t in (x1, dt, Bm, Cm, A, h0))
    for t, name, ndim in ((x1, "x1", 3), (dt, "dt", 3), (Bm, "Bm", 3),
                          (Cm, "Cm", 3), (A, "A", 2), (h0, "h0", 3)):
        require(t, name, torch.float32, ndim)
    B, S, di = x1.shape
    state = A.shape[1]
    if state not in STATES:
        raise ValueError(f"state {state} has no kernel instance; "
                         f"the kernel takes {STATES}")
    if B == 0 or di == 0:
        raise ValueError(f"empty scan: batch {B}, d_inner {di}")
    want = {"dt": (dt, (B, S, di)), "Bm": (Bm, (B, S, state)),
            "Cm": (Cm, (B, S, state)), "A": (A, (di, state)),
            "h0": (h0, (B, di, state))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shape}")
    y = torch.empty((B, S, di), dtype=torch.float32, device=x1.device)
    hT = torch.empty((B, di, state), dtype=torch.float32, device=x1.device)
    check(library().repro_ssm_scan(
        x1.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        A.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(), B, S, di,
        state, stream()), "ssm_scan")
    count("ssm_scan")
    return y, hT
