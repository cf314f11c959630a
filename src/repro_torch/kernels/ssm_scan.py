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
    type.  The result is that of every input cast to float32 first, as the
    reference's wrapper does.  Returns y ``[B, S, di]`` (before the D skip)
    and hT ``[B, di, state]``, float32.  Any ``di`` (no block-size
    multiple).

    On the card the kernel reads x1, dt, Bm and Cm as they come when all
    four are bf16 (the serving path's) or all float32, converting in
    registers (exact); any other mix is cast to float32 first.  Bm and Cm
    may be strided views (unit stride over the state), as the model's
    slices of the ``x_proj`` output are: no copy is made."""
    if not on_cuda(x1, dt, Bm, Cm, A, h0):
        return _ref.ssm_scan_ref(x1, dt, Bm, Cm, A, h0)
    from repro_torch.kernels._build import check, library

    for t, name in ((Bm, "Bm"), (Cm, "Cm")):
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-D, got shape "
                             f"{tuple(t.shape)}")
    io = (torch.bfloat16 if all(t.dtype == torch.bfloat16
                                for t in (x1, dt, Bm, Cm))
          else torch.float32)
    x1, dt = (t.to(io).contiguous() for t in (x1, dt))
    # the kernel reads B and C through their batch and step strides
    Bm, Cm = (t.to(io) if t.stride(2) == 1 else t.to(io).contiguous()
              for t in (Bm, Cm))
    A, h0 = (t.float().contiguous() for t in (A, h0))
    for t, name, dtype, ndim in ((x1, "x1", io, 3), (dt, "dt", io, 3),
                                 (A, "A", torch.float32, 2),
                                 (h0, "h0", torch.float32, 3)):
        require(t, name, dtype, ndim)
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
        Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
        A.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(), B, S, di,
        state, int(io == torch.bfloat16), stream()), "ssm_scan")
    count("ssm_scan")
    return y, hT
