"""Fused Mamba1 selective scan (K6) and its gradient (K6b) for the H100.

The port of ``repro.kernels.ssm_scan``.  :func:`ssm_scan` launches the
hand-written CUDA kernel (``kernels/csrc/ssm_scan.cu``) when its tensors lie
on a CUDA device and runs the plain version
(:func:`repro_torch.kernels.ref.ssm_scan_ref`) when they lie on the CPU.
:func:`ssm_scan_bwd` is its gradient, K6b (``kernels/csrc/ssm_scan_bwd.cu``,
plain version :func:`repro_torch.kernels.ref.ssm_scan_bwd_ref`), which the
reference has no kernel for: it differentiates its ``lax.scan``.  K6b
keeps the state only every :func:`run_length` steps and recomputes the
states between as it walks back, so its scratch is a small part of a
stack of every state (3.36 GB at hymba-1.5b's training shape).
:class:`SsmScan` joins the two into an autograd function, which every
Mamba layer's scan runs through (:func:`repro_torch.models.layers.mamba_scan`),
serving and training, on both routes.  Each launch adds one to its count
in :data:`repro_torch.kernels._launch.launches`.

Both are operators of their own, ``torch.ops.repro_torch.ssm_scan`` and
``torch.ops.repro_torch.ssm_scan_bwd`` (``torch.library.custom_op``), so
the tensor's device still picks the route (a CUDA tensor: the kernel or
an error; a CPU tensor: the plain version) and a ``meta`` tensor takes
each operator's shape-only form, which gives the outputs' shapes and
types and computes nothing: a model traced on ``meta`` (the dry run,
:mod:`repro_torch.launch.dryrun`) does not run the plain version's loop
over the steps.  Each operator's operations and bytes are those of its
launch model (:func:`scan_launch_cost`, :func:`scan_bwd_launch_cost`:
``launch/roofline.py`` ``ssm_scan_launch``, ``ssm_scan_bwd_launch``),
registered as its formula with ``torch.utils.flop_counter`` and read by
the dry run's cost counter (:mod:`repro_torch.launch.hlo_costs`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._launch import count, on_cuda, require, stream
from repro_torch.launch import roofline as _roofline

STATES = (4, 8, 16)   # the CUDA kernel's template instances


def _check_shapes(x1, dt, Bm, Cm, A, h0):
    """Raise ``ValueError`` unless the operands' shapes fit one another and
    a kernel instance; returns ``(B, S, di, state)``."""
    for t, name in ((x1, "x1"), (dt, "dt"), (Bm, "Bm"), (Cm, "Cm"),
                    (h0, "h0")):
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-D, got shape "
                             f"{tuple(t.shape)}")
    if A.dim() != 2:
        raise ValueError(f"A must be 2-D, got shape {tuple(A.shape)}")
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
    return B, S, di, state


def _io_operands(x1, dt, Bm, Cm, A, h0):
    """The operands as the kernels take them: x1, dt, Bm, Cm all bf16 when
    all four are (the serving and training paths'), else float32; x1 and
    dt contiguous, Bm and Cm with unit stride over the state (strided
    views of ``x_proj``'s output pass as they are); A and h0 float32.
    Checks shapes and the state; returns the operands and the io type."""
    _check_shapes(x1, dt, Bm, Cm, A, h0)
    io = (torch.bfloat16 if all(t.dtype == torch.bfloat16
                                for t in (x1, dt, Bm, Cm))
          else torch.float32)
    x1, dt = (t.to(io).contiguous() for t in (x1, dt))
    # the kernels read B and C through their batch and step strides
    Bm, Cm = (t.to(io) if t.stride(2) == 1 else t.to(io).contiguous()
              for t in (Bm, Cm))
    A, h0 = (t.float().contiguous() for t in (A, h0))
    for t, name, dtype, ndim in ((x1, "x1", io, 3), (dt, "dt", io, 3),
                                 (A, "A", torch.float32, 2),
                                 (h0, "h0", torch.float32, 3)):
        require(t, name, dtype, ndim)
    return (x1, dt, Bm, Cm, A, h0), io


def _io_bytes(x1, dt, Bm, Cm) -> int:
    """The bytes a value of x1, dt, Bm and Cm takes in the kernels: 2 when
    all four are bf16, else 4 (:func:`_io_operands` casts to float32)."""
    return 2 if all(t.dtype == torch.bfloat16
                    for t in (x1, dt, Bm, Cm)) else 4


def scan_launch_cost(x1, dt, Bm, Cm, A, h0) -> Tuple[int, int]:
    """``(bytes, operations)`` of one K6 call on these operands (any
    device, ``meta`` too): ``roofline.ssm_scan_launch``."""
    B, S, di, state = _check_shapes(x1, dt, Bm, Cm, A, h0)
    io = _io_bytes(x1, dt, Bm, Cm)
    return _roofline.ssm_scan_launch(B, S, di, state, io, io)


def scan_bwd_launch_cost(x1, dt, Bm, Cm, A, h0, dy, dhT=None
                         ) -> Tuple[int, int]:
    """``(bytes, operations)`` of one K6b call on these operands:
    ``roofline.ssm_scan_bwd_launch``."""
    B, S, di, state = _check_shapes(x1, dt, Bm, Cm, A, h0)
    io = _io_bytes(x1, dt, Bm, Cm)
    return _roofline.ssm_scan_bwd_launch(B, S, di, state, io, io)


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
    slices of the ``x_proj`` output are: no copy is made.  On ``meta``
    tensors only the outputs' shapes exist."""
    return torch.ops.repro_torch.ssm_scan(x1, dt, Bm, Cm, A, h0)


@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=())
def _ssm_scan_op(x1: Tensor, dt: Tensor, Bm: Tensor, Cm: Tensor, A: Tensor,
                 h0: Tensor) -> Tuple[Tensor, Tensor]:
    if not on_cuda(x1, dt, Bm, Cm, A, h0):
        return _ref.ssm_scan_ref(x1, dt, Bm, Cm, A, h0)
    from repro_torch.kernels._build import check, library

    (x1, dt, Bm, Cm, A, h0), io = _io_operands(x1, dt, Bm, Cm, A, h0)
    B, S, di = x1.shape
    state = A.shape[1]
    y = torch.empty((B, S, di), dtype=torch.float32, device=x1.device)
    hT = torch.empty((B, di, state), dtype=torch.float32, device=x1.device)
    check(library().repro_ssm_scan(
        x1.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
        A.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(), B, S, di,
        state, int(io == torch.bfloat16), stream()), "ssm_scan")
    count("ssm_scan")
    return y, hT


@_ssm_scan_op.register_fake
def _ssm_scan_fake(x1, dt, Bm, Cm, A, h0):
    B, S, di, state = _check_shapes(x1, dt, Bm, Cm, A, h0)
    return (x1.new_empty((B, S, di), dtype=torch.float32),
            x1.new_empty((B, di, state), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssm_scan)
def _ssm_scan_flops(x1, dt, Bm, Cm, A, h0, out_shape=None, **kwargs) -> int:
    B, S, di = x1
    return _roofline.ssm_scan_launch(B, S, di, A[1], 2, 2)[1]


def run_length() -> int:
    """K6b's run length, the steps between two of its checkpoints: the
    library's (``kRun`` in ``csrc/ssm_scan_bwd.cu``), which builds it on
    first use."""
    from repro_torch.kernels._build import library

    return library().repro_ssm_scan_bwd_run()


def ssm_scan_bwd(x1, dt, Bm, Cm, A, h0, dy, dhT=None):
    """K6b: the gradient of :func:`ssm_scan`.  Takes its inputs (as
    :func:`ssm_scan` takes them), ``dy [B, S, di]`` and ``dhT [B, di,
    state]`` (None: zeros); returns ``(dx1, ddt, dBm, dCm, dA, dh0)``,
    float32, each in its input's shape.

    On the card one call is three launches (the checkpoints, the reverse
    scan and the fixed-order reduction of its partial sums; counted once
    as ``ssm_scan_bwd``).  Its float32 scratch, freed on return: the
    state every R = :func:`run_length` steps, ``[B, ceil(S / R) - 1,
    state, di]`` (the reverse pass recomputes the states between from
    them), and the partial sums ``[B, S, ceil(di / 32), 2 state]`` and
    ``[B, di, state]``: 0.42 GB at hymba-1.5b's training shape
    (``launch/roofline.py`` ``ssm_scan_bwd_checkpoint_bytes``,
    ``ssm_scan_bwd_partial_bytes``).
    Bitwise equal to :func:`repro_torch.kernels.ref.ssm_scan_bwd_ref`,
    which runs on CPU tensors.  On ``meta`` tensors only the outputs'
    shapes exist."""
    return torch.ops.repro_torch.ssm_scan_bwd(x1, dt, Bm, Cm, A, h0, dy, dhT)


@torch.library.custom_op("repro_torch::ssm_scan_bwd", mutates_args=())
def _ssm_scan_bwd_op(x1: Tensor, dt: Tensor, Bm: Tensor, Cm: Tensor,
                     A: Tensor, h0: Tensor, dy: Tensor,
                     dhT: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor,
                                                     Tensor, Tensor, Tensor]:
    if not on_cuda(x1, dt, Bm, Cm, A, h0, dy, dhT):
        return _ref.ssm_scan_bwd_ref(x1, dt, Bm, Cm, A, h0, dy, dhT)
    from repro_torch.kernels._build import check, library

    (x1, dt, Bm, Cm, A, h0), io = _io_operands(x1, dt, Bm, Cm, A, h0)
    B, S, di = x1.shape
    state = A.shape[1]
    dy = dy.float().contiguous()
    gT = (torch.zeros_like(h0) if dhT is None
          else dhT.float().contiguous())
    for t, name, shape in ((dy, "dy", (B, S, di)),
                           (gT, "dhT", (B, di, state))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shape}")

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x1.device)

    nw, run = -(-di // 32), run_length()
    ck, part_bc, part_a = (f32(B, max(0, -(-S // run) - 1), state, di),
                           f32(B, S, nw, 2 * state), f32(B, di, state))
    dx, ddt, dB, dC = f32(B, S, di), f32(B, S, di), f32(B, S, state), \
        f32(B, S, state)
    dA, dh0 = f32(di, state), f32(B, di, state)
    check(library().repro_ssm_scan_bwd(
        x1.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
        A.data_ptr(), h0.data_ptr(), dy.data_ptr(), gT.data_ptr(),
        ck.data_ptr(), dx.data_ptr(), ddt.data_ptr(), part_bc.data_ptr(),
        part_a.data_ptr(), dh0.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dA.data_ptr(), B, S, di, state, int(io == torch.bfloat16),
        stream()), "ssm_scan_bwd")
    count("ssm_scan_bwd")
    return dx, ddt, dB, dC, dA, dh0


@_ssm_scan_bwd_op.register_fake
def _ssm_scan_bwd_fake(x1, dt, Bm, Cm, A, h0, dy, dhT):
    _check_shapes(x1, dt, Bm, Cm, A, h0)
    return tuple(t.new_empty(t.shape, dtype=torch.float32)
                 for t in (x1, dt, Bm, Cm, A, h0))


@register_flop_formula(torch.ops.repro_torch.ssm_scan_bwd)
def _ssm_scan_bwd_flops(x1, dt, Bm, Cm, A, h0, dy, dhT, out_shape=None,
                        **kwargs) -> int:
    B, S, di = x1
    return _roofline.ssm_scan_bwd_launch(B, S, di, A[1], 2, 2)[1]


class SsmScan(torch.autograd.Function):
    """``(y, hT) = ssm_scan(x1, dt, Bm, Cm, A, h0)`` with its gradient:
    K6 forward and K6b backward on CUDA tensors, the plain versions on CPU
    tensors.  Saves only the inputs (K6b recomputes the states); the
    gradients come back in each input's own dtype and shape (``Bm`` and
    ``Cm`` may be strided views)."""

    @staticmethod
    def forward(ctx, x1, dt, Bm, Cm, A, h0):
        ctx.save_for_backward(x1, dt, Bm, Cm, A, h0)
        return ssm_scan(x1, dt, Bm, Cm, A, h0)

    @staticmethod
    def backward(ctx, dy, dhT):
        ins = ctx.saved_tensors
        grads = ssm_scan_bwd(*ins, dy, dhT)
        return tuple(g.to(t.dtype) for g, t in zip(grads, ins))
