"""Public kernel entry points of the port.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors (see :mod:`repro_torch.kernels._launch`).
Every kernel of the reference (K1-K6) has its CUDA counterpart; K6b, the
gradient of K6, is the port's own (the reference differentiates a scan),
and so is K7, the refinement's float64 residual (the reference measures it
on the host).

:func:`launch_counts` reads every kernel's launch count and
:func:`reset_launches` sets them all to zero, so a run can show which
kernels it went through.
"""
from __future__ import annotations

from repro_torch.kernels import _launch
from repro_torch.kernels import laplacian_residual as _residual
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import similarity as _similarity
from repro_torch.kernels import spmv_ell as _spmv_ell
from repro_torch.kernels import ssm_scan as _ssm_scan
from repro_torch.kernels._launch import reset_launches  # noqa: F401
from repro_torch.kernels.spmv_ell import to_ell  # noqa: F401
from repro_torch.kernels.vcycle_fused import (  # noqa: F401
    make_fused_chebyshev, make_fused_restrict_residual, spmv_ell_batched)


def launch_counts() -> dict:
    """``{kernel name: launches}`` over K1-K7 since the last reset."""
    with _launch.launches_lock:
        return dict(_launch.launches)


def similarity_mark(csu, csv, cbeta, cseg, esu, esv, eseg,
                    tile_m: int = 512):
    """K4 over any number of edge rows ``m``.

    ``tile_m`` is the reference's row tile (``ops.py:21``), which padded
    ``m`` to its multiple; here no row is padded, the CUDA kernel tiles by
    its thread block and the plain version by a memory bound, so the
    result does not depend on it."""
    if tile_m <= 0:
        raise ValueError(f"tile_m must be positive, got {tile_m}")
    return _similarity.similarity_mark(csu, csv, cbeta, cseg, esu, esv, eseg)


def spmv(idx, val, x):
    """K5: single-column ELL spmv ``[n] -> [n]``; any row count."""
    return _spmv_ell.spmv_ell(idx, val, x)


spmv_batched = spmv_ell_batched
ssm_scan = _ssm_scan.ssm_scan   # K6; any d_inner
ssm_scan_bwd = _ssm_scan.ssm_scan_bwd   # K6b, K6's gradient
laplacian_residual = _residual.laplacian_residual   # K7 and its fold
upload_csr = _residual.upload_csr
similarity_mark_ref = _ref.similarity_mark_ref
spmv_ref = _ref.spmv_ell_ref
spmv_batched_ref = _ref.spmv_ell_batched_ref
