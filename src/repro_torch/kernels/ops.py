"""Public kernel entry points of the port.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors (see :mod:`repro_torch.kernels.vcycle_fused`).
Kernels K4 (``similarity_mark``), K5 (single-column ``spmv``) and K6
(``ssm_scan``) of the reference are not ported yet.
"""
from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.spmv_ell import to_ell  # noqa: F401
from repro_torch.kernels.vcycle_fused import (  # noqa: F401
    launches, make_fused_chebyshev, make_fused_restrict_residual,
    reset_launches, spmv_ell_batched)

spmv_batched = spmv_ell_batched
spmv_batched_ref = _ref.spmv_ell_batched_ref
