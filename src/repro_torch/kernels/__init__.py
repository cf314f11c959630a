"""Hand-written CUDA kernels of the port (``csrc/*.cu``, built for sm_90a at
first use) and their plain PyTorch versions:

  vcycle_fused.py — K1 batched ELL spmv, K2 fused Chebyshev step, K3 fused
                    restrict+residual.
  similarity.py   — K4 strict-similarity marking pass of the recovery
                    rounds.
  spmv_ell.py     — K5 single-column ELL spmv and the host ELL slab layout
                    of a graph Laplacian.
  ssm_scan.py     — K6 fused Mamba1 selective scan and K6b its gradient
                    (``SsmScan``: every Mamba layer's scan, serving and
                    training), operators ``torch.ops.repro_torch.ssm_scan``
                    and ``ssm_scan_bwd`` with shape-only forms on
                    ``meta``.
  laplacian_residual.py — K7 the float64 residual of the service's
                    refinement and its column norms over a graph's CSR.
  ref.py          — the plain version of each kernel.
  _launch.py      — operand checks, the CUDA stream and the launch counts
                    of all of them.
  ops.py          — public entry points; reads and resets the counts.
"""
