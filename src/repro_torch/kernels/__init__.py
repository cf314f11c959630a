"""Hand-written CUDA kernels of the port (``csrc/*.cu``, built for sm_90a at
first use) and their plain PyTorch versions:

  vcycle_fused.py — K1 batched ELL spmv, K2 fused Chebyshev step, K3 fused
                    restrict+residual, with their launch counts.
  ref.py          — the plain version of each kernel.
  spmv_ell.py     — host ELL slab layout of a graph Laplacian.
"""
