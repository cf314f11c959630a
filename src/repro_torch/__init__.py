"""repro_torch: the PyTorch/CUDA port of the pdGRASS package ``repro``.

The subpackage layout mirrors ``repro`` module for module, so each
counterpart sits at the same path: ``core`` (graph substrate, spanning
tree, binary lifting, strict-similarity recovery), ``pipeline`` (the
staged sparsifier), ``kernels`` (hand-written CUDA kernels with their
plain PyTorch versions) and ``solver`` (the multilevel hierarchy and the
batched V-cycle PCG).  This package imports torch, numpy and scipy only.

Every entry point takes ``device=`` and defaults to ``"cuda"``; the CPU is
used only when the caller asks for it (``device="cpu"``).
"""
