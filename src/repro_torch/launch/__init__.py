"""repro_torch.launch: where the port's work runs, and what it costs.

  * :mod:`repro_torch.launch.mesh` — :class:`Mesh` and :func:`make_mesh`,
    the named shard axes the distributed planes run over.
  * :mod:`repro_torch.launch.roofline` — the H100's peaks, the
    reference's byte/flop models of the solver, and each kernel's launch
    bound.
"""
from repro_torch.launch.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
