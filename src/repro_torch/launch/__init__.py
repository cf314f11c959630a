"""repro_torch.launch: where the port's work runs.

  * :mod:`repro_torch.launch.mesh` — :class:`Mesh` and :func:`make_mesh`,
    the named shard axes the distributed planes run over.
"""
from repro_torch.launch.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
