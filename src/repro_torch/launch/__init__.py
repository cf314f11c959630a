"""repro_torch.launch: where the port's work runs, and what it costs.

  * :mod:`repro_torch.launch.mesh` — :class:`Mesh`, :func:`make_mesh`,
    :func:`make_production_mesh` and :func:`make_mesh_for`, the named
    shard axes the distributed planes run over.
  * :mod:`repro_torch.launch.roofline` — the H100's peaks, the
    reference's byte/flop models of the solver, and each kernel's launch
    bound; the collective term and the inner recovery round's model.
  * :mod:`repro_torch.launch.dryrun_pdgrass` — the paper's production
    job, rounds of the inner engine at 2^25 off-tree rows on the
    production mesh.
  * :mod:`repro_torch.launch.shapes` — the LM dry run's four shapes, the
    skip rule, the inputs' stand-ins and each cell's step.
  * :mod:`repro_torch.launch.hlo_costs` — the cost counter (a
    ``TorchDispatchMode``; flops, bytes and calls of a step, on ``meta``
    too), its layer fold and the collectives of the placements in closed
    form.
  * :mod:`repro_torch.launch.dryrun` — every (arch x shape x mesh) cell
    counted on ``meta``, and a cell run for real on the card;
    :mod:`repro_torch.launch.perf_iter` — one cell beside a config
    variant.
"""
from repro_torch.launch.mesh import (Mesh, make_mesh, make_mesh_for,
                                     make_production_mesh)

__all__ = ["Mesh", "make_mesh", "make_mesh_for", "make_production_mesh"]
