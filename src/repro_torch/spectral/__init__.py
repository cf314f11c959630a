"""Spectral graph services — batched workloads on top of the solver plane.

The port of ``repro.spectral``.  The sparsifier's job is the downstream
tasks it accelerates; this package hosts those tasks as thin, batched
consumers of :class:`~repro_torch.solver.service.SolverService` /
:class:`~repro_torch.serve.solver_daemon.SolverDaemon`:

  * :mod:`repro_torch.spectral.resistance` — batched effective-resistance
    queries with a content-keyed cache, plus the exact off-tree
    resistances behind the ``score: er_exact`` pipeline stage.
  * :mod:`repro_torch.spectral.embedding`  — Fiedler vectors and
    k-dimensional spectral embeddings by V-cycle-preconditioned block
    inverse iteration.
  * :mod:`repro_torch.spectral.harmonic`   — harmonic interpolation /
    label propagation via an interior/boundary split of ``DeviceGraph``.

Every endpoint emits ``spectral.*`` spans and metrics into the shared
telemetry plane, so service ``stats()`` and exported traces cover these
workloads with no extra wiring.  The solves run on the card unless the
caller asks for the CPU (a service made with ``device="cpu"``, or
``device="cpu"`` on the service-free entry points).
"""
from repro_torch.spectral.embedding import (EmbeddingResult,  # noqa: F401
                                            fiedler_vector,
                                            spectral_embedding)
from repro_torch.spectral.harmonic import (HarmonicResult,  # noqa: F401
                                           harmonic_interpolate,
                                           label_propagation,
                                           make_harmonic_solver)
from repro_torch.spectral.resistance import (ResistanceCache,  # noqa: F401
                                             default_cache,
                                             effective_resistance,
                                             exact_offtree_resistances,
                                             pair_rhs,
                                             resistances_via_solver,
                                             tree_preconditioned_solver)

__all__ = [
    "EmbeddingResult", "fiedler_vector", "spectral_embedding",
    "HarmonicResult", "harmonic_interpolate", "label_propagation",
    "make_harmonic_solver",
    "ResistanceCache", "default_cache", "effective_resistance",
    "exact_offtree_resistances", "pair_rhs", "resistances_via_solver",
    "tree_preconditioned_solver",
]
