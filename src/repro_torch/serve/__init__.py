"""repro_torch.serve: serving runtimes of the port.

  * :mod:`repro_torch.serve.engine`        — the LM batching engine
    (prefill, then one decode step a token), for the ``ssm`` family.
  * :mod:`repro_torch.serve.solver_daemon` — async Laplacian-solve
    runtime: a background flusher over
    :class:`~repro_torch.solver.service.SolverService` with deadline/size
    batching, multi-tenant fairness, and event-resolved tickets (no
    caller-side ``flush()``).
  * :mod:`repro_torch.serve.replay`        — deterministic open-loop
    traffic replay (seeded arrival schedules, p50/p99 latency reports)
    for the daemon against the sync-flush baseline.

Each name is imported on first use, so importing the LM engine does not
pull in the solver service, nor the daemon the LM model.
"""
import importlib

_HOME = {
    "Engine": "engine", "Request": "engine",
    "SolverDaemon": "solver_daemon", "TenantConfig": "solver_daemon",
    "DaemonShutdownError": "solver_daemon",
    "ReplayEvent": "replay", "ReplayReport": "replay",
    "make_schedule": "replay", "make_rhs": "replay",
    "replay_daemon": "replay", "replay_sync": "replay",
}

__all__ = list(_HOME)


def __getattr__(name):
    home = _HOME.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{home}"), name)
