"""repro_torch.serve: serving runtimes of the port.

  * :mod:`repro_torch.serve.engine` — the LM batching engine (prefill,
    then one decode step a token), for the ``ssm`` family.

The solver daemon and traffic replay of ``repro.serve`` are not ported
yet (ROADMAP queue 1, item 6).
"""
from repro_torch.serve.engine import Engine, Request  # noqa: F401

__all__ = ["Engine", "Request"]
