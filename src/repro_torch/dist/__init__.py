"""Distributed substrate of the port: gradient compression
(:mod:`~repro_torch.dist.compress`) and the parameters' sharding rules
(:mod:`~repro_torch.dist.sharding`)."""
from repro_torch.dist import compress, sharding  # noqa: F401
