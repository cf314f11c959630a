"""Meshes of shards for the distributed planes.

The port of ``repro.launch.mesh.compat_make_mesh``.  A :class:`Mesh` names
its shard axes and their sizes, as ``jax.sharding.Mesh`` does, so code
reads ``mesh.shape[axis]`` as the reference does.  It is single-controller,
as the reference's is: one process drives every shard.

Every shard of a mesh lives on one device.  The shards exchange data only
through :mod:`repro_torch.core.collectives`, so a transport across cards
can take their place later without touching the algorithms (ROADMAP
queue 1, "mesh across cards").  The reference's ``make_production_mesh``
and ``make_mesh_for`` encode a TPU pod's topology; they wait for the
launch slice (ROADMAP queue 1, "Launch tools").
"""
from __future__ import annotations

import math
import types
from typing import Mapping, Sequence, Tuple

import torch


class Mesh:
    """Named shard axes over one device.

    Attributes:
      axis_names: the axis names, in order.
      shape:      read-only ``{axis name: size}`` mapping.
      device:     the device every shard lives on.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(str(a) for a in axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} differ in length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axes need at least one shard: {shape}")
        self.axis_names: Tuple[str, ...] = axis_names
        self.shape: Mapping[str, int] = types.MappingProxyType(
            dict(zip(axis_names, shape)))
        self.device = torch.device(device)

    @property
    def size(self) -> int:
        """The number of shards over every axis."""
        return math.prod(self.shape.values())

    def check_device(self, device, what: str) -> None:
        """Raise ``ValueError`` unless ``what`` (a problem, a graph, a
        solver) lies on the mesh's kind of device."""
        if torch.device(device).type != self.device.type:
            raise ValueError(f"{what} lies on {device}, the mesh's shards on "
                             f"{self.device}")

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, device={str(self.device)!r})")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device="cuda") -> Mesh:
    """A :class:`Mesh` of ``shape`` shards named ``axes`` on ``device``.

    ``device`` is one device, or a sequence of devices with one entry;
    shards over several devices raise ``ValueError``."""
    if isinstance(device, (list, tuple)):
        devs = {torch.device(d) for d in device}
        if len(devs) != 1:
            raise ValueError(
                f"a mesh over the devices {sorted(map(str, devs))} needs a "
                f"transport between cards, which is not ported (ROADMAP "
                f"queue 1, 'mesh across cards'); every shard must live on "
                f"one device")
        device = devs.pop()
    return Mesh(shape, axes, device)
