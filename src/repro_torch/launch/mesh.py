"""Meshes of shards for the distributed planes.

The port of ``repro.launch.mesh.compat_make_mesh``.  A :class:`Mesh` names
its shard axes and their sizes, as ``jax.sharding.Mesh`` does, so code
reads ``mesh.shape[axis]`` as the reference does.  It is single-controller,
as the reference's is: one process drives every shard.

Every shard of a mesh lives on one device.  The shards exchange data only
through :mod:`repro_torch.core.collectives`, so a transport across cards
can take their place later without touching the algorithms (ROADMAP
queue 1, "mesh across cards").  :func:`make_production_mesh` and
:func:`make_mesh_for` take the reference's shapes, axis names and
halving loop: the production job's 256 or 512 shards, as shards on one
device.
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


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The production mesh: ``(16, 16)`` shards over ``("data", "model")``,
    or with ``multi_pod`` ``(2, 16, 16)`` over ``("pod", "data", "model")``
    (the reference's 256- and 512-chip meshes), on ``device``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_mesh_for(n_devices: int, model_par: int = None,
                  device="cuda") -> Mesh:
    """A ``(data, model)`` mesh of ``n_devices`` shards: ``model`` takes
    ``model_par`` shards (default ``min(16, n_devices)``), halved until it
    divides ``n_devices``, and ``data`` the rest."""
    if model_par is None:
        model_par = min(16, n_devices)
    while n_devices % model_par:
        model_par //= 2
    return make_mesh((n_devices // model_par, model_par),
                     ("data", "model"), device)
