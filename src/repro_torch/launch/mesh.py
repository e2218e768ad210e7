"""Mesh construction (port of ``repro/launch/mesh.py::make_mesh``).

A function, not a module constant, as in the reference, so importing
this module touches no device.  The mesh is the port's one mesh class,
``repro_torch.patterns.mesh.Mesh`` (a mesh of shards in one process),
with the reference's axis names.  The training step is single-device
(``repro_torch.sharding.umode``), so a mesh of more than one device
raises until LM sharding is ported (ROADMAP §1 item 6); the production
meshes of the reference (256 and 512 chips) wait for the same slice.
"""
from __future__ import annotations

import math

from repro_torch import resolve_device
from repro_torch.patterns.mesh import Mesh


def make_mesh(shape, axes, device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes`` on the first prod(shape) devices
    of ``device``'s type: one device for now."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    n = math.prod(shape)
    if n != 1:
        raise NotImplementedError(
            f"a mesh of {n} devices {dict(zip(axes, shape))}: the port "
            f"trains on one device until LM sharding is ported (ROADMAP "
            f"§1 item 6); pass a shape of ones")
    return Mesh([resolve_device(device)], axes=dict(zip(axes, shape)))
