"""The installed device mesh (the port of ``repro/meshctx.py``).

The reference's model code asks this module for the mesh GSPMD shards
over.  The port runs each rank's local shards eagerly, so its model code
asks it which process group to reduce over and which coordinate this rank
holds: on the "model" axis (:func:`model_axis`, tensor and expert
parallelism) and on the data axes (:func:`data_axis`, the batch rows, FSDP
and the MoE dispatch over data shards).  With no mesh installed, or an
axis of size 1, nothing is sharded on it and every layer runs as on one
device.

The mesh is any object whose ``shape`` is a ``{axis name: size}`` dict, as
the reference reads its ``jax.sharding.Mesh``; a mesh that runs collectives
also has ``group(axis)`` and ``coord(axis)`` (``launch/mesh.py``'s
:class:`~repro_torch.launch.mesh.LocalMesh`).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

_MESH: Optional[Any] = None

# The mesh axes a batch's rows are sharded over (``repro/distributed/
# sharding.py:30``), outermost first.
DATA_AXES = ("pod", "data")


def set_mesh(mesh: Optional[Any]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Any]:
    return _MESH


class ModelAxis(NamedTuple):
    group: Any          # the axis's process group
    size: int
    coord: int          # this rank's coordinate on the axis


def model_axis() -> Optional[ModelAxis]:
    """The installed mesh's "model" axis, or None when no mesh is installed
    or the axis has size 1 (nothing is sharded)."""
    if _MESH is None or _MESH.shape.get("model", 1) == 1:
        return None
    return ModelAxis(_MESH.group("model"), _MESH.shape["model"],
                     _MESH.coord("model"))


def data_axis() -> Optional[ModelAxis]:
    """The installed mesh's data axes ("pod", "data") as one axis: its
    group, its size (the product) and this rank's coordinate (row-major),
    or None when no mesh is installed or the product is 1.  A mesh that
    spans more than one of them must answer ``group`` for the tuple of
    their names."""
    if _MESH is None:
        return None
    busy = tuple(a for a in DATA_AXES if _MESH.shape.get(a, 1) > 1)
    if not busy:
        return None
    size, coord = 1, 0
    for a in busy:
        size *= _MESH.shape[a]
        coord = coord * _MESH.shape[a] + _MESH.coord(a)
    return ModelAxis(_MESH.group(busy[0] if len(busy) == 1 else busy),
                     size, coord)


def constrain(x, *parts):
    """The reference's activation sharding constraint
    (``repro/meshctx.py:30-51``), the identity here.  Under GSPMD it pins
    the layout a global array takes between ops; the port's tensors are
    already each rank's eager local block (its rows of the batch, its heads
    and experts), which is the layout the constraint would pin, so there
    is nothing to move."""
    return x
