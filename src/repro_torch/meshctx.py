"""The installed device mesh (the port of ``repro/meshctx.py``).

The reference's model code asks this module for the mesh GSPMD shards
over.  The port runs each rank's local shards eagerly, so its model code
asks it which process group to reduce over and which coordinate this rank
holds on the "model" axis (:func:`model_axis`); with no mesh installed, or
a "model" axis of size 1, every layer runs unsharded, exactly as before.

The mesh is any object whose ``shape`` is a ``{axis name: size}`` dict, as
the reference reads its ``jax.sharding.Mesh``; a mesh that runs collectives
also has ``group(axis)`` and ``coord(axis)`` (``launch/mesh.py``'s
:class:`~repro_torch.launch.mesh.LocalMesh`).  The reference's ``constrain``
(activation sharding constraints under GSPMD) belongs to the data axis and
is not ported here (ROADMAP A5b).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

_MESH: Optional[Any] = None


def set_mesh(mesh: Optional[Any]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Any]:
    return _MESH


class ModelAxis(NamedTuple):
    group: Any          # the "model" axis's process group
    size: int
    coord: int          # this rank's coordinate on the axis


def model_axis() -> Optional[ModelAxis]:
    """The installed mesh's "model" axis, or None when no mesh is installed
    or the axis has size 1 (nothing is sharded)."""
    if _MESH is None or _MESH.shape.get("model", 1) == 1:
        return None
    return ModelAxis(_MESH.group("model"), _MESH.shape["model"],
                     _MESH.coord("model"))
