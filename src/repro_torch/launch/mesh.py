"""Meshes with the JAX package's axis names (``launch/mesh.py`` there):
functions, never module-level constants, so importing this module touches
no device and no process group.

  single-pod : (16, 16)      axes ("data", "model")
  multi-pod  : (2, 16, 16)   axes ("pod", "data", "model")

"data" carries DP + FSDP, "model" TP + EP, "pod" the paper's channels
(data parallel plus the partitioner's split). A mesh of more than one
device is a ``torch.distributed.device_mesh.DeviceMesh`` and needs the
default process group (the caller's ``init_process_group``); a world of 1
needs no launcher: :func:`make_local_mesh` returns a :class:`LocalMesh`
with the same interface and no process group, and :class:`MeshShape` is a
mesh of any shape with no devices at all (the spec rules of
``launch/shardings.py`` read only names and sizes). The partitioned train
step and the sharded serving path read the axes through :func:`axis_size`,
:func:`axis_rank` and :func:`axis_group` on any kind: an axis of size 1
has rank 0 and no group, so its collectives are skipped.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

__all__ = ["LocalMesh", "MeshShape", "make_local_mesh", "make_mesh",
           "make_production_mesh", "batch_axes", "axis_size", "axis_rank",
           "axis_group"]


@dataclass(frozen=True)
class LocalMesh:
    """A mesh of one device: every axis has size 1 (the part of a
    ``DeviceMesh``'s interface that the port reads: its axis names and
    shape; :func:`axis_rank` and :func:`axis_group` need no more)."""

    mesh_dim_names: Tuple[str, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return (1,) * len(self.mesh_dim_names)


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes with no devices behind them: the
    production meshes' shapes for the spec rules, in tests and planning."""

    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def make_local_mesh(axes: Tuple[str, ...] = ("data", "model")) -> LocalMesh:
    """The one-device mesh with production axis names (the CPU tests, one
    card)."""
    return LocalMesh(tuple(axes))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group, whose
    world size must be the product of ``shape``."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that shard the batch dimension (everything but TP)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def axis_size(mesh, axis) -> int:
    """The size of ``axis``; 1 for None or an axis the mesh lacks."""
    names = tuple(mesh.mesh_dim_names)
    return mesh.shape[names.index(axis)] if axis in names else 1


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis) if axis_size(mesh, axis) > 1 else 0


def axis_group(mesh, axis: str):
    """The process group along ``axis``, or None when it has size 1."""
    return mesh.get_group(axis) if axis_size(mesh, axis) > 1 else None
