"""Meshes of process ranks (``repro.launch.mesh``).

A :class:`Mesh` holds axis names, their sizes and the grid of global
ranks (row-major by default), the port's stand-in for a ``jax`` mesh of
devices: one process a rank.  Building one touches no process group;
``mesh_groups`` makes the process groups of its slices and
``rank_groups`` a rank's data and model groups (tensor parallelism).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch.distributed as dist


class Mesh:
    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d grid for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int) -> Dict[str, int]:
        """The position of global ``rank`` along each axis."""
        where = np.argwhere(self.devices == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in the mesh")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """Ranks 0..prod(shape)-1 laid out row-major."""
    return Mesh(np.arange(int(np.prod(shape))).reshape(tuple(shape)), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 ("data", "model") for one pod, 2x16x16 ("pod", "data",
    "model") for two: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_debug_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    """A small mesh for tests."""
    return make_mesh(shape, axes)


def data_axes_of(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def slices(mesh, axes: Sequence[str]) -> Tuple[Tuple[int, ...], ...]:
    """The ranks of each slice of ``mesh`` along ``axes`` (the other axes
    fixed), each in the slice's row-major order over ``axes``."""
    axes = tuple(axes)
    keep = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.axis_names)) if i not in keep]
    grid = np.transpose(mesh.devices, rest + keep)
    grid = grid.reshape(-1, int(np.prod([mesh.devices.shape[i]
                                         for i in keep])))
    return tuple(tuple(int(r) for r in row) for row in grid)


def mesh_groups(mesh, axes: Sequence[str]):
    """{slice ranks: process group} for every slice along ``axes``.

    ``dist.new_group`` is collective over the default group, so every
    rank must call this, for the same slices, before the first step.  A
    slice that is the whole default group maps to ``None`` (the default
    group itself).  A group's ranks take their order from the global
    ranks, which must then be the slice's order."""
    world = dist.get_world_size()
    out = {}
    for ranks in slices(mesh, axes):
        if list(ranks) != sorted(ranks):
            raise ValueError(f"slice {ranks} is not in rank order")
        out[ranks] = None if len(ranks) == world and \
            ranks == tuple(range(world)) else dist.new_group(list(ranks))
    return out


def rank_groups(mesh, data_axes: Sequence[str], model_axis: str):
    """(data group, model group) of this rank: the ranks that share its
    model coordinate, laid out over ``data_axes``, and the ranks that share
    its data coordinates, along ``model_axis``.  Every slice's group of
    both kinds is made (``mesh_groups``), so every rank must call this
    before the first step."""
    rank = dist.get_rank()
    out = []
    for axes in (tuple(data_axes), (model_axis,)):
        groups = mesh_groups(mesh, axes)
        out.append(next(g for ranks, g in groups.items() if rank in ranks))
    return tuple(out)
