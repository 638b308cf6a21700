"""Meshes over the ranks of a ``torch.distributed`` process group.

Port of ``repro/launch/mesh.py``.  A mesh is a ``DeviceMesh``
(``torch.distributed.device_mesh``) with axis names ``("data", "model")``
(``("pod", "data", "model")`` for the multi-pod shape), built over an
initialised process group of exactly as many ranks as the mesh has
places.  Launch them with ``torch.multiprocessing`` (``spawn``) or
``torchrun --nproc-per-node N``, each process calling
``torch.distributed.init_process_group`` first; ``launch/serve.py --mesh``
does this.  A mesh of one place needs no launcher: if no group exists,
:func:`make_host_mesh` starts a world-size-1 gloo group in this process.

The reference's ``distributed/compat.py`` (a shim over JAX's mesh and
shard_map APIs) has no counterpart here.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch.distributed as dist


class Mesh:
    """A named grid of ranks: ``axis_names``, ``shape[name]``, this rank's
    ``coords[name]`` and each axis's process group."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              device_mesh.mesh.shape))
        self.coords: Dict[str, int] = {
            a: int(device_mesh.get_local_rank(a)) for a in self.axis_names}

    def group(self, axis):
        """The process group along ``axis``: a name, or a tuple of names
        whose ranks are taken together (the batch axes ``("pod",
        "data")``).  Collective the first time a tuple of several axes is
        asked for."""
        if isinstance(axis, tuple):
            if len(axis) > 1:
                return self.device_mesh[axis]._flatten().get_group()
            axis = axis[0]
        return self.device_mesh.get_group(axis)


def _require_ranks(shape: Sequence[int], axes: Sequence[str]) -> None:
    """Raise unless the default process group has exactly ``prod(shape)``
    ranks, with the fix spelled out; with no group and a mesh of one
    place, start a world-size-1 gloo group here."""
    n = math.prod(shape)
    if not dist.is_initialized() and n == 1:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != n:
        req = "×".join(f"{a}={s}" for a, s in zip(axes, shape))
        raise ValueError(
            f"mesh ({req}) needs {n} ranks but the process group has "
            f"{have}" + ("" if dist.is_initialized() else
                         " (no process group is initialised)")
            + f"; shrink the mesh or launch {n} processes "
            f"(torch.multiprocessing spawn, or torchrun --nproc-per-node "
            f"{n}), each calling torch.distributed.init_process_group "
            f"before building the mesh")


def _make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh
    _require_ranks(shape, axes)
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(init_device_mesh(device, shape, mesh_dim_names=axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's pod shapes: 16×16 = 256 ranks; multi-pod adds a
    leading pod axis of 2."""
    if multi_pod:
        return _make_mesh((2, 16, 16), ("pod", "data", "model"))
    return _make_mesh((16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small ``(data, model)`` mesh: tests, examples, sharded serving."""
    return _make_mesh((data, model), ("data", "model"))


def batch_axes(mesh) -> tuple:
    """Axes a global batch splits over (pod and data where present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def fsdp_axes(mesh) -> tuple:
    """Axes FSDP parameter sharding uses at training time."""
    return batch_axes(mesh)
