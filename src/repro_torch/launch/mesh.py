"""Meshes: devices for the node axis, ranks for the models.

The port of the JAX package's ``launch/mesh.py``.  Two kinds of mesh
live here, each built by a function, so that importing this module
touches no device and starts no process group:

* ``make_test_mesh`` gives the node-axis engines
  (``core/distributed.py``) a :class:`~repro_torch.core.distributed.
  DeviceMesh`: ``torch.device``s on the axes ``("data", "model")``,
  stepped in turn by one controller (one process), a device possibly
  repeated;
* ``make_rank_mesh``, ``make_production_mesh`` and ``mesh_rules`` give
  the language models (``models/sharding.py``) a
  ``torch.distributed.device_mesh.DeviceMesh`` of *ranks*, one process
  a mesh place and one card a rank, JAX's mesh for ``shard_map`` and
  GSPMD.  ``init_ranks`` sets up the process group they need, in one
  place: NCCL on the cards, gloo on the CPU.

Production shapes: ``(16, 16)`` on ``("data", "model")`` (one pod of
256), ``(2, 16, 16)`` on ``("pod", "data", "model")`` (512).
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.distributed import DeviceMesh, grid_mesh

__all__ = ["make_test_mesh", "production_shape", "check_cards", "init_ranks",
           "make_rank_mesh", "make_production_mesh", "mesh_rules"]

# a group on the cards also takes host tensors (through gloo)
_BACKENDS = {"cuda": "cpu:gloo,cuda:nccl", "cpu": "gloo"}


def make_test_mesh(data: int = 1, model: int = 1, *, kind: str = "cuda",
                   repeat: bool = False) -> DeviceMesh:
    """A node-axis ``(data, model)`` mesh over the first ``data * model``
    devices of ``kind``.  Asking for more than the process sees raises,
    unless ``repeat``: then every place of the mesh holds the first
    device (the real per-shard launches and halo copies, on one
    device)."""
    if data < 1 or model < 1:
        raise ValueError(f"need data, model >= 1, got {data} x {model}")
    try:
        devs = grid_mesh(data * model, kind=kind)
    except ValueError:
        if not repeat:
            raise
        first = resolve_device(kind)
        devs = (torch.device(first.type, 0) if first.type == "cuda"
                else first,) * (data * model)
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return DeviceMesh(grid.reshape(data, model), ("data", "model"))


def production_shape(*, multi_pod: bool = False):
    """``(shape, axis names)`` of JAX's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def check_cards(device: str, ranks: int) -> None:
    """One card a rank: fewer visible cards than ranks raise (NCCL refuses
    two ranks on one card, and nothing falls back to gloo or the CPU)."""
    if torch.device(device).type != "cuda":
        return
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < ranks:
        raise RuntimeError(
            f"{ranks} ranks on device 'cuda' need {ranks} cards, one a rank; "
            f"this process sees {seen}")


def init_ranks(device: str = "cuda", *, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               init_method: Optional[str] = None) -> torch.device:
    """Join (or start) the default process group and return this rank's
    device.  ``rank`` / ``world_size`` / ``init_method`` (a ``file://``
    store, for instance) where given, else ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT``).  The backend is NCCL for ``cuda``
    (with gloo beside it for host tensors) and gloo for ``cpu``; on
    ``cuda`` rank ``r`` of a host takes card
    ``LOCAL_RANK`` (``r`` without torchrun), and a host with fewer cards
    than its ranks raises.  A group already started must have the same
    world size."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", rank))
    check_cards(dev.type, int(os.environ.get("LOCAL_WORLD_SIZE",
                                              world_size)))
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"the process group has {dist.get_world_size()}"
                               f" ranks, not {world_size}")
        return dev
    if init_method is None and "MASTER_ADDR" not in os.environ:
        raise ValueError("no init_method and no torchrun environment "
                         "(MASTER_ADDR): pass init_method='file://...'")
    dist.init_process_group(_BACKENDS[dev.type],
                            init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return dev


def make_rank_mesh(shape: Sequence[int], axis_names: Sequence[str],
                   device: str = "cuda"):
    """A ``DeviceMesh`` of ranks of ``shape`` on ``axis_names`` over the
    started process group (:func:`init_ranks`), whose world size must be
    the mesh's size: a different one raises, naming both."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(f"a {tuple(shape)} mesh needs {need} ranks; the "
                           f"process group has {have}")
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """JAX's production mesh as a rank mesh: 256 (or 512) ranks."""
    shape, axes = production_shape(multi_pod=multi_pod)
    return make_rank_mesh(shape, axes, device)


def mesh_rules(mesh):
    """``MeshRules`` bound to this mesh: fsdp over (pod,)data, tp over
    model (a ``DeviceMesh`` or a ``models.sharding.MeshShape``)."""
    from ..models.sharding import MeshRules, mesh_sizes
    fsdp = ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)
    return MeshRules(mesh=mesh, fsdp=fsdp, tp=("model",))
