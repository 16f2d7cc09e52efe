"""Meshes of devices for the node-axis engines.

The port of the JAX package's ``launch/mesh.py::make_test_mesh``: a
function, so importing this module touches no device.  A mesh is a
:class:`~repro_torch.core.distributed.DeviceMesh` with the axes
``("data", "model")``: contracts split over ``data``, each contract's
tree over ``model``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.distributed import DeviceMesh, grid_mesh

__all__ = ["make_test_mesh"]


def make_test_mesh(data: int = 1, model: int = 1, *, kind: str = "cuda",
                   repeat: bool = False) -> DeviceMesh:
    """A ``(data, model)`` mesh over the first ``data * model`` devices of
    ``kind``.  Asking for more than the process sees raises, unless
    ``repeat``: then every place of the mesh holds the first device (the
    real per-shard launches and halo copies, on one device)."""
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
