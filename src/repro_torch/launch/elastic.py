"""Elastic scaling and failure handling: the control-plane contract.

The port of the JAX package's ``launch/elastic.py``:

  1. **Topology catalogue**: the meshes a job may run on, in order of
     preference.  ``pick_topology(devices)`` gives the largest catalogued
     shape that fits the healthy device count (lose a pod: (2, 16, 16) ->
     (16, 16); lose cards within a pod: (8, 16), ...); ``pick_mesh`` builds
     it as a rank mesh over the started process group, which must have
     exactly its ranks: the launcher restarts the job at the picked world
     size, and a group of another size raises rather than give a smaller
     mesh.
  2. **Elastic restore**: checkpoints hold whole logical arrays (the
     experts of a sharded MoE gathered), so a restore lays them out on
     whatever mesh was picked (``train/trainer.py``).
  3. **Straggler policy**: the trainer flags steps slower than ``factor``
     x the EWMA; the policy decides evict or tolerate and is where a
     deployment wires its scheduler's callback.
  4. **Batch rescaling**: the global batch is kept across re-meshes by
     recomputing the microbatching (``rescale_batch``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

__all__ = ["TOPOLOGY_CATALOGUE", "pick_mesh", "pick_topology",
           "StragglerPolicy", "rescale_batch"]

# (devices_required, mesh_shape, axis_names), in order of preference
TOPOLOGY_CATALOGUE: List[Tuple[int, Tuple[int, ...], Tuple[str, ...]]] = [
    (512, (2, 16, 16), ("pod", "data", "model")),
    (256, (16, 16), ("data", "model")),
    (128, (8, 16), ("data", "model")),
    (64, (4, 16), ("data", "model")),
    (16, (1, 16), ("data", "model")),
    (8, (2, 4), ("data", "model")),
    (4, (2, 2), ("data", "model")),
    (2, (2, 1), ("data", "model")),
    (1, (1, 1), ("data", "model")),
]


def pick_topology(healthy_devices: int):
    """Largest catalogued (shape, axes) that fits; raises if none does."""
    for need, shape, axes in TOPOLOGY_CATALOGUE:
        if healthy_devices >= need:
            return shape, axes
    raise RuntimeError("no catalogued topology fits 0 devices")


def pick_mesh(healthy_devices: int, device: str = "cuda"):
    """The largest catalogued mesh that fits the healthy devices, as a
    rank mesh (``launch/mesh.py::make_rank_mesh``).  The process group
    must hold exactly the picked shape's ranks; any other world size
    raises, naming both counts."""
    import torch.distributed as dist
    from .mesh import make_rank_mesh
    shape, axes = pick_topology(healthy_devices)
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"{healthy_devices} healthy devices pick the {shape} mesh of "
            f"{need} ranks, but the process group has {have}: restart at "
            f"world size {need}")
    return make_rank_mesh(shape, axes, device)


def rescale_batch(global_batch: int, seq_len: int, data_parallel: int,
                  per_device_tokens_budget: int = 1 << 16):
    """Recompute microbatching for a new data-parallel degree, keeping the
    global batch (the optimizer's trajectory) within a per-device
    activation budget."""
    if global_batch % data_parallel:
        raise ValueError(f"global batch {global_batch} must divide "
                         f"dp={data_parallel}")
    per_dev = global_batch // data_parallel
    n_micro = 1
    while per_dev // n_micro * seq_len > per_device_tokens_budget \
            and n_micro < per_dev:
        n_micro *= 2
    return {"n_micro": n_micro, "micro_batch": global_batch // n_micro}


@dataclasses.dataclass
class StragglerPolicy:
    """Decide what to do with a straggling step (the trainer's EWMA)."""
    factor: float = 3.0
    tolerate: int = 3                     # consecutive slow steps allowed
    on_evict: Optional[Callable[[int], None]] = None
    _slow_streak: int = 0

    def observe(self, step: int, dt: float, ewma: float) -> str:
        if dt <= self.factor * ewma:
            self._slow_streak = 0
            return "ok"
        self._slow_streak += 1
        if self._slow_streak >= self.tolerate:
            if self.on_evict:
                self.on_evict(step)
            self._slow_streak = 0
            return "evict"
        return "tolerate"
