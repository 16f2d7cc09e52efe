"""The scenario axis of the grid engines over several devices.

The port of the scenario-axis half of the JAX package's
``core/distributed.py``.  Every row of a flat scenario batch is
independent, so the batch splits over a 1-D "mesh" of devices with no
collectives at all: shard ``d`` prices its slice of rows on ``mesh[d]``
and the results gather on the host.  The shard assignment itself
(``core/partition.py::plan_shards``) is where the paper's §4.2
re-balancing reappears, at device granularity.

A mesh here is a tuple of ``torch.device``.  It may repeat a device:
``(cuda:0,) * 4`` runs the real per-shard dispatch (four slices, four
sets of launches) on one card, as JAX's
``--xla_force_host_platform_device_count`` gives one CPU four devices.

The node-axis engines of the JAX module (``plan_rounds``,
``build_rz_sharded``, ``build_notc_sharded``: §4's halo rounds over
``ppermute``) are not ported yet (ROADMAP Queue A #7, node axis).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple

import torch

__all__ = ["GRID_AXIS", "grid_mesh", "resolve_grid_mesh", "sharded_rows"]

GRID_AXIS = "scenarios"

Mesh = Tuple[torch.device, ...]


def _visible(kind: str) -> int:
    """Devices of ``kind`` this process sees: the CUDA device count, or
    one CPU."""
    if kind == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 1


def grid_mesh(devices: Optional[int] = None, *, kind: str = "cuda") -> Mesh:
    """1-D mesh over the first ``devices`` devices of ``kind`` (all if
    None); raises when the process sees fewer."""
    seen = _visible(kind)
    w = seen if devices is None else int(devices)
    if w < 1:
        raise ValueError("need devices >= 1")
    if w > seen:
        raise ValueError(
            f"asked for {w} devices but the process sees {seen} of kind "
            f"{kind!r}; pass devices <= the device count, an explicit "
            "mesh=(torch.device, ...), or use the simulated path via "
            "resolve_grid_mesh")
    if kind == "cpu":
        return (torch.device("cpu"),)
    return tuple(torch.device(kind, i) for i in range(w))


def resolve_grid_mesh(devices: Optional[int] = None,
                      mesh: Optional[Sequence] = None, *,
                      kind: str = "cuda"):
    """Normalise the grid engines' ``devices=``/``mesh=`` knobs.

    Returns ``(mesh_or_None, n_shards)``:

    * an explicit ``mesh`` (a flat sequence of devices, all of ``kind``)
      wins, ``n_shards`` = its length;
    * ``devices`` in (None, 0, 1) -> the single-device path;
    * ``devices`` <= the devices of ``kind`` this process sees -> a fresh
      :func:`grid_mesh`;
    * more -> the **simulated** sharded path: no mesh, but the same
      plan/permute/pad layout run on the one device.  Rows are
      independent, so the numbers are bit-equal to a real mesh run.
    """
    if mesh is not None:
        if isinstance(mesh, (str, torch.device)) or not isinstance(
                mesh, Sequence):
            raise TypeError(f"mesh must be a sequence of torch.device, got "
                            f"{type(mesh).__name__}")
        if any(isinstance(d, Sequence) and not isinstance(d, str)
               for d in mesh):
            raise ValueError("grid mesh must be 1-D: a flat sequence of "
                             "devices")
        mesh = tuple(torch.device(d) for d in mesh)
        if not mesh:
            raise ValueError("grid mesh must hold at least one device")
        wrong = [str(d) for d in mesh if d.type != kind]
        if wrong:
            raise ValueError(f"mesh devices {wrong} are not of the "
                             f"requested device type {kind!r}")
        if devices is not None and int(devices) != len(mesh):
            raise ValueError(f"devices={devices} conflicts with the given "
                             f"{len(mesh)}-device mesh; pass one or the "
                             "other")
        return mesh, len(mesh)
    if devices is None or int(devices) <= 1:
        return None, 1
    w = int(devices)
    if w <= _visible(kind):
        return grid_mesh(w, kind=kind), w
    return None, w


def _on(dev: torch.device):
    """Context that makes ``dev`` current, so a kernel launches there."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def sharded_rows(fn: Callable, mesh: Mesh) -> Callable:
    """``fn`` run shard by shard over a 1-D mesh.

    ``fn`` maps equal-length row tensors (and non-tensor extras passed
    through unchanged) to a tuple of equal-length row tensors.  The
    returned function splits every row tensor into ``len(mesh)`` equal
    slices, runs ``fn`` on slice ``d`` with its floating-point tensors on
    ``mesh[d]``, and gathers each output on the host in mesh order.  An
    integer column (LSMC's per-row generator seeds, which the host reads)
    stays where it is, as on the single-device path.  Shards are
    dispatched one after another from the calling thread; whether shards
    on distinct cards overlap is not measured.  There are no
    collectives: per-row reductions (``max_pieces``) reduce on the host
    after the gather, so overflow semantics cannot diverge from the
    single-device path.
    """
    def run(*rows):
        n = len(mesh)
        lens = {r.shape[0] for r in rows if isinstance(r, torch.Tensor)}
        if len(lens) != 1 or next(iter(lens)) % n:
            raise ValueError(f"row tensors of lengths {sorted(lens)} do not "
                             f"split evenly over {n} shards")
        lanes = next(iter(lens)) // n
        outs = []
        for d, dev in enumerate(mesh):
            part = []
            for r in rows:
                if isinstance(r, torch.Tensor):
                    r = r[d * lanes:(d + 1) * lanes]
                    r = r.to(dev) if r.is_floating_point() else r
                part.append(r)
            with _on(dev):
                outs.append(fn(*part))
        return tuple(torch.cat([o[i].cpu() for o in outs])
                     for i in range(len(outs[0])))
    return run
