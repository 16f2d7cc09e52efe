"""Checkpointing in the JAX package's on-disk format: atomic save, async
save, restore into a structure.

The port of the JAX package's ``checkpoint/ckpt.py``.  One directory per
step, ``<dir>/step_%010d``, holding

  * ``meta.json``  — the step and each leaf's shape and logical dtype;
  * ``arrays.npz`` — every leaf, keyed by its path in the tree.

The keys are the strings JAX's ``_flatten`` gives (``jax.tree_util``'s
paths through ``_path_str``), built here without JAX: a dict key as
itself (keys sorted, as JAX flattens dicts), a NamedTuple field as
``.name``, a list or tuple index as ``[i]``, joined by ``/``; ``None``
holds no leaf.  So a ``TrainState(params, AdamWState(step, m, v,
master))`` of JAX-layout trees (``convert.train_state_to_jax``) writes
``.params/embed``, ``.opt/.step``, ``.opt/.m/scan/b0/...``, and a
checkpoint written by either package restores in the other.

bfloat16 and float8 leaves (torch tensors of those types, or numpy
arrays whose dtype bears the name, as JAX's trees hold them) are stored
bit-cast to unsigned integers of their width and cast back on restore
from the logical dtype in ``meta.json`` (JAX's ``_BITCAST`` table),
through torch's own types, so ``ml_dtypes`` is not needed.

Fault tolerance, as JAX's: a write lands in ``<dir>/tmp.<step>`` and is
renamed into place after ``meta.json`` is synced, so a killed writer
leaves no torn ``step_`` directory, and ``latest_step`` takes the newest
step that has its ``meta.json``.  ``AsyncCheckpointer`` copies the tree
to the host on the caller's thread and writes it on a worker thread,
keeping the newest ``keep`` steps.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer",
           "flatten_paths"]

_SEP = "/"

# logical dtype -> (numpy storage dtype, torch dtype)
_BITCAST = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}
_TORCH_NAME = {tdt: name for name, (_, tdt) in _BITCAST.items()}


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten_paths(tree, prefix: tuple = ()):
    """``[(path string, leaf)]`` in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_paths(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [item for name in tree._fields
                for item in flatten_paths(getattr(tree, name),
                                          prefix + ("." + name,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, node in enumerate(tree)
                for item in flatten_paths(node, prefix + (f"[{i}]",))]
    return [(_SEP.join(prefix), tree)]


def _unflatten_like(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _unflatten_like(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten_like(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(node, leaves) for node in tree)
    return next(leaves)


def _host(leaf):
    """A leaf as ``(numpy array, logical dtype name)``: a tensor copied to
    the host (so the caller may go on updating it in place), a numpy
    array as it is, as JAX's ``np.asarray`` takes it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = _TORCH_NAME.get(t.dtype)
        if name is not None:
            t = t.view(torch.int16 if t.element_size() == 2 else torch.uint8)
        arr = t.cpu().numpy()
        if t.device.type == "cpu":
            arr = arr.copy()
        if name is not None:
            arr = arr.view(_BITCAST[name][0])
        return arr, name or str(arr.dtype)
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if name in _BITCAST:                 # an ml_dtypes leaf of a JAX tree
        arr = arr.view(_BITCAST[name][0])
    return arr, name


def _snapshot(tree):
    return {key: _host(leaf) for key, leaf in flatten_paths(tree)}


def _write(ckpt_dir: Path, step: int, flat: dict) -> Path:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"tmp.{step}"
    final = ckpt_dir / f"step_{step:010d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in flat.items()})
    meta = {"step": int(step),
            "leaves": {k: {"shape": list(a.shape), "dtype": name}
                       for k, (a, name) in flat.items()}}
    with open(tmp / "meta.json", "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def save(ckpt_dir: str | Path, step: int, tree: Any) -> Path:
    """Synchronous atomic checkpoint write of ``tree`` (dicts, NamedTuples,
    lists, tuples; leaves torch tensors on any device, numpy arrays or
    numbers)."""
    return _write(Path(ckpt_dir), step, _snapshot(tree))


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for d in ckpt_dir.iterdir():
        if d.name.startswith("step_") and (d / "meta.json").exists():
            try:
                steps.append(int(d.name.split("_")[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype


def restore(ckpt_dir: str | Path, step: Optional[int] = None, *,
            like: Any) -> Any:
    """Restore into the structure of ``like`` (its leaves torch tensors or
    numpy arrays, whose dtypes the restored leaves take; a tensor leaf
    also gives its device).  Only ``like``'s paths are read, so
    ``TrainState(params, None)`` reads the parameters alone.  ``step``
    defaults to the newest complete one."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:010d}"
    with open(d / "meta.json") as f:
        meta = json.load(f)
    out = []
    with np.load(d / "arrays.npz") as data:
        for key, leaf in flatten_paths(like):
            arr = data[key]
            logical = meta["leaves"][key]["dtype"]
            if logical in _BITCAST:
                t = torch.from_numpy(arr.view(
                    np.int16 if arr.itemsize == 2 else np.uint8)).view(
                        _BITCAST[logical][1])
            else:
                t = torch.from_numpy(np.require(arr, requirements="C"))
            if isinstance(leaf, torch.Tensor):
                out.append(t.to(device=leaf.device, dtype=leaf.dtype))
            else:
                want = _torch_dtype(getattr(leaf, "dtype", arr.dtype))
                out.append(t.to(want).numpy())
    return _unflatten_like(like, iter(out))


class AsyncCheckpointer:
    """Device->host snapshot on call; disk write on a worker thread.  A
    failed write raises from the next ``wait`` or ``save``."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_saved: Optional[int] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def save(self, step: int, tree: Any):
        self.wait()                       # one in flight at a time
        flat = _snapshot(tree)

        def work():
            try:
                _write(self.dir, step, flat)
                self.last_saved = step
                self._gc()
            except Exception as exc:      # reported by wait()
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(d.name.split("_")[1]) for d in self.dir.iterdir()
            if d.name.startswith("step_") and (d / "meta.json").exists())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)
