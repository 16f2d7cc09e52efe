"""Token data sources: a deterministic synthetic stream and a memmap corpus.

The port of the JAX package's ``data/pipeline.py``.  The sources are
numpy, as JAX's are, so their tokens are bit-equal to JAX's:
``batch(step)`` gives ``{"tokens", "targets"}`` int32 arrays of shape
``(n_micro, global_batch / n_micro, seq_len)``, a pure function of the
step, so the trainer is stateless (resume = seek by step).

* ``SyntheticSource``: per-step tokens from
  ``np.random.default_rng((seed << 32) ^ step)``.
* ``MemmapSource``: a flat int32 token file read at a step offset.

``Prefetcher`` and ``make_batches`` move a step's batch onto a
``device`` as torch tensors, where JAX places it with a sharding.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

__all__ = ["SyntheticSource", "MemmapSource", "Prefetcher", "make_batches",
           "to_device"]


@dataclasses.dataclass
class SyntheticSource:
    vocab: int
    global_batch: int
    seq_len: int
    n_micro: int = 1
    seed: int = 0

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 32) ^ step)
        mb = self.global_batch // self.n_micro
        toks = rng.integers(
            0, self.vocab, (self.n_micro, mb, self.seq_len + 1), np.int32)
        return {"tokens": toks[..., :-1], "targets": toks[..., 1:]}


@dataclasses.dataclass
class MemmapSource:
    path: str
    vocab: int
    global_batch: int
    seq_len: int
    n_micro: int = 1

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")
        self.n_tokens = self._data.shape[0]

    def batch(self, step: int) -> dict:
        mb = self.global_batch // self.n_micro
        need = self.global_batch * (self.seq_len + 1)
        start = (step * need) % max(self.n_tokens - need, 1)
        flat = np.asarray(self._data[start:start + need])
        toks = flat.reshape(self.n_micro, mb, self.seq_len + 1)
        return {"tokens": toks[..., :-1], "targets": toks[..., 1:]}


def to_device(batch: dict, device) -> dict:
    """The batch's arrays as torch tensors on ``device`` (dense copies:
    the sources' ``tokens`` and ``targets`` are strided views)."""
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for k, a in batch.items()}


class Prefetcher:
    """A background thread that builds batches ahead and moves them onto
    ``device`` (depth-bounded).  ``next(p)`` gives ``(step, batch)``;
    ``stop()`` ends the thread."""

    def __init__(self, source, device=None, depth: int = 2,
                 start_step: int = 0):
        self.source = source
        self.device = device
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        while not self._stop.is_set():
            b = self.source.batch(self.step)
            if self.device is not None:
                b = to_device(b, self.device)
            while not self._stop.is_set():
                try:
                    self.q.put((self.step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            self.step += 1

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def stop(self, timeout: Optional[float] = 10.0):
        self._stop.set()
        self.thread.join(timeout)


def make_batches(source, device=None, start_step: int = 0) -> Iterator:
    """Simple (non-threaded) batch iterator; deterministic, resumable."""
    step = start_step
    while True:
        b = source.batch(step)
        if device is not None:
            b = to_device(b, device)
        yield step, b
        step += 1
