"""Replica workers for the asyncio pricing gateway.

The port of the JAX package's ``serve/replica.py``.  A *replica* is
anything with a ``price_chunk(ChunkSpec) -> ChunkResult`` method.  The
gateway runs each replica on its own single-thread executor (one engine
call in flight per replica) and treats the boundary as untrusted: a
replica may crash (:class:`ReplicaCrash`), hang past the gateway's
timeout, or raise a *request* error like ``OverflowError`` (the chunk's
own fault — the replica stays healthy, the chunk retries or errors out).

:class:`LocalReplica` is the in-process replica over
``serve/core.py::execute_chunk`` on its own ``device``.
:class:`FaultyReplica` wraps any replica with a call-indexed fault
schedule, the fault-injection harness's probe.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from ..core.device import resolve_device
from .core import ChunkResult, ChunkSpec, execute_chunk

__all__ = ["ReplicaCrash", "LocalReplica", "FaultyReplica"]


class ReplicaCrash(RuntimeError):
    """The replica process/worker died — an infrastructure failure, not a
    property of the chunk.  The gateway marks the replica dead and
    re-queues the in-flight chunk to a healthy replica."""


class LocalReplica:
    """In-process replica: prices chunks through the engines on
    ``device`` (``"cuda"`` by default: it raises without a card; pass
    ``"cpu"`` for the kernels' plain versions).

    On a card every chunk runs with ``device`` current (a worker
    thread's current device is otherwise ``cuda:0``), on the current
    stream.
    """

    def __init__(self, name: str = "replica", *, device="cuda"):
        self.name = name
        self.device = resolve_device(device)
        self.calls = 0

    # the gateway gives each replica a single-thread executor, so calls
    # are confined to that one worker thread
    GUARDED_BY = {"calls": "owner"}

    def price_chunk(self, chunk: ChunkSpec) -> ChunkResult:
        self.calls += 1
        return execute_chunk(chunk, device=self.device)


class FaultyReplica:
    """Fault-injection wrapper: fail specific calls by index.

    ``faults`` maps the replica-local call index (0-based, counting every
    ``price_chunk`` invocation) to a fault kind:

    * ``"crash"``    — raise :class:`ReplicaCrash` (replica dies);
    * ``"hang"``     — block until :meth:`release` (or ``hang_s``, a
      safety bound so an un-released hang cannot wedge the process:
      executor threads are non-daemon), then die;
    * ``"overflow"`` — raise ``OverflowError`` (a *request* error: the
      replica survives and the chunk is retried).

    Un-scheduled calls delegate to the wrapped replica, by default a
    :class:`LocalReplica` on ``device``.
    """

    def __init__(self, inner: Optional[LocalReplica] = None,
                 faults: Optional[Dict[int, str]] = None, *,
                 hang_s: float = 60.0, name: str = "faulty",
                 device="cuda"):
        self.inner = (inner if inner is not None
                      else LocalReplica(name, device=device))
        self.faults = dict(faults or {})
        self.hang_s = float(hang_s)
        self.name = name
        self.calls = 0
        self._release = threading.Event()

    # single-thread executor confinement, as LocalReplica
    GUARDED_BY = {"calls": "owner"}

    def release(self) -> None:
        """Unblock a hanging call (test teardown — without it the worker
        thread would outlive the test by up to ``hang_s``)."""
        self._release.set()

    def price_chunk(self, chunk: ChunkSpec) -> ChunkResult:
        i = self.calls
        self.calls += 1
        fault = self.faults.get(i)
        if fault == "crash":
            raise ReplicaCrash(f"{self.name}: injected crash on call {i}")
        if fault == "hang":
            self._release.wait(self.hang_s)
            # by now the gateway has timed this call out and re-queued
            # the chunk elsewhere; die like the wedged worker this
            # simulates rather than return a duplicate (stale) result
            raise ReplicaCrash(f"{self.name}: hung call {i} released")
        if fault == "overflow":
            raise OverflowError(
                f"{self.name}: injected PWL capacity overflow on call {i}")
        return self.inner.price_chunk(chunk)
