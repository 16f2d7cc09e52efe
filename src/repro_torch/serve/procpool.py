"""Process-backed replica pool for the asyncio pricing gateway.

The port of the JAX package's ``serve/procpool.py``.
:class:`ProcessReplica` satisfies the same ``price_chunk(ChunkSpec) ->
ChunkResult`` protocol as ``serve/replica.py::LocalReplica`` but prices
every chunk in a **spawned worker process** — one process per replica,
so replicas share no interpreter lock and a replica "crash" is a real
``kill -9``, not an injected exception.  Workers start by ``spawn``,
which CUDA requires: the parent need not touch CUDA before it spawns,
and each worker holds its own CUDA context on its own ``device``.

Lifecycle::

    spawn ──► warmup chunk (loads the kernels, prices one row) ──► ready
      │            │                                            │
      │            │ never acks within warmup_timeout_s         │ price_chunk
      │            ▼                                            ▼
      │        SIGKILL + ReplicaCrash                   send ChunkSpec.to_wire()
      │                                                         │
      │     ┌── deadline (call_timeout_s) ── SIGKILL ──┐        │
      └─────┤                                          ├◄───────┤
            └── pipe EOF / worker exit ── ReplicaCrash ┘        ▼
                                                     recv ChunkResult.from_wire()

Everything crossing the pipe is the versioned wire schema of
``serve/core.py`` — plain scalars, tuples and numpy arrays, never a
tensor, a device or a callable.  A worker whose warm-up fails (no card,
a kernel that does not build or launch) answers with an ``err`` message
and the replica dies with the error's text; a chunk that fails in a
healthy worker comes back as ``err`` and is retried or failed by the
gateway.  Nothing falls back to the CPU or to a kernel's plain version.

Fault semantics match the gateway's thread-pool contract:

* a **hung** worker (no reply within ``call_timeout_s``) is killed with
  SIGKILL and :class:`~repro_torch.serve.replica.ReplicaCrash` raised;
* a **dead** worker is detected by pipe EOF or the process sentinel;
* a **request** error (a PWL capacity ``OverflowError``) is re-raised
  under its own type — the worker stays alive and healthy.

:class:`ReplicaPool` is the factory the gateway consumes via
``pool={"thread","process"}``: ``factory(i)`` builds replica ``i`` and is
also what ``restart_s`` respawn calls.
"""
from __future__ import annotations

import contextlib
import multiprocessing
import multiprocessing.connection
import os
import signal
import threading
import time
from typing import Dict, Optional

from .core import ChunkResult, ChunkSpec, _Pending
from .replica import LocalReplica, ReplicaCrash

__all__ = ["ProcessReplica", "ReplicaPool", "stop_spawn_helper",
           "warmup_chunk"]


def warmup_chunk(*, n_steps: int = 8, backend: str = "kernel",
                 capacity: int = 16, engine: str = "notc",
                 n_paths: int = 256, n_assets: int = 1,
                 exercise_steps: Optional[tuple] = None) -> dict:
    """Wire dict for a 1-row chunk a worker prices on start.

    A worker on a card first loads the pricing kernels' libraries from
    the build directory (building any that are missing), then prices
    this row on its device, so the first real request finds a warm
    process.  ``rid=-1`` marks it synthetic; only the ack matters.
    """
    key = (100.0, 0.2, 0.1, 0.25, 0.0, "put", 100.0, 110.0,
           n_steps, n_assets, exercise_steps)
    chunk = ChunkSpec(
        bucket=(n_steps, engine), requests=[_Pending(-1, key, 0.0)],
        n_steps=n_steps, engine=engine, capacity=capacity, backend=backend,
        padded=1,
        cols=((100.0,), (0.2,), (0.1,), (0.25,), (0.0,), ("put",),
              (100.0,), (110.0,)),
        n_assets=n_assets, exercise_steps=exercise_steps,
        n_paths=n_paths)
    return chunk.to_wire()


def stop_spawn_helper(timeout_s: float = 10.0) -> bool:
    """Stop the helper process that spawning workers started in this one.

    The first ``spawn`` also starts multiprocessing's resource tracker,
    a process that lives until its parent exits, and after that as a
    zombie wherever nothing reaps orphans.  Once every worker this
    process spawned has exited (waiting up to ``timeout_s``), close the
    tracker's pipe and reap it.  Returns whether it is stopped: False
    while a worker is still alive, since the tracker waits for every
    holder of its pipe.  A later spawn starts a new one.  Call it where
    a program that used process replicas ends.
    """
    from multiprocessing import resource_tracker
    deadline = time.monotonic() + timeout_s
    while multiprocessing.active_children():    # also reaps the exited
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    resource_tracker._resource_tracker._stop()
    return True

def _load_pricing_kernels(device) -> None:
    """Load (building if missing) the libraries of the pricing kernels,
    on a card; the CPU runs their plain versions and builds nothing."""
    if device.type != "cuda":
        return
    from ..kernels import _build, binomial_step, rz_step
    for mod, name in ((binomial_step, "binomial_step"), (rz_step, "rz_step")):
        _build.load(name, mod._SIGNATURES)


def _worker_main(conn, cfg: dict) -> None:
    """Worker process entry point (module-level so spawn can pickle it).

    A strict request/reply loop over ``conn``: every message is a tuple
    whose first element is the op.  Chunks price through the same
    ``execute_chunk`` as every other transport, on ``cfg["device"]``.

    ``cfg["faults"]`` maps the worker-local chunk index to a fault kind
    (``"sigkill"`` | ``"exit"`` | ``"hang"``) and ``cfg["hang_warmup"]``
    wedges the warmup ack.  Faults are *real*: ``sigkill`` is
    ``os.kill(…, SIGKILL)`` on itself, not an exception.
    """
    import torch

    from .replica import LocalReplica    # late: after spawn bootstraps
    faults = {int(k): v for k, v in (cfg.get("faults") or {}).items()}
    calls = 0
    replica = None

    def price(wire):
        nonlocal replica
        if replica is None:              # raises without the card asked for
            replica = LocalReplica(f"worker-{os.getpid()}",
                                   device=cfg["device"])
            _load_pricing_kernels(replica.device)
        return replica.price_chunk(ChunkSpec.from_wire(wire))

    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return                       # parent closed its end / died
        op = msg[0]
        if op == "stop":
            return
        if op == "warmup":
            if cfg.get("hang_warmup"):
                time.sleep(3600.0)       # never acks; parent SIGKILLs us
            t0 = time.perf_counter()
            try:
                price(msg[1])
            except Exception as e:       # noqa: BLE001 — forwarded whole
                conn.send(("err", type(e).__name__, str(e)))
                return
            conn.send(("ready", os.getpid(), time.perf_counter() - t0))
            continue
        if op == "memory":
            dev = torch.device(cfg["device"])
            on_card = dev.type == "cuda" and torch.cuda.is_initialized()
            conn.send(("memory", os.getpid(),
                       torch.cuda.max_memory_allocated(dev) if on_card else 0,
                       torch.cuda.memory_reserved(dev) if on_card else 0))
            continue
        if op == "chunk":
            i, calls = calls, calls + 1
            fault = faults.get(i)
            if fault == "sigkill":
                os.kill(os.getpid(), signal.SIGKILL)
            if fault == "exit":
                # pipe EOF on the result read: close our end, then die
                # without flushing anything
                conn.close()
                os._exit(3)
            if fault == "hang":
                time.sleep(3600.0)       # parent's deadline SIGKILLs us
            try:
                res = price(msg[1])
            except Exception as e:       # noqa: BLE001 — forwarded whole
                conn.send(("err", type(e).__name__, str(e)))
            else:
                conn.send(("ok", res.to_wire()))
            continue
        conn.send(("err", "ValueError", f"unknown op {op!r}"))


class ProcessReplica:
    """A replica that prices chunks in its own spawned process on
    ``device`` (``"cuda"`` by default; the worker raises, and answers
    ``err``, where it finds no card).

    Satisfies the gateway's replica protocol (``name``, ``calls``,
    ``price_chunk``) and adds ``pid``/``alive``/``close()`` and
    :meth:`memory`.  Every infrastructure failure — deadline exceeded
    (worker SIGKILLed), pipe EOF, worker exit, a failed warm-up — raises
    :class:`ReplicaCrash`; once dead the replica stays dead (the gateway
    respawns through the pool factory).

    ``price_chunk`` is serialized by a lock (the gateway runs one call
    in flight per replica anyway); ``close()`` deliberately does *not*
    take it, so killing the process unblocks a concurrent call via the
    process sentinel.
    """

    def __init__(self, name: str = "proc", *, device: str = "cuda",
                 warmup: Optional[dict] = None,
                 call_timeout_s: Optional[float] = None,
                 warmup_timeout_s: float = 120.0,
                 faults: Optional[Dict[int, str]] = None,
                 hang_warmup: bool = False, start: bool = True):
        self.name = name
        self.device = str(device)
        self.calls = 0
        self.call_timeout_s = call_timeout_s
        self.warmup_timeout_s = float(warmup_timeout_s)
        self.warmup_seconds: Optional[float] = None
        self._warmup = warmup
        self._cfg = {"faults": dict(faults or {}),
                     "hang_warmup": bool(hang_warmup),
                     "device": self.device}
        self._lock = threading.Lock()
        self._dead: Optional[str] = None
        self._ready = False
        self._warmup_deadline: Optional[float] = None
        self._conn = None
        self._proc = None
        if start:
            self.start()

    # price_chunk (and everything it calls) runs under _lock; close()
    # is deliberately lock-free (see the class docstring)
    GUARDED_BY = {
        "_dead": "_lock", "_ready": "_lock", "calls": "_lock",
        "warmup_seconds": "_lock", "_conn": "_lock", "_proc": "_lock",
        "_warmup_deadline": "_lock",
    }

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> None:
        ctx = multiprocessing.get_context("spawn")
        parent, child = ctx.Pipe()
        self._proc = ctx.Process(target=_worker_main, args=(child, self._cfg),
                                 name=self.name, daemon=True)
        self._proc.start()
        child.close()                    # child's end lives in the child
        self._conn = parent
        if self._warmup is None:
            self._ready = True
        else:
            self._conn.send(("warmup", self._warmup))
            self._warmup_deadline = (time.monotonic()
                                     + self.warmup_timeout_s)

    @property
    def pid(self) -> Optional[int]:
        return None if self._proc is None else self._proc.pid

    @property
    def alive(self) -> bool:
        return (self._dead is None and self._proc is not None
                and self._proc.is_alive())

    def close(self) -> None:
        """Kill the worker and release the pipe (idempotent; called by
        the gateway's slot teardown).  Lock-free by design — a blocked
        ``price_chunk`` wakes up via the process sentinel."""
        self._dead = self._dead or "closed"
        self._kill()
        if self._conn is not None:
            with contextlib.suppress(OSError):
                self._conn.close()

    def _kill(self) -> None:
        if self._proc is not None and self._proc.is_alive():
            self._proc.kill()            # SIGKILL — no cooperation needed
            self._proc.join(timeout=10.0)

    def _exitcode(self):
        """The worker's exitcode for diagnostics (joins briefly so a
        just-died process settles to its real code, e.g. -9)."""
        if self._proc is None:
            return None
        self._proc.join(timeout=1.0)
        return self._proc.exitcode

    def _die(self, reason: str) -> ReplicaCrash:  # locked: _lock
        """Mark dead and build (not raise) the crash for the caller."""
        self._dead = reason
        if self._conn is not None:
            with contextlib.suppress(OSError):
                self._conn.close()
        return ReplicaCrash(f"{self.name}: {reason}")

    # ------------------------------------------------------------------ #
    # wire I/O
    # ------------------------------------------------------------------ #
    def _recv(self, timeout: Optional[float], what: str):  # locked: _lock
        """One reply off the pipe, racing the worker's death sentinel.

        ``timeout`` None = wait forever (modulo the sentinel).  On
        deadline the worker is SIGKILLed first — a wedged engine call
        holds its device, so the only safe recovery is a fresh process —
        then :class:`ReplicaCrash` raises.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            try:
                ready = multiprocessing.connection.wait(
                    [self._conn, self._proc.sentinel], timeout=remaining)
            except OSError:
                raise self._die(f"pipe failed waiting for {what}") from None
            if self._conn in ready:
                try:
                    return self._conn.recv()
                except (EOFError, OSError):
                    raise self._die(
                        f"pipe EOF reading {what} "
                        f"(exitcode {self._exitcode()})") from None
            if ready:                    # sentinel fired: worker exited
                if self._conn.poll(0.1):  # drain a result racing the exit
                    with contextlib.suppress(EOFError, OSError):
                        return self._conn.recv()
                raise self._die(f"worker exited before {what} "
                                f"(exitcode {self._exitcode()})")
            self._kill()                 # timeout: SIGKILL, then report
            raise self._die(
                f"no {what} within {timeout:.3g}s deadline "
                "(worker SIGKILLed)")

    def _ensure_ready(self) -> None:  # locked: _lock
        if self._ready:
            return
        remaining = self._warmup_deadline - time.monotonic()
        if remaining <= 0:
            self._kill()
            raise self._die("never acked the warmup chunk "
                            f"(worker SIGKILLed, pid {self.pid})")
        msg = self._recv(remaining, "warmup ack")
        if msg[0] == "err":
            self._kill()
            raise self._die(f"warmup failed on {self.device}: "
                            f"{msg[1]}: {msg[2]}")
        if msg[0] != "ready":
            raise self._die(f"bad warmup ack {msg[0]!r}")
        self._ready = True
        self.warmup_seconds = float(msg[2])

    # ------------------------------------------------------------------ #
    # replica protocol
    # ------------------------------------------------------------------ #
    def price_chunk(self, chunk: ChunkSpec) -> ChunkResult:
        with self._lock:
            if self._dead is not None:
                raise ReplicaCrash(f"{self.name}: dead ({self._dead})")
            self._ensure_ready()
            self.calls += 1
            try:
                self._conn.send(("chunk", chunk.to_wire()))
            except (BrokenPipeError, OSError):
                raise self._die(
                    f"pipe broke sending chunk "
                    f"(exitcode {self._exitcode()})") from None
            msg = self._recv(self.call_timeout_s, "chunk result")
            if msg[0] == "ok":
                return ChunkResult.from_wire(msg[1])
            if msg[0] == "err":
                _, kind, text = msg
                # request errors come back under their own type so the
                # gateway's healthy-replica retry semantics hold
                if kind == "OverflowError":
                    raise OverflowError(f"{self.name}: {text}")
                raise RuntimeError(f"{self.name}: {kind}: {text}")
            raise self._die(f"bad reply op {msg[0]!r}")

    def memory(self) -> dict:
        """The worker's device memory as its allocator sees it:
        ``{"pid", "peak_allocated", "reserved"}`` in bytes (zeros on the
        CPU).  The CUDA context's own memory is not in these counts."""
        with self._lock:
            if self._dead is not None:
                raise ReplicaCrash(f"{self.name}: dead ({self._dead})")
            self._ensure_ready()
            try:
                self._conn.send(("memory",))
            except (BrokenPipeError, OSError):
                raise self._die("pipe broke asking for memory") from None
            msg = self._recv(self.call_timeout_s, "memory reply")
            if msg[0] != "memory":
                raise self._die(f"bad reply op {msg[0]!r}")
            return {"pid": msg[1], "peak_allocated": msg[2],
                    "reserved": msg[3]}


class ReplicaPool:
    """Replica factory the gateway consumes (``pool="thread"|"process"``).

    ``factory(i)`` builds replica ``i`` on ``device``; the gateway calls
    it both at startup and on ``restart_s`` respawn, so a SIGKILLed
    process replica is replaced by a *fresh* process (new pid, new
    warmup).  The thread kind builds
    :class:`~repro_torch.serve.replica.LocalReplica`.
    """

    KINDS = ("thread", "process")

    def __init__(self, kind: str = "thread", *, device: str = "cuda",
                 warmup: Optional[dict] = None,
                 call_timeout_s: Optional[float] = None,
                 warmup_timeout_s: float = 120.0,
                 name_prefix: str = "replica"):
        if kind not in self.KINDS:
            raise ValueError(f"pool kind must be one of {self.KINDS}, "
                             f"got {kind!r}")
        self.kind = kind
        self.device = str(device)
        self.warmup = warmup
        self.call_timeout_s = call_timeout_s
        self.warmup_timeout_s = warmup_timeout_s
        self.name_prefix = name_prefix

    def factory(self, i: int):
        name = f"{self.name_prefix}-{i}"
        if self.kind == "thread":
            return LocalReplica(name, device=self.device)
        return ProcessReplica(name, device=self.device, warmup=self.warmup,
                              call_timeout_s=self.call_timeout_s,
                              warmup_timeout_s=self.warmup_timeout_s)

    def build(self, n: int) -> list:
        return [self.factory(i) for i in range(n)]
