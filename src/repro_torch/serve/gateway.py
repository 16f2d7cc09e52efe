"""Asyncio multi-replica pricing gateway over the scheduler core.

The port of the JAX package's ``serve/gateway.py``: the second transport
over ``serve/core.py::SchedulerCore`` (the first is the cooperative
:class:`~repro_torch.serve.scheduler.PricingService`).

* **Timer-driven deadlines.**  A background flusher task sleeps until
  the earliest pending deadline and dispatches due buckets itself — a
  request is flushed within ``deadline_ms`` with no driver involvement.
* **A replica pool.**  Flushed chunks run on N replica workers, each on
  its own single-thread executor, so a slow bucket on one replica does
  not block intake or the other replicas.  Buckets route with sticky
  ``(n_steps, engine)`` affinity, falling over to the least-loaded
  healthy replica only when the sticky one dies.  Thread replicas run
  the engines on the executor threads: the kernels are called through
  ``ctypes``, which releases the interpreter lock during the call.
* **Fault tolerance.**  A replica that crashes
  (:class:`~repro_torch.serve.replica.ReplicaCrash`) or hangs past
  ``replica_timeout_s`` is marked dead (and respawned after
  ``restart_s`` when configured), and its in-flight chunk is re-queued
  to a healthy replica under bounded retry with exponential backoff.
  Request-level errors (an ``OverflowError`` from the PWL capacity
  check) retry the same way but leave the replica healthy; when retries
  exhaust, the error is delivered on the request's future — no request
  is ever silently dropped.

Under sustained overload the gateway degrades before it sheds: when the
backlog stays above ``overload_factor x max_batch x healthy_replicas``
for ``overload_grace_s``, the effective ``max_batch`` halves, recovering
by doubling once the backlog clears; only past ``shed_factor`` x the
degrade threshold does :meth:`submit` refuse work
(:class:`GatewayOverloaded`).

**Streaming mode** (:meth:`run_stream`): subscribe a
:class:`~repro_torch.serve.streaming.StreamingBook` to a tick feed and
incrementally requote only the rows a tick touched — grid-engine lanes
are independent, so incremental requotes match a full reprice of the
post-tick book.

Everything time-related goes through the injectable ``clock`` /
``sleeper`` pair so the deadline machinery is testable against a fake
clock; the replica hang timeout is the exception — it guards against
wall-clock wedged workers and always uses real event-loop time.

Replicas run on ``device`` (``"cuda"`` by default, raising without a
card; ``"cpu"`` runs the kernels' plain versions): thread replicas as
:class:`~repro_torch.serve.replica.LocalReplica`, process replicas as
spawned workers (``serve/procpool.py``).
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
import time
from typing import Callable, Dict, List, Optional, Set

import numpy as np

from ..configs.pricing import ExecutionConfig
from ..core.device import resolve_device
from .core import ChunkSpec, SchedulerCore, ServiceMetrics
from .scheduler import execution_knobs
from .procpool import ReplicaPool, warmup_chunk
from .replica import LocalReplica, ReplicaCrash

__all__ = ["PricingGateway", "GatewayMetrics", "GatewayError",
           "GatewayOverloaded"]


class GatewayError(RuntimeError):
    """Gateway-level failure (e.g. no healthy replica and no restart)."""


class GatewayOverloaded(GatewayError):
    """submit() refused: backlog past the shedding threshold."""


@dataclasses.dataclass
class GatewayMetrics(ServiceMetrics):
    """ServiceMetrics plus the gateway's fault/overload/streaming
    counters (same thread-safety contract: mutate via the locked
    methods)."""
    retries: int = 0             # chunk re-dispatches after a failure
    requeues: int = 0            # failures that put a chunk back in play
    backoffs: int = 0            # exponential-backoff sleeps taken
    backoff_seconds: float = 0.0
    failed: int = 0              # requests completed *with an error*
    replica_crashes: int = 0
    replica_hangs: int = 0
    replica_restarts: int = 0
    affinity_moves: int = 0      # sticky bucket re-homed to another replica
    degraded: int = 0            # effective max_batch halvings
    restored: int = 0            # ... doublings on recovery
    shed: int = 0                # submits refused (GatewayOverloaded)
    deadline_flushes: int = 0    # dispatches fired by the timer
    size_flushes: int = 0        # ... by the size trigger
    forced_flushes: int = 0      # ... by drain()/streaming
    ticks: int = 0               # streaming ticks consumed
    rows_requoted: int = 0       # rows incrementally requoted
    staleness: List[float] = dataclasses.field(default_factory=list)

    # extends ServiceMetrics.GUARDED_BY (registries merge down the base
    # class chain)
    GUARDED_BY = {
        "retries": "_lock", "requeues": "_lock", "backoffs": "_lock",
        "backoff_seconds": "_lock", "failed": "_lock",
        "replica_crashes": "_lock", "replica_hangs": "_lock",
        "replica_restarts": "_lock", "affinity_moves": "_lock",
        "degraded": "_lock", "restored": "_lock", "shed": "_lock",
        "deadline_flushes": "_lock", "size_flushes": "_lock",
        "forced_flushes": "_lock", "ticks": "_lock",
        "rows_requoted": "_lock", "staleness": "_lock",
    }

    def add_staleness(self, seconds: float) -> None:
        """Tick-to-delivered-quote seconds (bounded like latencies)."""
        with self._lock:
            self.staleness.append(seconds)
            if len(self.staleness) > 2 * self.latency_window:
                del self.staleness[:-self.latency_window]

    def _snapshot_locked(self) -> dict:
        # extend the BASE snapshot under the SAME lock acquisition: an
        # override of snapshot() that locked a second time produced a
        # torn read — base counters from one instant, gateway counters
        # from another (e.g. completed != requests - failed mid-flush)
        snap = super()._snapshot_locked()
        stale = (np.asarray(self.staleness) if self.staleness
                 else np.zeros(1))
        snap.update({
            "retries": self.retries, "requeues": self.requeues,
            "backoffs": self.backoffs,
            "backoff_seconds": self.backoff_seconds,
            "failed": self.failed,
            "replica_crashes": self.replica_crashes,
            "replica_hangs": self.replica_hangs,
            "replica_restarts": self.replica_restarts,
            "affinity_moves": self.affinity_moves,
            "degraded": self.degraded, "restored": self.restored,
            "shed": self.shed,
            "deadline_flushes": self.deadline_flushes,
            "size_flushes": self.size_flushes,
            "forced_flushes": self.forced_flushes,
            "ticks": self.ticks,
            "rows_requoted": self.rows_requoted,
            "staleness_p50_ms": float(np.percentile(stale, 50) * 1e3),
            "staleness_p99_ms": float(np.percentile(stale, 99) * 1e3),
        })
        return snap


class _Slot:
    """One replica worker: the replica object, its single-thread
    executor, and its health/affinity state."""

    def __init__(self, index: int, replica):
        self.index = index
        self.replica = replica
        self.name = getattr(replica, "name", f"replica-{index}")
        self.executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"gw-{self.name}")
        self.healthy = True
        self.dead_reason: Optional[str] = None
        self.inflight = 0
        self.calls = 0
        self.sticky: Set[tuple] = set()

    # slot state is event-loop-confined: the executor thread only runs
    # replica.price_chunk, never touches the slot
    GUARDED_BY = {
        "healthy": "owner", "dead_reason": "owner", "inflight": "owner",
        "calls": "owner", "sticky": "owner",
    }

    def kill(self, reason: str) -> None:
        self.healthy = False
        self.dead_reason = reason
        self.sticky.clear()
        # a process-backed replica holds a real worker: SIGKILL it first,
        # which also unblocks the executor thread waiting on its pipe
        close = getattr(self.replica, "close", None)
        if close is not None:
            close()
        # a hung worker thread cannot be interrupted; abandon the
        # executor (its thread unwinds when the replica call returns)
        self.executor.shutdown(wait=False, cancel_futures=True)


class PricingGateway:
    """Async multi-replica front end over :class:`SchedulerCore`.

    Usage::

        async with PricingGateway(replicas=2, deadline_ms=5.0) as gw:
            rid = await gw.submit(PriceRequest(s0=100.0, sigma=0.2,
                                               rate=0.1, maturity=0.25,
                                               cost_rate=0.0))
            quote = await gw.result(rid)

    ``replicas`` is a count (spawning workers via ``replica_factory``)
    or an explicit list of replica objects (the fault harness passes
    :class:`~repro_torch.serve.replica.FaultyReplica`).  ``pool`` selects
    what a spawned replica *is*: ``"thread"`` (default) keeps in-process
    :class:`LocalReplica` workers on ``device``; ``"process"`` backs
    every slot with a spawned process on ``device``
    (``serve/procpool.py::ProcessReplica``): its own CUDA context, a
    warmup chunk on start, SIGKILL-and-respawn on hang, behind the
    *same* failover machinery.  Pass a
    :class:`~repro_torch.serve.procpool.ReplicaPool` instance for custom
    warmup/deadline settings; an explicit ``replica_factory`` wins over
    ``pool``.  ``execution`` consolidates the execution knobs (fields set
    on it override ``backend``/``device``/``n_paths``/``mc_seed``/
    ``basis``/``degree``/``antithetic``).
    """

    def __init__(self, *, replicas=2, max_batch: int = 64,
                 deadline_ms: float = 5.0, capacity: int = 48,
                 backend: str = "kernel", device: str = "cuda",
                 default_n_steps: int = 100,
                 default_payoff: str = "put", default_strike: float = 100.0,
                 result_cache_size: int = 1024, max_results: int = 65536,
                 replica_timeout_s: float = 300.0, max_retries: int = 3,
                 retry_backoff_s: float = 0.05,
                 restart_s: Optional[float] = None,
                 replica_factory: Optional[Callable[[int], object]] = None,
                 pool="thread", n_paths: int = 4096, mc_seed: int = 0,
                 basis: str = "poly", degree: int = 3,
                 antithetic: bool = True,
                 execution: Optional[ExecutionConfig] = None,
                 overload_factor: Optional[float] = 8.0,
                 overload_grace_s: float = 0.25, shed_factor: float = 4.0,
                 min_batch: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 sleeper=None):
        k = execution_knobs(execution, backend=backend, device=device,
                            n_paths=n_paths, mc_seed=mc_seed, basis=basis,
                            degree=degree, antithetic=antithetic)
        self.device = resolve_device(k["device"])
        self.core = SchedulerCore(
            max_batch=max_batch, deadline_ms=deadline_ms, capacity=capacity,
            backend=k["backend"], device=self.device.type,
            default_n_steps=default_n_steps,
            default_payoff=default_payoff, default_strike=default_strike,
            result_cache_size=result_cache_size, max_results=max_results,
            n_paths=k["n_paths"], mc_seed=k["mc_seed"], basis=k["basis"],
            degree=k["degree"], antithetic=k["antithetic"],
            clock=clock, metrics=GatewayMetrics())
        self.max_batch = int(max_batch)
        self.effective_max_batch = int(max_batch)
        self.min_batch = max(1, int(min_batch))
        self.replica_timeout_s = float(replica_timeout_s)
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.restart_s = restart_s
        self.overload_factor = overload_factor
        self.overload_grace_s = float(overload_grace_s)
        self.shed_factor = float(shed_factor)
        if replica_factory is not None:
            self._factory = replica_factory
        else:
            if isinstance(pool, ReplicaPool):
                rp = pool
            elif pool == "process":
                # the per-process warmup loads the kernels and prices a
                # row of the pool's default bucket; the per-call deadline
                # mirrors the gateway's hang timeout so a wedged engine
                # call is SIGKILLed
                rp = ReplicaPool(
                    "process", device=str(self.device),
                    warmup=warmup_chunk(n_steps=default_n_steps,
                                        backend=self.core.backend,
                                        capacity=capacity),
                    call_timeout_s=replica_timeout_s)
            elif pool == "thread":
                rp = ReplicaPool("thread", device=str(self.device))
            else:
                raise ValueError(
                    f"pool must be 'thread', 'process' or a ReplicaPool, "
                    f"got {pool!r}")
            self._factory = rp.factory
        if isinstance(replicas, int):
            self._initial = [self._factory(i) for i in range(replicas)]
        else:
            self._initial = list(replicas)
        if not self._initial:
            raise ValueError("need at least one replica")
        self._sleeper = sleeper
        self._slots: List[_Slot] = []
        self._sticky: Dict[tuple, _Slot] = {}
        self._futures: Dict[int, asyncio.Future] = {}
        self._chunk_tasks: Set[asyncio.Task] = set()
        self._bg_tasks: Set[asyncio.Task] = set()
        self._inflight_rows = 0
        self._over_since: Optional[float] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._flusher: Optional[asyncio.Task] = None
        self._closed = False

    # gateway mutable state is event-loop-confined by design: replica
    # worker threads return results through run_in_executor futures, and
    # all bookkeeping happens back on the loop
    GUARDED_BY = {
        "effective_max_batch": "owner", "_slots": "owner",
        "_sticky": "owner", "_futures": "owner", "_chunk_tasks": "owner",
        "_bg_tasks": "owner", "_inflight_rows": "owner",
        "_over_since": "owner", "_loop": "owner", "_flusher": "owner",
        "_closed": "owner", "_wake": "owner", "_replica_up": "owner",
    }

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    async def start(self) -> "PricingGateway":
        self._loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        self._replica_up = asyncio.Event()
        self._slots = [_Slot(i, r) for i, r in enumerate(self._initial)]
        self._flusher = self._loop.create_task(self._deadline_loop(),
                                               name="gw-deadline-flusher")
        return self

    async def __aenter__(self) -> "PricingGateway":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.aclose(drain=exc == (None, None, None))

    async def aclose(self, drain: bool = True) -> None:
        if self._closed:
            return
        if drain:
            await self.drain()
        self._closed = True
        for task in [self._flusher, *self._bg_tasks, *self._chunk_tasks]:
            if task is not None:
                task.cancel()
        for task in [self._flusher, *self._bg_tasks, *self._chunk_tasks]:
            if task is not None:
                with contextlib.suppress(asyncio.CancelledError, Exception):
                    await task
        for fut in self._futures.values():
            if not fut.done():
                fut.cancel()
        for slot in self._slots:
            close = getattr(slot.replica, "close", None)
            if close is not None:
                close()
            slot.executor.shutdown(wait=False, cancel_futures=True)

    async def drain(self) -> None:
        """Force-flush everything pending and wait for delivery."""
        while True:
            for bucket in list(self.core.buckets):
                self.metrics_.bump(forced_flushes=1)
                self._dispatch_bucket(bucket, force=True)
            tasks = [t for t in self._chunk_tasks if not t.done()]
            if not tasks and not self.core.buckets:
                return
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)
            else:
                await asyncio.sleep(0)

    # ------------------------------------------------------------------ #
    # intake
    # ------------------------------------------------------------------ #
    async def submit(self, req) -> int:
        """Enqueue one contract; returns a request id whose quote (or
        error) arrives on :meth:`result`.  Raises
        :class:`GatewayOverloaded` past the shedding threshold."""
        if self._closed:
            raise GatewayError("gateway is closed")
        self._check_overload()
        rid, bucket, quote = self.core.submit(req)
        fut = self._loop.create_future()
        self._futures[rid] = fut
        if quote is not None:
            fut.set_result(quote)
        elif len(self.core.buckets[bucket]) >= self.effective_max_batch:
            self.metrics_.bump(size_flushes=1)
            self._dispatch_bucket(bucket)
        else:
            self._wake.set()        # flusher: re-aim the deadline timer
        return rid

    async def result(self, rid: int):
        """Await the quote for ``rid``; raises the request's error if its
        chunk exhausted retries."""
        fut = self._futures.get(rid)
        if fut is None:
            quote = self.core.result(rid)
            if quote is None:
                raise KeyError(f"unknown or expired request id {rid}")
            return quote
        try:
            return await fut
        finally:
            self._futures.pop(rid, None)

    def metrics(self) -> dict:
        snap = self.metrics_.snapshot()
        snap["healthy_replicas"] = sum(s.healthy for s in self._slots)
        snap["effective_max_batch"] = self.effective_max_batch
        return snap

    @property
    def metrics_(self) -> GatewayMetrics:
        return self.core.metrics_

    @property
    def pending_count(self) -> int:
        """Queued plus in-flight (dispatched, not yet delivered) rows."""
        return self.core.pending_count + self._inflight_rows

    def replica_states(self) -> List[dict]:
        return [{"name": s.name, "healthy": s.healthy,
                 "dead_reason": s.dead_reason, "calls": s.calls,
                 "sticky_buckets": len(s.sticky)} for s in self._slots]

    # ------------------------------------------------------------------ #
    # overload control: degrade (halve max_batch), then shed
    # ------------------------------------------------------------------ #
    def _check_overload(self) -> None:
        if self.overload_factor is None:
            return
        now = self.core._clock()
        healthy = max(1, sum(s.healthy for s in self._slots))
        degrade_hwm = self.overload_factor * self.max_batch * healthy
        pending = self.pending_count
        if pending >= self.shed_factor * degrade_hwm:
            self.metrics_.bump(shed=1)
            raise GatewayOverloaded(
                f"{pending} rows pending >= shed threshold "
                f"{self.shed_factor * degrade_hwm:.0f}; resubmit later")
        if pending > degrade_hwm:
            if self._over_since is None:
                self._over_since = now
            elif (now - self._over_since >= self.overload_grace_s
                  and self.effective_max_batch > self.min_batch):
                self.effective_max_batch = max(
                    self.min_batch, self.effective_max_batch // 2)
                self.metrics_.bump(degraded=1)
                self._over_since = now      # re-arm for another halving
        else:
            self._over_since = None

    def _maybe_recover_batch(self) -> None:
        if (self.overload_factor is None
                or self.effective_max_batch >= self.max_batch):
            return
        healthy = max(1, sum(s.healthy for s in self._slots))
        low_wm = self.overload_factor * self.max_batch * healthy / 4.0
        if self.pending_count < low_wm:
            self.effective_max_batch = min(self.max_batch,
                                           self.effective_max_batch * 2)
            self.metrics_.bump(restored=1)

    # ------------------------------------------------------------------ #
    # timer-driven deadline flusher
    # ------------------------------------------------------------------ #
    async def _sleep(self, seconds: float) -> None:
        if self._sleeper is not None:
            await self._sleeper(seconds)
        else:
            await asyncio.sleep(seconds)

    async def _wake_or_sleep(self, seconds: float) -> None:
        """Race the wake event (a submit changed the queue picture)
        against the timer; whichever fires first wins.  (The parameter
        is ``seconds``, not ``timeout``: this helper deliberately does
        NOT cancel the awaited work on expiry the way ``wait_for`` does
        — ruff ASYNC109 flags the misleading name.)"""
        waiter = self._loop.create_task(self._wake.wait())
        sleeper = self._loop.create_task(self._sleep(seconds))
        _, pending = await asyncio.wait({waiter, sleeper},
                                        return_when=asyncio.FIRST_COMPLETED)
        for task in pending:
            task.cancel()
        if pending:
            # reap with wait() (which never unwraps results): awaiting a
            # cancelled inner task under suppress() would also swallow an
            # *outer* cancellation landing here, wedging aclose() forever
            await asyncio.wait(pending)

    async def _deadline_loop(self) -> None:
        while True:
            self._wake.clear()
            now = self.core._clock()
            for bucket in self.core.due_buckets(now):
                self.metrics_.bump(deadline_flushes=1)
                self._dispatch_bucket(bucket, force=True)
            self._maybe_recover_batch()
            nxt = self.core.next_deadline()
            if nxt is None:
                delay = 1.0             # idle: only a submit matters,
            else:                       # and submit sets the wake event
                delay = max(nxt - self.core._clock(), 1e-4)
            await self._wake_or_sleep(delay)

    # ------------------------------------------------------------------ #
    # dispatch to replicas
    # ------------------------------------------------------------------ #
    def _dispatch_bucket(self, bucket: tuple, force: bool = False) -> None:
        while True:
            pend = self.core.buckets.get(bucket)
            if not pend or (not force
                            and len(pend) < self.effective_max_batch):
                return
            chunk = self.core.take_chunk(bucket, self.effective_max_batch)
            self._inflight_rows += chunk.n
            task = self._loop.create_task(self._run_chunk(chunk))
            self._chunk_tasks.add(task)
            task.add_done_callback(self._chunk_tasks.discard)

    def _pick_slot(self, bucket: tuple) -> Optional[_Slot]:
        cur = self._sticky.get(bucket)
        if cur is not None and cur.healthy:
            return cur
        healthy = [s for s in self._slots if s.healthy]
        if not healthy:
            return None
        slot = min(healthy, key=lambda s: (len(s.sticky), s.inflight,
                                           s.index))
        if cur is not None:
            self.metrics_.bump(affinity_moves=1)
        self._sticky[bucket] = slot
        slot.sticky.add(bucket)
        return slot

    def _mark_dead(self, slot: _Slot, reason: str, counter: str) -> None:
        if not slot.healthy:
            return
        slot.kill(reason)
        self.metrics_.bump(**{counter: 1})
        if self.restart_s is not None:
            self._spawn_bg(self._restart_slot(slot.index))

    async def _restart_slot(self, index: int) -> None:
        await self._sleep(self.restart_s)
        self._slots[index] = _Slot(index, self._factory(index))
        self.metrics_.bump(replica_restarts=1)
        self._replica_up.set()
        self._wake.set()

    def _spawn_bg(self, coro) -> None:
        task = self._loop.create_task(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    async def _await_replica(self) -> bool:
        """Wait for any healthy replica; False when none will ever come
        back (no restart policy)."""
        while not any(s.healthy for s in self._slots):
            if self.restart_s is None:
                return False
            self._replica_up.clear()
            if any(s.healthy for s in self._slots):
                break
            await self._replica_up.wait()
        return True

    async def _run_chunk(self, chunk: ChunkSpec) -> None:
        """Price one chunk with failover: bounded retries, exponential
        backoff, replica health bookkeeping."""
        attempts = 0
        while True:
            slot = self._pick_slot(chunk.bucket)
            if slot is None:
                if not await self._await_replica():
                    self._fail_chunk(chunk, GatewayError(
                        "no healthy replica and restart_s is not set"))
                    return
                continue
            slot.inflight += 1
            try:
                result = await asyncio.wait_for(
                    self._loop.run_in_executor(
                        slot.executor, slot.replica.price_chunk, chunk),
                    timeout=self.replica_timeout_s)
            except asyncio.TimeoutError:
                err = GatewayError(
                    f"replica {slot.name} hung past "
                    f"{self.replica_timeout_s}s on bucket {chunk.bucket}")
                self._mark_dead(slot, "hung", "replica_hangs")
            except asyncio.CancelledError:
                if slot.healthy:
                    # genuine outer cancellation (gateway shutdown)
                    slot.inflight -= 1
                    raise
                # the slot died while this chunk sat in its executor
                # queue — kill() cancels queued work items, and wait_for
                # re-raises that inner cancellation here.  Same failure
                # as the crash that killed the slot: requeue elsewhere.
                err = GatewayError(
                    f"replica {slot.name} died with this chunk queued "
                    f"({slot.dead_reason})")
            except ReplicaCrash as e:
                err = e
                self._mark_dead(slot, "crashed", "replica_crashes")
            except Exception as e:
                # a *request* error (e.g. OverflowError from the PWL
                # capacity check): the replica is fine, the chunk is the
                # problem — retry it, then surface on the futures
                err = e
            else:
                slot.inflight -= 1
                slot.calls += 1
                now = self.core._clock()
                done = self.core.complete(chunk, result, now,
                                          engine_seconds=result.seconds)
                self._inflight_rows -= chunk.n
                for rid, quote in done.items():
                    fut = self._futures.get(rid)
                    if fut is not None and not fut.done():
                        fut.set_result(quote)
                return
            slot.inflight -= 1
            attempts += 1
            self.metrics_.bump(requeues=1)
            if attempts > self.max_retries:
                self._fail_chunk(chunk, err)
                return
            self.metrics_.bump(retries=1)
            backoff = self.retry_backoff_s * (2.0 ** (attempts - 1))
            if backoff > 0:
                self.metrics_.bump(backoffs=1, backoff_seconds=backoff)
                await self._sleep(backoff)

    def _fail_chunk(self, chunk: ChunkSpec, err: BaseException) -> None:
        """Deliver ``err`` on every request of the chunk — failure is an
        answer too; nothing is silently dropped."""
        self._inflight_rows -= chunk.n
        self.metrics_.bump(failed=chunk.n)
        for p in chunk.requests:
            fut = self._futures.get(p.rid)
            if fut is not None and not fut.done():
                fut.set_exception(err)

    # ------------------------------------------------------------------ #
    # streaming repricing
    # ------------------------------------------------------------------ #
    async def run_stream(self, book, ticks) -> dict:
        """Consume a tick feed, incrementally requoting only the book
        rows each tick touched (see ``serve/streaming.py``).

        Each tick's touched rows are submitted as ordinary requests (so
        they coalesce into buckets, hit the result LRU, and enjoy the
        full failover machinery) and force-flushed as one natural batch;
        the tick's staleness — tick arrival to last delivered quote — is
        recorded in the metrics.  Returns a summary dict.
        """
        for tick in ticks:
            t_tick = self.core._clock()
            idx = book.apply(tick)
            self.metrics_.bump(ticks=1, rows_requoted=len(idx))
            if len(idx) == 0:
                continue
            rids = []
            for req in book.to_requests(idx):
                rids.append(await self.submit(req))
            for bucket in list(self.core.buckets):
                self.metrics_.bump(forced_flushes=1)
                self._dispatch_bucket(bucket, force=True)
            quotes = [await self.result(rid) for rid in rids]
            book.apply_quotes(idx, quotes)
            self.metrics_.add_staleness(self.core._clock() - t_tick)
        snap = self.metrics()
        return {"ticks": snap["ticks"],
                "rows_requoted": snap["rows_requoted"],
                "staleness_p50_ms": snap["staleness_p50_ms"],
                "staleness_p99_ms": snap["staleness_p99_ms"]}
