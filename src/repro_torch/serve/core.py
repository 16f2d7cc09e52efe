"""Transport-free scheduler core shared by every serving front end.

The port of the JAX package's ``serve/core.py``.  This module is the
half of the pricing service with no opinion about *when* or *where*
work runs: request normalisation, bucket queues, the result LRU, chunk
assembly, result distribution and metrics — bookkeeping over numpy
arrays.  The transports over it are:

  * :class:`~repro_torch.serve.scheduler.PricingService` — the
    cooperative in-process driver (``submit``/``step`` price inline);
  * :class:`~repro_torch.serve.gateway.PricingGateway` — the asyncio
    multi-replica gateway (timer-driven deadline flushes, replica pool,
    fault recovery, streaming repricing).

The unit of work handed to a transport is a :class:`ChunkSpec` — one
micro-batch of one bucket, padded to a power of two, carrying plain
columns so it can cross a thread *or process* boundary — and the unit
coming back is a :class:`ChunkResult`.  :func:`execute_chunk` is the
reference executor over ``repro_torch.api.price_flat``; replicas wrap
it.

**Wire schema, version 1.**  Both chunk types encode to a versioned dict
of plain scalars, strings and tuples (numpy arrays on the result side),
the same dicts the JAX package's ``ChunkSpec``/``ChunkResult`` write:
a JAX-made chunk decodes and prices here, and a result made here decodes
in the JAX package.  Decoding rejects a *newer* version (the sender
knows fields this reader does not) and ignores unknown fields (adding a
field is not a version bump; changing the meaning of one is).

**Where a chunk runs belongs to its executor.**  Nothing device-bound
crosses the wire.  Sharding travels as a ``devices`` *count* each
executor resolves to its own mesh (``core/distributed.py``), and the
device is an argument of :func:`execute_chunk`, which every replica
passes.  A chunk's ``backend`` may carry the JAX package's names and
maps onto the port's (``"jnp"`` -> ``"torch"``, ``"pallas"`` ->
``"kernel"``); its ``interpret`` keeps the JAX package's meaning:
``True`` asks for the kernels' plain versions, which the port runs on
the CPU only, and ``False`` for the compiled kernels, on a card only
(``configs/pricing.py::execution_device``).

``ServiceMetrics`` is **thread-safe**: gateway flushes complete on
replica worker threads concurrently, so every mutation goes through
methods that hold the instance lock and :meth:`ServiceMetrics.snapshot`
reads under the same lock.  Each class carries a ``GUARDED_BY``
registry mapping its shared mutable attributes to the lock that guards
them (``"owner"`` = confined to one thread by design), as the JAX
package's classes do for its static analyzer.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..configs.pricing import BACKENDS, LEGACY_BACKENDS, execution_device
from ..core.partition import ShardPlan, _next_pow2
from ..scenarios import PAYOFF_FAMILIES, ShardExecInfo, route_engine

__all__ = ["ServiceMetrics", "SchedulerCore", "ChunkSpec", "ChunkResult",
           "execute_chunk", "chunk_device", "port_backend", "WIRE_VERSION"]

# Wire-schema version for ChunkSpec/ChunkResult dicts: decoding accepts
# any version 1..WIRE_VERSION, rejects newer, and ignores unknown fields.
WIRE_VERSION = 1


def port_backend(backend: str) -> str:
    """``backend`` in the port's names (the JAX package's ``"jnp"`` and
    ``"pallas"`` map to ``"torch"`` and ``"kernel"``); raises on any
    other name."""
    b = LEGACY_BACKENDS.get(backend, backend)
    if b not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{BACKENDS} or the JAX package's "
                         f"{tuple(LEGACY_BACKENDS)}")
    return b


def _as_tuple(x):
    """Recursively normalise lists to tuples (wire dicts that crossed a
    JSON hop come back with lists where the scheduler had tuples)."""
    if isinstance(x, (list, tuple)):
        return tuple(_as_tuple(v) for v in x)
    return x


def _check_wire(wire, kind: str, required: tuple) -> None:
    if not isinstance(wire, dict):
        raise ValueError(f"{kind} wire must be a dict, got {type(wire)}")
    v = wire.get("version")
    if not isinstance(v, int) or isinstance(v, bool) or v < 1:
        raise ValueError(f"{kind} wire has no valid version field: {v!r}")
    if v > WIRE_VERSION:
        raise ValueError(
            f"{kind} wire version {v} is newer than this process supports "
            f"({WIRE_VERSION}) — upgrade the worker, not the schema")
    got = wire.get("kind")
    if got != kind:
        raise ValueError(f"expected a {kind!r} wire dict, got {got!r}")
    missing = [k for k in required if k not in wire]
    if missing:
        raise ValueError(f"{kind} wire missing required fields {missing}")


def _plan_to_wire(plan) -> Optional[dict]:
    if plan is None:
        return None
    return {"n_shards": int(plan.n_shards), "shards": plan.shards,
            "work": plan.work, "lanes": int(plan.lanes),
            "n_rows": int(plan.n_rows)}


def _plan_from_wire(w) -> Optional[ShardPlan]:
    if w is None:
        return None
    return ShardPlan(n_shards=int(w["n_shards"]),
                     shards=_as_tuple(w["shards"]),
                     work=tuple(float(x) for x in w["work"]),
                     lanes=int(w["lanes"]), n_rows=int(w["n_rows"]))


def _shard_info_to_wire(info) -> Optional[dict]:
    if info is None:
        return None
    return {"plan": _plan_to_wire(info.plan),
            "mesh_shape": info.mesh_shape, "simulated": bool(info.simulated),
            "per_shard_pieces": info.per_shard_pieces,
            "per_shard_rows": info.per_shard_rows,
            "measured_work": info.measured_work}


def _shard_info_from_wire(w) -> Optional[ShardExecInfo]:
    if w is None:
        return None
    return ShardExecInfo(plan=_plan_from_wire(w["plan"]),
                         mesh_shape=_as_tuple(w["mesh_shape"]),
                         simulated=bool(w["simulated"]),
                         per_shard_pieces=_as_tuple(w["per_shard_pieces"]),
                         per_shard_rows=_as_tuple(w["per_shard_rows"]),
                         measured_work=_as_tuple(w["measured_work"]))


@dataclasses.dataclass(frozen=True)
class _Pending:
    rid: int
    key: tuple            # full scenario tuple (the result-cache key)
    t_submit: float


@dataclasses.dataclass
class ServiceMetrics:
    """Counters a pricing front end accumulates (all cumulative).

    Thread-safe: mutate only through :meth:`bump` / :meth:`add_latency`
    / :meth:`record_flush`; read through :meth:`snapshot`.
    """
    requests: int = 0            # single-contract requests submitted
    completed: int = 0           # ... with a result available
    batches: int = 0             # engine flushes (micro-batches priced)
    contracts: int = 0           # real (un-padded) contracts priced
    padded: int = 0              # lanes submitted to the engines
    cache_hits: int = 0          # result-LRU short-circuits
    compile_hits: int = 0        # launch shapes seen before
    compile_misses: int = 0      # launch shapes seen first
    engine_seconds: float = 0.0  # time inside the engines
    engine_batches: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"notc": 0, "rz": 0, "lsmc": 0})
    grids: int = 0               # GridRequests priced
    grid_scenarios: int = 0
    shard_batches: int = 0       # flushes routed onto the device mesh
    rebalances: int = 0          # measured-seconds feedbacks folded in
    # p50/p99 over a bounded window of recent samples, so a long-running
    # service does not grow without limit
    latencies: List[float] = dataclasses.field(default_factory=list)
    latency_window: int = 4096

    # every write outside __init__ must hold the named lock
    GUARDED_BY = {
        "requests": "_lock", "completed": "_lock", "batches": "_lock",
        "contracts": "_lock", "padded": "_lock", "cache_hits": "_lock",
        "compile_hits": "_lock", "compile_misses": "_lock",
        "engine_seconds": "_lock", "engine_batches": "_lock",
        "grids": "_lock", "grid_scenarios": "_lock",
        "shard_batches": "_lock", "rebalances": "_lock",
        "latencies": "_lock",
    }

    def __post_init__(self):
        self._lock = threading.Lock()

    def bump(self, **deltas) -> None:
        """Atomically add ``deltas`` to the named counters."""
        with self._lock:
            for name, d in deltas.items():
                setattr(self, name, getattr(self, name) + d)

    def count_engine(self, engine: str) -> None:
        with self._lock:
            self.engine_batches[engine] += 1

    def add_latency(self, seconds: float) -> None:
        with self._lock:
            self._add_latency_locked(seconds)

    def _add_latency_locked(self, seconds: float) -> None:
        self.latencies.append(seconds)
        if len(self.latencies) > 2 * self.latency_window:
            del self.latencies[:-self.latency_window]

    def record_flush(self, *, contracts: int, padded: int, engine: str,
                     seconds: float, latencies) -> None:
        """Fold one completed micro-batch in as a single atomic update."""
        with self._lock:
            self.batches += 1
            self.contracts += contracts
            self.padded += padded
            self.completed += contracts
            self.engine_seconds += seconds
            self.engine_batches[engine] += 1
            for s in latencies:
                self._add_latency_locked(s)

    def snapshot(self) -> dict:
        """One atomic, self-consistent view of every counter.

        Subclasses extend :meth:`_snapshot_locked` (not this method), so
        base and subclass fields are read under one lock acquisition."""
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:
        lat = (np.asarray(self.latencies) if self.latencies
               else np.zeros(1))
        waste = (1.0 - self.contracts / self.padded
                 if self.padded else 0.0)
        # 0.0 before any flush, not inf: the snapshot stays strict JSON
        cps = (self.contracts / self.engine_seconds
               if self.engine_seconds > 0 else 0.0)
        return {
            "requests": self.requests, "completed": self.completed,
            "batches": self.batches, "contracts": self.contracts,
            "padded": self.padded, "pad_waste": waste,
            "cache_hits": self.cache_hits,
            "compile_hits": self.compile_hits,
            "compile_misses": self.compile_misses,
            "engine_seconds": self.engine_seconds,
            "contracts_per_sec": cps,
            "engine_batches": dict(self.engine_batches),
            "grids": self.grids,
            "grid_scenarios": self.grid_scenarios,
            "shard_batches": self.shard_batches,
            "rebalances": self.rebalances,
            "p50_latency_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_latency_ms": float(np.percentile(lat, 99) * 1e3),
        }


@dataclasses.dataclass
class ChunkSpec:
    """One dispatchable micro-batch: a slice of one bucket, padded.

    Carries plain columns (s0, sigma, rate, maturity, cost_rate, payoff,
    strike, strike2 — the :func:`repro_torch.api.price_flat` signature)
    so it can cross a worker boundary without touching the scheduler's
    queues.  ``devices`` is a mesh *count* (each executor resolves its
    own mesh) and ``shard_plan`` the plan over the padded rows.
    ``n_assets``/``exercise_steps``/``n_paths``/``mc_seed``/``basis``/
    ``degree``/``antithetic`` configure the ``lsmc`` engine.
    ``interpret`` keeps the JAX package's field (``None`` = the
    executor's device decides; see the module docstring).
    """
    bucket: tuple
    requests: List[_Pending]
    n_steps: int
    engine: str
    capacity: int
    backend: str
    padded: int
    cols: tuple
    devices: Optional[int] = None
    shard_plan: Optional[ShardPlan] = None
    n_assets: int = 1
    exercise_steps: Optional[tuple] = None
    n_paths: int = 4096
    mc_seed: int = 0
    interpret: Optional[bool] = None
    basis: str = "poly"
    degree: int = 3
    antithetic: bool = True

    @property
    def n(self) -> int:
        return len(self.requests)

    _WIRE_REQUIRED = ("bucket", "requests", "n_steps", "engine", "capacity",
                      "backend", "padded", "cols")

    def to_wire(self) -> dict:
        """Encode as the versioned wire dict (plain scalars/strings/
        tuples only — JSON- and pickle-transportable)."""
        return {
            "version": WIRE_VERSION, "kind": "chunk_spec",
            "bucket": self.bucket,
            "requests": tuple((p.rid, p.key, p.t_submit)
                              for p in self.requests),
            "n_steps": int(self.n_steps), "engine": self.engine,
            "capacity": int(self.capacity), "backend": self.backend,
            "padded": int(self.padded),
            "cols": tuple(tuple(c) for c in self.cols),
            "devices": None if self.devices is None else int(self.devices),
            "shard_plan": _plan_to_wire(self.shard_plan),
            "n_assets": int(self.n_assets),
            "exercise_steps": self.exercise_steps,
            "n_paths": int(self.n_paths), "mc_seed": int(self.mc_seed),
            "interpret": self.interpret,
            "basis": str(self.basis), "degree": int(self.degree),
            "antithetic": bool(self.antithetic),
        }

    @classmethod
    def from_wire(cls, wire: dict) -> "ChunkSpec":
        """Decode a wire dict (any version up to :data:`WIRE_VERSION`;
        unknown fields are ignored, missing required fields raise).  The
        JAX package's backend names map onto the port's."""
        _check_wire(wire, "chunk_spec", cls._WIRE_REQUIRED)
        requests = [_Pending(rid=int(r[0]), key=_as_tuple(r[1]),
                             t_submit=float(r[2]))
                    for r in wire["requests"]]
        devices = wire.get("devices")
        ex = wire.get("exercise_steps")
        interpret = wire.get("interpret")
        return cls(
            bucket=_as_tuple(wire["bucket"]), requests=requests,
            n_steps=int(wire["n_steps"]), engine=str(wire["engine"]),
            capacity=int(wire["capacity"]),
            backend=port_backend(str(wire["backend"])),
            padded=int(wire["padded"]),
            cols=tuple(tuple(c) for c in wire["cols"]),
            devices=None if devices is None else int(devices),
            shard_plan=_plan_from_wire(wire.get("shard_plan")),
            n_assets=int(wire.get("n_assets", 1)),
            exercise_steps=None if ex is None else _as_tuple(ex),
            n_paths=int(wire.get("n_paths", 4096)),
            mc_seed=int(wire.get("mc_seed", 0)),
            interpret=None if interpret is None else bool(interpret),
            basis=str(wire.get("basis", "poly")),
            degree=int(wire.get("degree", 3)),
            antithetic=bool(wire.get("antithetic", True)))


@dataclasses.dataclass
class ChunkResult:
    """What comes back from pricing a :class:`ChunkSpec`.

    ``row_pieces`` is the exact per-lane peak PWL knot count over the
    padded batch (zeros on the friction-free and Monte Carlo paths), so
    every delivered quote carries its *own* ``max_pieces``.  ``seconds``
    is the executor-measured wall time of the engine call, which ends
    with the results on the host.  ``stderr`` is the per-lane Monte
    Carlo standard error (zeros from the lattice engines).
    """
    ask: np.ndarray
    bid: np.ndarray
    max_pieces: int
    row_pieces: np.ndarray
    seconds: float
    shard_info: Any = None
    stderr: Optional[np.ndarray] = None

    _WIRE_REQUIRED = ("ask", "bid", "max_pieces", "row_pieces", "seconds")

    def to_wire(self) -> dict:
        """Encode as the versioned wire dict.  Arrays stay numpy (the
        pipe pickles them efficiently); everything else is plain."""
        return {
            "version": WIRE_VERSION, "kind": "chunk_result",
            "ask": np.asarray(self.ask), "bid": np.asarray(self.bid),
            "max_pieces": int(self.max_pieces),
            "row_pieces": np.asarray(self.row_pieces),
            "seconds": float(self.seconds),
            "shard_info": _shard_info_to_wire(self.shard_info),
            "stderr": (None if self.stderr is None
                       else np.asarray(self.stderr)),
        }

    @classmethod
    def from_wire(cls, wire: dict) -> "ChunkResult":
        _check_wire(wire, "chunk_result", cls._WIRE_REQUIRED)
        se = wire.get("stderr")
        return cls(ask=np.asarray(wire["ask"]), bid=np.asarray(wire["bid"]),
                   max_pieces=int(wire["max_pieces"]),
                   row_pieces=np.asarray(wire["row_pieces"]),
                   seconds=float(wire["seconds"]),
                   shard_info=_shard_info_from_wire(wire.get("shard_info")),
                   stderr=None if se is None else np.asarray(se))


def chunk_device(chunk: ChunkSpec, device=None) -> torch.device:
    """The device ``chunk`` prices on under an executor of ``device``.

    ``device=None`` is the card, or the CPU when the chunk's
    ``interpret=True`` asks for the kernels' plain versions.  A chunk
    whose ``interpret`` contradicts the executor's device raises
    ``ValueError``: ``True`` (the plain versions) on a card, ``False``
    (the compiled kernels) on the CPU.  Nothing falls back quietly.
    """
    want, _ = execution_device(None, chunk.interpret, None)
    dev = torch.device(device if device is not None else (want or "cuda"))
    if chunk.interpret is not None and (
            (dev.type == "cpu") != bool(chunk.interpret)):
        what = ("the kernels' plain versions, on the CPU" if chunk.interpret
                else "the compiled kernels, on a card")
        raise ValueError(f"chunk asks for interpret={chunk.interpret} "
                         f"({what}) but its executor runs on {dev}")
    return dev


def execute_chunk(chunk: ChunkSpec, device=None) -> ChunkResult:
    """Price one chunk through ``repro_torch.api.price_flat`` on
    ``device`` (the reference executor: replicas and the in-process
    service route here).  ``device`` is the executor's, ``"cuda"`` by
    default; it raises without a card unless it is ``"cpu"``.  On a card
    the call runs with ``device`` current, so the kernels launch there."""
    from ..api import price_flat
    from ..configs.pricing import ExecutionConfig
    from ..core.distributed import _on
    from ..core.device import resolve_device
    dev = resolve_device(chunk_device(chunk, device))
    cols = chunk.cols
    t0 = time.perf_counter()
    with _on(dev):
        res = price_flat(
            s0=np.asarray(cols[0]), sigma=np.asarray(cols[1]),
            rate=np.asarray(cols[2]), maturity=np.asarray(cols[3]),
            cost_rate=np.asarray(cols[4]), payoff=tuple(cols[5]),
            strike=np.asarray(cols[6]), strike2=np.asarray(cols[7]),
            n_steps=chunk.n_steps, n_assets=chunk.n_assets,
            exercise_steps=chunk.exercise_steps,
            execution=ExecutionConfig(
                engine=chunk.engine, backend=port_backend(chunk.backend),
                device=str(dev), devices=chunk.devices,
                n_paths=chunk.n_paths, mc_seed=chunk.mc_seed,
                basis=chunk.basis, degree=chunk.degree,
                antithetic=chunk.antithetic),
            capacity=chunk.capacity,
            pad_to=chunk.padded, shard_plan=chunk.shard_plan)
    seconds = time.perf_counter() - t0
    rp = res.row_pieces
    rp = (np.zeros(chunk.padded, dtype=int) if rp is None
          else np.asarray(rp).ravel().astype(int))
    se = (np.zeros(chunk.padded) if res.stderr is None
          else np.asarray(res.stderr).ravel())
    return ChunkResult(ask=np.asarray(res.ask).ravel(),
                       bid=np.asarray(res.bid).ravel(),
                       max_pieces=int(res.max_pieces), row_pieces=rp,
                       seconds=seconds, shard_info=res.shard_info,
                       stderr=se)


class SchedulerCore:
    """Coalescing/bucketing/caching core, with no flush policy attached.

    Owns: request-id allocation, scenario normalisation, the bucket
    queues keyed ``(n_steps, engine)`` — plus the lsmc static config for
    MC buckets, so an lsmc bucket never coalesces with a lattice bucket
    of the same depth — the result LRU, the bounded completed-result
    store, the compile-key accounting and the shared
    :class:`ServiceMetrics`.  Transports decide *when* to call
    :meth:`take_chunk` (size trigger, deadline timer) and *where* the
    chunk executes (inline, a replica worker); they hand results back
    through :meth:`complete` or return work through :meth:`requeue`.

    ``backend`` (the port's names or the JAX package's) goes on every
    chunk; ``device`` is the device type the transport's executors run
    on, which the compile key counts.
    """

    def __init__(self, *, max_batch: int = 64, deadline_ms: float = 5.0,
                 capacity: int = 48, backend: str = "kernel",
                 device: str = "cuda",
                 default_n_steps: int = 100, default_payoff: str = "put",
                 default_strike: float = 100.0,
                 result_cache_size: int = 1024, max_results: int = 65536,
                 n_paths: int = 4096, mc_seed: int = 0,
                 basis: str = "poly", degree: int = 3,
                 antithetic: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 metrics: Optional[ServiceMetrics] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = int(max_batch)
        self.deadline_s = float(deadline_ms) * 1e-3
        self.capacity = int(capacity)
        self.backend = port_backend(backend)
        self.device = torch.device(device)
        self.default_n_steps = int(default_n_steps)
        self.default_payoff = default_payoff
        self.default_strike = float(default_strike)
        self.n_paths = int(n_paths)
        self.mc_seed = int(mc_seed)
        self.basis = str(basis)
        self.degree = int(degree)
        self.antithetic = bool(antithetic)
        self._clock = clock
        self.max_results = int(max_results)
        self.buckets: Dict[tuple, List[_Pending]] = {}
        self._results: OrderedDict = OrderedDict()
        self._result_cache: OrderedDict = OrderedDict()
        self._result_cache_size = int(result_cache_size)
        self._compiled: Dict[tuple, int] = {}
        self._next_id = 0
        self.metrics_ = metrics if metrics is not None else ServiceMetrics()

    # queue/cache state is confined to the transport's driving thread
    # (the event loop in the gateway, the caller in PricingService):
    # replica worker threads never touch the core
    GUARDED_BY = {
        "buckets": "owner", "_results": "owner", "_result_cache": "owner",
        "_compiled": "owner", "_next_id": "owner",
    }

    # ------------------------------------------------------------------ #
    # request intake
    # ------------------------------------------------------------------ #
    def scenario_key(self, req) -> tuple:
        """Normalise a PriceRequest to the full scenario tuple.

        Unset (None) payoff/strike/n_steps fields take the service
        defaults; per-request values are always honoured (they batch as
        payoff *data*, so heterogeneous batches stay one engine call).
        """
        payoff = req.payoff if req.payoff is not None else self.default_payoff
        if payoff not in PAYOFF_FAMILIES:
            raise ValueError(f"unknown payoff family {payoff!r}; "
                             f"supported: {PAYOFF_FAMILIES}")
        strike = (self.default_strike if req.strike is None
                  else float(req.strike))
        strike2 = (strike + 10.0 if getattr(req, "strike2", None) is None
                   else float(req.strike2))
        n_steps = (self.default_n_steps if req.n_steps is None
                   else int(req.n_steps))
        n_assets = int(getattr(req, "n_assets", None) or 1)
        ex = getattr(req, "exercise_steps", None)
        if ex is not None:
            from ..core.lsmc import exercise_schedule
            ex = exercise_schedule(n_steps, ex)
        return (float(req.s0), float(req.sigma), float(req.rate),
                float(req.maturity), float(req.cost_rate), payoff,
                strike, strike2, n_steps, n_assets, ex)

    def submit(self, req):
        """Enqueue one contract.

        Returns ``(rid, bucket, quote)``: a result-LRU hit completes
        inline (``bucket`` is None, ``quote`` the cached PriceQuote);
        otherwise the request joined ``bucket``'s queue and the caller
        decides whether its length warrants a size-trigger flush.
        """
        key = self.scenario_key(req)
        rid = self._next_id
        self._next_id += 1
        self.metrics_.bump(requests=1)
        now = self._clock()
        if key in self._result_cache:
            self._result_cache.move_to_end(key)
            quote = self._result_cache[key]
            self.store_result(rid, quote)
            self.metrics_.bump(cache_hits=1, completed=1)
            self.metrics_.add_latency(self._clock() - now)
            return rid, None, quote
        bucket = self.bucket_key(key)
        self.buckets.setdefault(bucket, []).append(
            _Pending(rid=rid, key=key, t_submit=now))
        return rid, bucket, None

    @staticmethod
    def bucket_key(key: tuple) -> tuple:
        """Queue identity of a normalised scenario tuple.

        ``(n_steps, engine)`` — the engine name: an lsmc bucket never
        coalesces with a lattice bucket of the same depth, and lsmc
        buckets also key on their static MC shape ``(n_assets,
        exercise_steps)``.  Whatever changes the engine's program splits
        the bucket; array data (strike, payoff family, spot, vol, rate)
        does not."""
        engine = route_engine(any_tc=key[4] > 0.0, n_assets=key[9],
                              exercise_steps=key[10])
        return ((key[8], engine) if engine != "lsmc"
                else (key[8], "lsmc", key[9], key[10]))

    # ------------------------------------------------------------------ #
    # chunk lifecycle
    # ------------------------------------------------------------------ #
    def take_chunk(self, bucket: tuple,
                   limit: Optional[int] = None) -> Optional[ChunkSpec]:
        """Pop up to ``limit`` (default ``max_batch``) oldest requests of
        ``bucket`` as a dispatchable :class:`ChunkSpec` (None if empty)."""
        pending = self.buckets.get(bucket)
        if not pending:
            return None
        limit = self.max_batch if limit is None else max(1, int(limit))
        chunk_reqs, rest = pending[:limit], pending[limit:]
        if rest:
            self.buckets[bucket] = rest
        else:
            self.buckets.pop(bucket, None)
        n_steps, engine = bucket[0], bucket[1]
        # only the 8 price_flat columns cross the worker boundary; the
        # bucket-constant tail (n_steps, n_assets, schedule) rides as
        # chunk fields
        cols = tuple(zip(*(p.key[:8] for p in chunk_reqs)))
        return ChunkSpec(bucket=bucket, requests=chunk_reqs,
                         n_steps=n_steps, engine=engine,
                         capacity=self.capacity, backend=self.backend,
                         padded=_next_pow2(len(chunk_reqs)), cols=cols,
                         n_assets=bucket[2] if engine == "lsmc" else 1,
                         exercise_steps=(bucket[3] if engine == "lsmc"
                                         else None),
                         n_paths=self.n_paths, mc_seed=self.mc_seed,
                         basis=self.basis, degree=self.degree,
                         antithetic=self.antithetic)

    def requeue(self, chunk: ChunkSpec) -> None:
        """Return a chunk's requests to the *front* of their bucket (no
        request is ever silently lost on an engine/replica failure)."""
        self.buckets[chunk.bucket] = (list(chunk.requests)
                                      + self.buckets.get(chunk.bucket, []))

    def complete(self, chunk: ChunkSpec, res: ChunkResult, now: float, *,
                 engine_seconds: Optional[float] = None) -> Dict[int, Any]:
        """Distribute one chunk's results; returns ``{rid: PriceQuote}``.

        Each quote carries its row's exact ``row_pieces`` as
        ``max_pieces``: lanes are independent in the grid engines.
        """
        from ..api import PriceQuote
        seconds = res.seconds if engine_seconds is None else engine_seconds
        done: Dict[int, Any] = {}
        lats = []
        se = res.stderr
        for i, p in enumerate(chunk.requests):
            quote = PriceQuote(ask=float(res.ask[i]), bid=float(res.bid[i]),
                               max_pieces=int(res.row_pieces[i]),
                               stderr=float(se[i]) if se is not None else 0.0)
            self.store_result(p.rid, quote)
            done[p.rid] = quote
            self.remember(p.key, quote)
            lats.append(now - p.t_submit)
        self.metrics_.record_flush(contracts=chunk.n, padded=chunk.padded,
                                  engine=chunk.engine, seconds=seconds,
                                  latencies=lats)
        plan = chunk.shard_plan
        self.compile_key_seen(chunk.padded, chunk.n_steps, chunk.engine,
                              False, backend=chunk.backend,
                              device=chunk_device(chunk, self.device).type,
                              shard=(plan.n_shards, plan.lanes)
                              if plan is not None else None,
                              extra=self.chunk_compile_extra(chunk),
                              devices=chunk.devices)
        return done

    @staticmethod
    def chunk_compile_extra(chunk: ChunkSpec) -> Optional[tuple]:
        """The lsmc static config that shapes its program, appended to the
        compile key so two MC chunks differing only in path count,
        schedule or regression design never count as one."""
        if chunk.engine != "lsmc":
            return None
        return (chunk.n_paths, chunk.n_assets, chunk.exercise_steps,
                chunk.basis, chunk.degree, chunk.antithetic)

    def compile_key(self, padded: int, n_steps: int, engine: str,
                    greeks: bool, *, backend: Optional[str] = None,
                    device: Optional[str] = None,
                    devices: Optional[int] = None,
                    shard: Optional[tuple] = None,
                    extra: Optional[tuple] = None) -> tuple:
        """The program identity tuple: padded rows, depth, engine, the
        resolved ``(backend, device type)`` pair, greeks, capacity, mesh
        width, shard shape and the lsmc statics.

        The JAX package keys its XLA compiles here; the port builds each
        CUDA kernel once a process, so on the card a key counts a
        distinct *launch shape* (the rows, lanes and round plan its
        launches take), and ``compile_hits``/``compile_misses`` count
        calls at a shape seen before and at a new one."""
        return (padded, n_steps, engine,
                self.backend if backend is None else port_backend(backend),
                self.device.type if device is None
                else torch.device(device).type, greeks,
                self.capacity, devices, shard, extra)

    @staticmethod
    def chunk_compile_key(chunk: ChunkSpec, greeks: bool = False,
                          device=None) -> tuple:
        """Compile key of a fully-specified :class:`ChunkSpec` under an
        executor of ``device`` (every other field read off the chunk, so
        two schedulers agree on a chunk's key)."""
        plan = chunk.shard_plan
        return (chunk.padded, chunk.n_steps, chunk.engine,
                port_backend(chunk.backend), chunk_device(chunk, device).type,
                greeks, chunk.capacity, chunk.devices,
                (plan.n_shards, plan.lanes) if plan is not None else None,
                SchedulerCore.chunk_compile_extra(chunk))

    def compile_key_seen(self, padded: int, n_steps: int, engine: str,
                         greeks: bool, backend: Optional[str] = None,
                         device: Optional[str] = None,
                         shard: Optional[tuple] = None,
                         extra: Optional[tuple] = None,
                         devices: Optional[int] = None) -> None:
        """Count a *successful* engine call against its key.  Called only
        after the call returns: a failed call (a capacity overflow) ran
        nothing worth counting, and raising ``capacity`` (part of the
        key) then retrying is a new shape, not a hit."""
        ck = self.compile_key(padded, n_steps, engine, greeks,
                              backend=backend, device=device,
                              devices=devices, shard=shard, extra=extra)
        if ck in self._compiled:
            self._compiled[ck] += 1
            self.metrics_.bump(compile_hits=1)
        else:
            self._compiled[ck] = 1
            self.metrics_.bump(compile_misses=1)

    # ------------------------------------------------------------------ #
    # results / caches
    # ------------------------------------------------------------------ #
    def store_result(self, rid: int, quote) -> None:
        """Keep completed quotes retrievable via :meth:`result`, bounded
        to the most recent ``max_results``."""
        self._results[rid] = quote
        while len(self._results) > self.max_results:
            self._results.popitem(last=False)

    def remember(self, key: tuple, quote) -> None:
        if self._result_cache_size <= 0:
            return
        self._result_cache[key] = quote
        self._result_cache.move_to_end(key)
        while len(self._result_cache) > self._result_cache_size:
            self._result_cache.popitem(last=False)

    def result(self, rid: int):
        return self._results.get(rid)

    @property
    def pending_count(self) -> int:
        return sum(len(p) for p in self.buckets.values())

    # ------------------------------------------------------------------ #
    # deadline bookkeeping (policy-free: transports ask, then act)
    # ------------------------------------------------------------------ #
    def due_buckets(self, now: float) -> List[tuple]:
        """Buckets whose oldest request has waited at least the deadline."""
        return [b for b, pend in self.buckets.items()
                if pend and now - pend[0].t_submit >= self.deadline_s]

    def next_deadline(self) -> Optional[float]:
        """Absolute clock time the earliest pending deadline expires
        (None when no request is queued) — what a timer sleeps until."""
        oldest = [pend[0].t_submit for pend in self.buckets.values() if pend]
        return min(oldest) + self.deadline_s if oldest else None
