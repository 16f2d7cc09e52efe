"""Continuous-batching pricing service over the grid engines.

The port of the JAX package's ``serve/scheduler.py``.  A
:class:`PricingService` accepts a *stream* of single-contract
:class:`~repro_torch.serve.engine.PriceRequest`\\ s (plus whole
:class:`~repro_torch.serve.engine.GridRequest`\\ s), coalesces them
across payoff family and strike — the payoff is data
(``core/payoff.py::param_payoff``), so a heterogeneous batch is one
engine call — and flushes micro-batches through
``repro_torch.api.price_flat`` on a **size-or-deadline** trigger:

    submit() ──► bucket queues (n_steps, engine) ──► pad to 2^k
        ──► engine="auto" (no-TC lattice | Roux–Zastawniak | LSMC) ──►
        unpad ──► per-request PriceQuote + latency sample

* **Buckets.**  Requests queue by ``(n_steps, engine)``: tree depth and
  engine change the launches.  Multi-asset or Bermudan requests go to
  ``lsmc`` and also key on ``(n_assets, exercise_steps)``.  Payoff
  family, strike, spot, vol, rate, maturity and cost rate are *data*.
* **Padding.**  A flushed batch is padded to the next power of two (by
  repeating its last row), so traffic hits at most
  ``log2(max_batch)+1`` launch shapes a bucket.
* **Triggers.**  A bucket flushes when it reaches ``max_batch`` (inside
  :meth:`submit`) or when its oldest request has waited ``deadline_ms``
  (inside :meth:`step`, which the driver loop calls each tick).
  :meth:`flush` force-drains.
* **Caches.**  The compile-key counters count launch shapes seen before
  and new ones (``serve/core.py::SchedulerCore.compile_key``); a small
  LRU *result cache* keyed on the full scenario tuple short-circuits
  repeat scenarios.
* **Device.**  Every chunk runs on the service's ``device``
  (``"cuda"`` by default: the hand-written kernels; it raises without a
  card unless ``device="cpu"``, which runs their plain versions).
* **Device mesh.**  ``devices=``/``mesh=`` route every flushed
  micro-batch (and every :meth:`price_grid` call) onto a 1-D mesh: each
  flush is planned by the cost model (``core/partition.py``), and after
  the flush the measured seconds feed back through
  :class:`~repro_torch.core.partition.ShardRebalancer`.  A chunk carries
  the mesh *count*; its executor resolves its own mesh.

The asyncio multi-replica front end over the same core is
``serve/gateway.py::PricingGateway``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np

from ..configs.pricing import ExecutionConfig, execution_device
from ..core.device import resolve_device
from ..core.partition import _next_pow2
from .core import SchedulerCore, ServiceMetrics, execute_chunk, port_backend

__all__ = ["PricingService", "ServiceMetrics"]


def execution_knobs(execution: Optional[ExecutionConfig], **knobs) -> dict:
    """``knobs`` (the service's individual kwargs) with every field set on
    ``execution`` winning over its kwarg; ``engine`` and ``devices`` come
    along where ``execution`` sets them."""
    if execution is not None:
        for name in execution.set_fields():
            knobs[name] = getattr(execution, name)
    return knobs


class PricingService:
    """Continuous-batching front end for the grid engines."""

    def __init__(self, *, max_batch: int = 64, deadline_ms: float = 5.0,
                 capacity: int = 48, backend: str = "kernel",
                 device: str = "cuda",
                 default_n_steps: int = 100, default_payoff: str = "put",
                 default_strike: float = 100.0,
                 result_cache_size: int = 1024, max_results: int = 65536,
                 min_grid_bucket: Optional[int] = None,
                 n_paths: int = 4096, mc_seed: int = 0,
                 devices: Optional[int] = None, mesh=None,
                 rebalance_ema: float = 0.5,
                 execution: Optional[ExecutionConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        # execution= is the consolidated knob surface: any field set on it
        # overrides the corresponding individual kwarg
        k = execution_knobs(execution, backend=backend, device=device,
                            n_paths=n_paths, mc_seed=mc_seed,
                            devices=devices, basis="poly", degree=3,
                            antithetic=True)
        self.device = resolve_device(k["device"])
        self.core = SchedulerCore(
            max_batch=max_batch, deadline_ms=deadline_ms, capacity=capacity,
            backend=k["backend"], device=self.device.type,
            default_n_steps=default_n_steps,
            default_payoff=default_payoff, default_strike=default_strike,
            result_cache_size=result_cache_size, max_results=max_results,
            n_paths=k["n_paths"], mc_seed=k["mc_seed"], basis=k["basis"],
            degree=k["degree"], antithetic=k["antithetic"], clock=clock)
        if k["devices"] is not None or mesh is not None:
            from ..core.distributed import resolve_grid_mesh
            from ..core.partition import ShardRebalancer
            self._mesh, self._n_shards = resolve_grid_mesh(
                k["devices"], mesh, kind=self.device.type)
            self._rebalancer = (ShardRebalancer(ema=rebalance_ema)
                                if self._n_shards > 1 else None)
        else:
            self._mesh, self._n_shards = None, 1
            self._rebalancer = None
        self.min_grid_bucket = (self.max_batch if min_grid_bucket is None
                                else int(min_grid_bucket))
        self._clock = clock
        self._deferred_error: Optional[BaseException] = None

    # driven cooperatively by one caller thread (submit/step/flush)
    GUARDED_BY = {"_deferred_error": "owner"}

    # core-owned configuration/state, under the JAX package's names
    @property
    def max_batch(self) -> int:
        return self.core.max_batch

    @property
    def deadline_s(self) -> float:
        return self.core.deadline_s

    @property
    def capacity(self) -> int:
        return self.core.capacity

    @property
    def backend(self) -> str:
        return self.core.backend

    @property
    def default_n_steps(self) -> int:
        return self.core.default_n_steps

    @property
    def default_payoff(self) -> str:
        return self.core.default_payoff

    @property
    def default_strike(self) -> float:
        return self.core.default_strike

    @property
    def max_results(self) -> int:
        return self.core.max_results

    @property
    def metrics_(self) -> ServiceMetrics:
        return self.core.metrics_

    @property
    def _compiled(self) -> Dict[tuple, int]:
        return self.core._compiled

    # ------------------------------------------------------------------ #
    # request intake
    # ------------------------------------------------------------------ #
    def submit(self, req) -> int:
        """Enqueue one contract; returns a request id.

        Flushes the request's bucket inline if it reaches ``max_batch``
        (size trigger).  A result-cache hit completes immediately.
        """
        rid, bucket, _ = self.core.submit(req)
        if (bucket is not None
                and len(self.core.buckets[bucket]) >= self.max_batch):
            # an engine error here must not swallow the request id the
            # caller is owed: the chunk is already re-queued by
            # _flush_bucket, so defer the exception to the next
            # step()/flush() and hand the rid back
            try:
                self._flush_bucket(bucket)
            except Exception as e:
                self._deferred_error = e
        return rid

    # ------------------------------------------------------------------ #
    # device-mesh shard planning / rebalance hook
    # ------------------------------------------------------------------ #
    def _shard_plan(self, bucket: tuple, cost_rates, n_steps: int,
                    padded: int):
        """Cost-model shard plan for one padded micro-batch (None when
        the service runs single-device).  Lanes round up to a power of
        two, so each bucket's flushes reuse a few per-device shapes."""
        if self._rebalancer is None:
            return None
        cr = np.asarray(cost_rates, np.float64)
        cr = np.concatenate([cr, np.repeat(cr[-1:], padded - cr.shape[0])])
        lsmc = bucket[1] == "lsmc"
        return self._shard_plan_from_costs(
            bucket, n_steps, cr, engine=bucket[1],
            n_assets=bucket[2] if lsmc else 1,
            exercise_steps=bucket[3] if lsmc else None)

    def _shard_plan_from_costs(self, key, n_steps: int, cost_rates_padded,
                               *, copies: int = 1, engine: str = "notc",
                               n_assets: int = 1, exercise_steps=None):
        """Rebalancer-steered plan over a padded batch's cost-model costs
        (``copies`` > 1 tiles for the greeks bump blocks)."""
        from ..core.partition import scenario_costs
        n_ex = None if exercise_steps is None else len(exercise_steps)
        costs = scenario_costs(n_steps, cost_rates_padded,
                               capacity=self.capacity,
                               engine=engine if engine == "lsmc" else None,
                               n_paths=self.core.n_paths, n_exercise=n_ex,
                               n_assets=n_assets)
        if copies > 1:
            costs = np.tile(costs, copies)
        return self._rebalancer.plan(key, costs, self._n_shards,
                                     lanes_pow2=True)

    def _observe_flush(self, bucket: tuple, res, seconds: float) -> None:
        """Fold one sharded flush's measurement into the rebalancer: the
        flush's seconds attributed by each shard's *measured* work (the
        cost model re-evaluated with the measured ``max_pieces``)."""
        info = getattr(res, "shard_info", None)
        if self._rebalancer is None or info is None:
            return
        self.metrics_.bump(shard_batches=1)
        work = np.asarray(info.measured_work, np.float64)
        if work.sum() <= 0 or seconds <= 0:
            return                   # nothing measurable to fold in
        per_shard = seconds * work / work.sum()
        self._rebalancer.observe(bucket, info.plan, per_shard)
        self.metrics_.bump(rebalances=1)

    def observe_shard_seconds(self, bucket: tuple, plan,
                              per_shard_seconds) -> None:
        """Feed externally measured per-shard seconds (e.g. from a device
        profiler) into the rebalance loop for ``bucket``."""
        if self._rebalancer is None:
            raise ValueError("service is not sharded (pass devices=/mesh=)")
        self._rebalancer.observe(bucket, plan, per_shard_seconds)
        self.metrics_.bump(rebalances=1)

    def shard_speed(self, bucket: tuple):
        """Current per-device speed estimates for ``bucket`` (None when
        single-device) — what the next flush's plan will steer by."""
        if self._rebalancer is None:
            return None
        return self._rebalancer.speed(bucket, self._n_shards)

    def _prepare_chunk(self, chunk, bucket: tuple) -> None:
        """Attach the service's sharding to a drained chunk: ``devices``
        is a plain *count*, never the service's mesh, so the chunk
        pickles cleanly and its executor builds its own mesh."""
        chunk.devices = self._n_shards if self._n_shards > 1 else None
        chunk.shard_plan = self._shard_plan(
            bucket, chunk.cols[4], chunk.n_steps, chunk.padded)

    def _flush_bucket(self, bucket: tuple) -> Dict[int, "PriceQuote"]:
        done: Dict[int, "PriceQuote"] = {}
        while True:
            chunk = self.core.take_chunk(bucket, self.max_batch)
            if chunk is None:
                break
            self._prepare_chunk(chunk, bucket)
            t0 = self._clock()
            try:
                res = execute_chunk(chunk, device=self.device)
            except Exception:
                # no request is ever silently lost: re-queue this chunk
                # (the rest of the bucket is still queued behind it),
                # then surface the error (e.g. a PWL OverflowError —
                # raise `capacity` and flush again)
                self.core.requeue(chunk)
                raise
            now = self._clock()
            self._observe_flush(bucket, res, now - t0)
            # the service measures engine time with its own clock (the
            # fake-clock tests steer it); replica workers report the
            # executor-measured res.seconds to the gateway
            done.update(self.core.complete(chunk, res, now,
                                           engine_seconds=now - t0))
        return done

    def _raise_deferred(self) -> None:
        if self._deferred_error is not None:
            e, self._deferred_error = self._deferred_error, None
            raise e

    def step(self, now: Optional[float] = None) -> Dict[int, "PriceQuote"]:
        """Deadline tick: flush every bucket whose oldest request has
        waited at least ``deadline_ms``; returns the quotes this tick
        completed.  An engine error deferred from a ``submit``
        size-trigger flush re-raises here."""
        self._raise_deferred()
        now = self._clock() if now is None else now
        done: Dict[int, "PriceQuote"] = {}
        for bucket in self.core.due_buckets(now):
            done.update(self._flush_bucket(bucket))
        return done

    def flush(self) -> Dict[int, "PriceQuote"]:
        """Force-flush every pending bucket; returns the quotes this call
        completed (look earlier ones up with :meth:`result`).  An engine
        error deferred from a ``submit`` size-trigger flush re-raises
        here."""
        self._raise_deferred()
        done: Dict[int, "PriceQuote"] = {}
        for bucket in list(self.core.buckets):
            done.update(self._flush_bucket(bucket))
        return done

    # ------------------------------------------------------------------ #
    # results / introspection
    # ------------------------------------------------------------------ #
    def result(self, rid: int):
        """The :class:`~repro_torch.api.PriceQuote` for ``rid`` (None if
        still pending — call :meth:`step` or :meth:`flush`)."""
        return self.core.result(rid)

    @property
    def pending_count(self) -> int:
        return self.core.pending_count

    def metrics(self) -> dict:
        return self.core.metrics_.snapshot()

    # ------------------------------------------------------------------ #
    # whole-grid requests (cartesian surfaces)
    # ------------------------------------------------------------------ #
    def price_grid(self, req):
        """Price a :class:`~repro_torch.serve.engine.GridRequest` now.

        Grids are already batches, so they bypass the queues; they pad to
        a power of two (at least ``min_grid_bucket``) and route by
        ``engine="auto"``.  The request's ``execution`` fields win over
        its ``backend``/``interpret`` and the service's settings; its
        ``backend=None`` is the service's.
        """
        from ..api import price_grid
        from ..scenarios import GridResult, ScenarioGrid, route_engine
        grid = ScenarioGrid.cartesian(
            s0=req.s0, sigma=req.sigma, rate=req.rate,
            maturity=req.maturity, cost_rate=req.cost_rate,
            payoff=req.payoff, strike=req.strike, strike2=req.strike2,
            n_steps=req.n_steps, n_assets=getattr(req, "n_assets", 1),
            exercise_steps=getattr(req, "exercise_steps", None))
        n = grid.n_scenarios
        bucket = max(self.min_grid_bucket, _next_pow2(n))
        engine = route_engine(any_tc=bool(np.any(grid.cost_rate > 0.0)),
                              n_assets=grid.n_assets,
                              exercise_steps=grid.exercise_steps)
        c = self.core
        want, backend = execution_device(
            None, getattr(req, "interpret", None),
            req.backend if req.backend is not None else c.backend)
        k = execution_knobs(
            getattr(req, "execution", None), engine="auto",
            backend=backend, device=want or str(self.device),
            n_paths=c.n_paths, mc_seed=c.mc_seed, basis=c.basis,
            degree=c.degree, antithetic=c.antithetic)
        if k["engine"] != "auto":
            engine = k["engine"]
        backend = port_backend(k["backend"])
        device = resolve_device(k["device"])
        # grids rebalance under their own stream key (greeks bump the
        # batch 5x: the plan covers the bumped rows)
        gkey = ("grid", grid.n_steps, engine)
        plan = None
        if self._rebalancer is not None:
            cr = np.concatenate([grid.cost_rate,
                                 np.repeat(grid.cost_rate[-1:],
                                           bucket - n)])
            plan = self._shard_plan_from_costs(
                gkey, grid.n_steps, cr, copies=5 if req.greeks else 1,
                engine=engine, n_assets=grid.n_assets,
                exercise_steps=grid.exercise_steps)
        t0 = self._clock()
        cfg = ExecutionConfig(
            engine=engine, backend=backend, device=str(device),
            n_paths=k["n_paths"], mc_seed=k["mc_seed"], basis=k["basis"],
            degree=k["degree"], antithetic=k["antithetic"])
        res = price_grid(grid.pad_to(bucket), execution=cfg,
                         capacity=self.capacity, greeks=req.greeks,
                         mesh=self._mesh, shard_plan=plan)
        elapsed = self._clock() - t0
        self.metrics_.bump(engine_seconds=elapsed, grids=1,
                           grid_scenarios=n)
        self._observe_flush(gkey, res, elapsed)
        info = res.shard_info
        # the key reads the *resolved* lsmc knobs: a per-request override
        # runs another program than the service default
        c.compile_key_seen(bucket, grid.n_steps, engine, req.greeks,
                           backend=backend, device=device.type,
                           shard=(info.plan.n_shards, info.plan.lanes)
                           if info else None,
                           extra=((k["n_paths"], grid.n_assets,
                                   grid.exercise_steps, k["basis"],
                                   k["degree"], k["antithetic"])
                                  if engine == "lsmc" else None),
                           devices=(self._n_shards
                                    if self._n_shards > 1 else None))
        self.metrics_.count_engine(engine)
        cut = lambda a: (None if a is None
                         else a.ravel()[:n].reshape(grid.shape))
        rp = getattr(res, "row_pieces", None)
        se = getattr(res, "stderr", None)
        return GridResult(
            grid=grid, ask=cut(res.ask), bid=cut(res.bid),
            max_pieces=res.max_pieces,
            delta_ask=cut(res.delta_ask), delta_bid=cut(res.delta_bid),
            vega_ask=cut(res.vega_ask), vega_bid=cut(res.vega_bid),
            shard_info=res.shard_info,
            row_pieces=None if rp is None else cut(np.asarray(rp)),
            stderr=None if se is None else cut(np.asarray(se)),
            engine=getattr(res, "engine", engine))
