"""Continuous-batching pricing service driver.

    PYTHONPATH=src python -m repro_torch.launch.serve_pricing \\
        --qps 500 --requests 1000 --deadline-ms 5 --max-batch 64 \\
        [--n-steps 16,24] [--tc-fraction 0.0] [--backend kernel] \\
        [--device cuda|cpu] [--seed 0] [--devices W] \\
        [--gateway [--replicas N] [--pool thread|process] [--crash-at K]]

The port of the JAX package's ``launch/serve_pricing.py``, with the same
flags, plus ``--device`` (default ``cuda``: the hand-written kernels;
``cpu`` runs their plain versions).  ``--backend`` takes the port's
``kernel`` and ``torch`` and the JAX package's ``pallas`` (-> ``kernel``)
and ``jnp`` (-> ``torch``).

Synthesises a request stream (mixed payoff families, strikes, spots and
tree depths; an optional transaction-cost slice) arriving at ``--qps``,
submits it to :class:`repro_torch.serve.scheduler.PricingService`, and
ticks the deadline loop between arrivals:

    while traffic:  submit due arrivals; service.step()   # deadline tick

With ``--gateway`` the same trace goes through the asyncio
:class:`repro_torch.serve.gateway.PricingGateway` instead: ``--replicas
N`` worker replicas, a timer-driven deadline flusher, and optionally
``--crash-at K`` to kill replica 0 at its ``K``-th chunk and watch the
failover metrics (requeues, retries, restarts).  ``--pool process``
backs each replica with a spawned worker process on ``--device``
(``serve/procpool.py``): the crash is a real mid-chunk SIGKILL and the
respawn a fresh process.

Prints the service metrics (batches, p50/p99 latency, pad waste,
contracts/sec, compile-key and result-cache counters) at the end.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..serve.engine import PriceRequest
from ..serve.procpool import stop_spawn_helper
from ..serve.scheduler import PricingService


def synth_trace(n: int, *, n_steps=(16, 24), tc_fraction: float = 0.0,
                seed: int = 0) -> list:
    """A mixed synthetic trace: put/call/bull_spread x strikes x spots x
    vols x depths, with ``tc_fraction`` of requests under transaction
    costs (those stay on one shallow depth — the RZ engine is the
    expensive path and buckets separately anyway)."""
    rng = np.random.default_rng(seed)
    payoffs = ("put", "call", "bull_spread")
    reqs = []
    for _ in range(n):
        tc = rng.random() < tc_fraction
        reqs.append(PriceRequest(
            s0=float(rng.choice(np.linspace(90.0, 110.0, 9))),
            sigma=float(rng.choice((0.15, 0.2, 0.3))),
            rate=0.1,
            maturity=float(rng.choice((0.25, 0.5))),
            cost_rate=float(rng.choice((0.005, 0.01))) if tc else 0.0,
            payoff=str(rng.choice(payoffs)),
            strike=float(rng.choice((95.0, 100.0, 105.0))),
            n_steps=int(min(n_steps)) if tc else int(rng.choice(n_steps)),
        ))
    return reqs


def drive(service: PricingService, trace, *, qps: float,
          clock=time.monotonic, sleep=time.sleep) -> dict:
    """Submit ``trace`` at ``qps`` (uniform arrivals), ticking the
    deadline loop between arrivals; returns {request id: PriceQuote}."""
    gap = 1.0 / qps if qps > 0 else 0.0
    t0 = clock()
    ids = []
    for i, req in enumerate(trace):
        due = t0 + i * gap
        while clock() < due:
            service.step()
            remaining = due - clock()
            if remaining > 0:
                sleep(min(remaining, service.deadline_s / 2 or remaining))
        ids.append(service.submit(req))
        service.step()
    service.flush()
    return {rid: service.result(rid) for rid in ids}


def drive_gateway(trace, *, replicas: int, crash_at, max_batch: int,
                  deadline_ms: float, capacity: int, backend: str,
                  n_steps: int, restart_s: float = 1.0,
                  pool_kind: str = "thread", device: str = "cuda") -> tuple:
    """Replay ``trace`` through the asyncio gateway on ``device``;
    returns ({rid: quote}, metrics).  ``crash_at`` injects a replica-0
    crash at that chunk call (restarted after ``restart_s``); with
    ``pool_kind="process"`` the replicas are spawned worker processes
    and the crash is a real mid-chunk SIGKILL."""
    import asyncio

    from ..serve.gateway import PricingGateway
    from ..serve.procpool import ProcessReplica, warmup_chunk
    from ..serve.replica import FaultyReplica, LocalReplica

    if pool_kind == "process":
        wu = warmup_chunk(n_steps=n_steps, backend=backend,
                          capacity=capacity)

        def respawn(i):
            return ProcessReplica(f"replica-{i}", device=device, warmup=wu)

        def factory(i):
            faults = ({int(crash_at): "sigkill"}
                      if crash_at is not None and i == 0 else None)
            return ProcessReplica(f"replica-{i}", device=device, warmup=wu,
                                  faults=faults)
    else:
        def respawn(i):
            return LocalReplica(name=f"replica-{i}", device=device)

        def factory(i):
            if crash_at is not None and i == 0:
                return FaultyReplica(faults={int(crash_at): "crash"},
                                     name="replica-0", device=device)
            return LocalReplica(name=f"replica-{i}", device=device)
    pool = [factory(i) for i in range(replicas)]

    async def run():
        # replica_factory drives the restart_s respawn path: a crashed
        # worker comes back *healthy* and of the same pool kind
        async with PricingGateway(
                replicas=pool, max_batch=max_batch,
                deadline_ms=deadline_ms, capacity=capacity,
                backend=backend, device=device, default_n_steps=n_steps,
                restart_s=restart_s, replica_factory=respawn) as gw:
            rids = [await gw.submit(r) for r in trace]
            quotes = {rid: await gw.result(rid) for rid in rids}
            return quotes, gw.metrics()

    return asyncio.run(run())


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--qps", type=float, default=500.0,
                    help="arrival rate; 0 = submit as fast as possible")
    ap.add_argument("--requests", type=int, default=1000)
    ap.add_argument("--deadline-ms", type=float, default=5.0)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--n-steps", default="16,24",
                    help="comma-separated tree depths sampled by the trace")
    ap.add_argument("--tc-fraction", type=float, default=0.0,
                    help="fraction of requests under transaction costs")
    ap.add_argument("--backend", default="kernel",
                    choices=["kernel", "torch", "pallas", "jnp"],
                    help="kernel (the hand-written kernels; their plain "
                         "versions on the CPU) or torch (the plain level "
                         "walk); pallas and jnp are the JAX package's "
                         "names for them")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engines run (cuda raises without a "
                         "card)")
    ap.add_argument("--capacity", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=None,
                    help="route micro-batches onto a 1-D mesh of this many "
                         "devices, with measured-seconds shard rebalancing")
    ap.add_argument("--gateway", action="store_true",
                    help="replay through the asyncio multi-replica gateway "
                         "instead of the cooperative service")
    ap.add_argument("--replicas", type=int, default=2,
                    help="gateway replica count (with --gateway)")
    ap.add_argument("--pool", default="thread",
                    choices=["thread", "process"],
                    help="what backs each gateway replica: in-process "
                         "worker threads, or spawned worker processes "
                         "(a CUDA context each, warmup chunk on start, "
                         "SIGKILL-and-respawn on faults)")
    ap.add_argument("--crash-at", type=int, default=None,
                    help="inject a replica-0 crash at this chunk call "
                         "(with --gateway; restarted after 1s; with "
                         "--pool=process the crash is a real SIGKILL)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    depths = tuple(int(x) for x in args.n_steps.split(","))
    trace = synth_trace(args.requests, n_steps=depths,
                        tc_fraction=args.tc_fraction, seed=args.seed)

    if args.gateway:
        t0 = time.perf_counter()
        try:
            quotes, m = drive_gateway(
                trace, replicas=args.replicas, crash_at=args.crash_at,
                max_batch=args.max_batch, deadline_ms=args.deadline_ms,
                capacity=args.capacity, backend=args.backend,
                n_steps=depths[0], pool_kind=args.pool, device=args.device)
        finally:
            if args.pool == "process":   # no process outlives the launcher
                stop_spawn_helper()
        wall = time.perf_counter() - t0
        if m["completed"] != len(trace) or m["failed"] != 0:
            raise RuntimeError(f"gateway delivered {m['completed']} of "
                               f"{len(trace)} quotes, {m['failed']} failed")
        print(f"{len(trace)} requests through the gateway, "
              f"{args.replicas} {args.pool} replicas on {args.device}"
              + (f", crash injected at chunk {args.crash_at}"
                 if args.crash_at is not None else ""))
        print(f"  wall            : {wall:8.2f} s "
              f"({len(trace) / wall:9.1f} requests/s end-to-end)")
        print(f"  batches         : {m['batches']:8d} "
              f"(deadline {m['deadline_flushes']} / size "
              f"{m['size_flushes']})")
        print(f"  failover        : crashes={m['replica_crashes']} "
              f"requeues={m['requeues']} retries={m['retries']} "
              f"restarts={m['replica_restarts']}")
        print(f"  healthy replicas: {m['healthy_replicas']:8d}")
        print(f"  latency p50/p99 : {m['p50_latency_ms']:8.2f} / "
              f"{m['p99_latency_ms']:.2f} ms")
        sample, q = trace[0], quotes[min(quotes)]
        print(f"  e.g. {sample.payoff} K={sample.strike:g} "
              f"S0={sample.s0:g}: ask {q.ask:.6f} bid {q.bid:.6f}")
        return {"quotes": quotes, "metrics": m}

    service = PricingService(
        max_batch=args.max_batch, deadline_ms=args.deadline_ms,
        capacity=args.capacity, backend=args.backend, device=args.device,
        default_n_steps=depths[0], devices=args.devices)

    t0 = time.perf_counter()
    quotes = drive(service, trace, qps=args.qps)
    wall = time.perf_counter() - t0

    m = service.metrics()
    if m["completed"] != len(trace):
        raise RuntimeError(f"service completed {m['completed']} of "
                           f"{len(trace)} requests")
    print(f"{len(trace)} requests @ {args.qps:g} qps, "
          f"deadline {args.deadline_ms:g} ms, max batch {args.max_batch}, "
          f"backend {service.backend} on {args.device}")
    print(f"  wall            : {wall:8.2f} s "
          f"({len(trace) / wall:9.1f} requests/s end-to-end)")
    print(f"  batches         : {m['batches']:8d} "
          f"(engines {m['engine_batches']})")
    print(f"  pad waste       : {m['pad_waste']:8.1%}")
    print(f"  result cache    : {m['cache_hits']:8d} hits")
    print(f"  launch shapes   : {m['compile_hits']:8d} hits "
          f"/ {m['compile_misses']} misses")
    if args.devices:
        print(f"  shard batches   : {m['shard_batches']:8d} "
              f"(rebalances {m['rebalances']})")
    print(f"  engine time     : {m['engine_seconds']:8.2f} s "
          f"({m['contracts_per_sec']:9.1f} contracts/s in-engine)")
    print(f"  latency p50/p99 : {m['p50_latency_ms']:8.2f} / "
          f"{m['p99_latency_ms']:.2f} ms")
    sample = trace[0]
    q = quotes[min(quotes)]
    print(f"  e.g. {sample.payoff} K={sample.strike:g} "
          f"S0={sample.s0:g}: ask {q.ask:.6f} bid {q.bid:.6f}")
    return {"quotes": quotes, "metrics": m}


if __name__ == "__main__":
    main()
