"""Port parity: the asyncio gateway, its replicas and the streaming book.

* thread replicas: a ``FaultyReplica`` crash fails over and restarts,
  an overflow retries on a healthy replica, exhausted retries deliver
  the error; every quote equals the JAX package's ``PricingGateway`` on
  the same trace to 1e-9 with equal ``max_pieces``;
* the timer-driven deadline flush under a fake clock and sleeper;
* one process pool of two spawned workers on the CPU with a real
  SIGKILL of the first at its first chunk, and the spawn helper process
  reaped once the workers are closed;
* ``StreamingBook``: the same mixed book and seeded tick feed as the
  JAX package's, each tick folded into the same rows and requoted to
  JAX's quotes; incremental requotes equal a full reprice (a
  hypothesis property, and through ``run_stream``).
"""
import asyncio
import dataclasses
import multiprocessing
import os
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core  # noqa: F401  (x64)
from repro.serve.engine import PriceRequest as JPriceRequest
from repro.serve.gateway import PricingGateway as JPricingGateway
from repro.serve.streaming import StreamingBook as JStreamingBook
from repro.serve.streaming import synth_ticks as j_synth_ticks

from repro_torch.serve.engine import PriceRequest
from repro_torch.serve.gateway import GatewayError, PricingGateway
from repro_torch.serve.procpool import (ProcessReplica, _worker_main,
                                        stop_spawn_helper, warmup_chunk)
from repro_torch.serve.replica import FaultyReplica, LocalReplica
from repro_torch.serve.streaming import StreamingBook, Tick, synth_ticks

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-9
N_STEPS = 8
CAPACITY = 16


def _req(s0, cost_rate=0.0, **kw):
    return PriceRequest(s0=s0, sigma=0.25, rate=0.1, maturity=0.5,
                        cost_rate=cost_rate, n_steps=N_STEPS, **kw)


TRACE = [_req(95.0, payoff="put", strike=100.0),
         _req(100.0, payoff="call", strike=95.0),
         _req(105.0, payoff="bull_spread", strike=95.0, strike2=110.0),
         _req(98.0),
         _req(102.0, payoff="call", strike=105.0),
         _req(100.0, 0.01, payoff="put", strike=100.0),
         _req(97.0, 0.005, payoff="call", strike=95.0)]


def _run(gw_factory, trace, settle_s=0.0, inspect=None):
    async def main():
        async with gw_factory() as gw:
            rids = [await gw.submit(r) for r in trace]
            out = []
            for rid in rids:
                try:
                    out.append(await gw.result(rid))
                except Exception as e:   # delivered errors are answers
                    out.append(e)
            await asyncio.sleep(settle_s)
            m = gw.metrics()
            if inspect is not None:
                m["inspect"] = inspect()
            return out, m
    return asyncio.run(main())


@pytest.fixture(scope="module")
def jax_quotes():
    """The JAX package's gateway, two thread replicas, on the trace."""
    quotes, m = _run(lambda: JPricingGateway(
        replicas=2, max_batch=64, deadline_ms=5.0, capacity=CAPACITY,
        default_n_steps=N_STEPS),
        [JPriceRequest(**dataclasses.asdict(r)) for r in TRACE])
    assert m["completed"] == len(TRACE) and m["failed"] == 0
    return quotes


def _held(quotes, want):
    assert len(quotes) == len(want)
    for got, ref in zip(quotes, want):
        assert abs(got.ask - ref.ask) <= TOL and abs(got.bid - ref.bid) <= TOL
        assert got.max_pieces == ref.max_pieces


def _gateway(replicas, **kw):
    kw.setdefault("max_batch", 64)
    kw.setdefault("deadline_ms", 5.0)
    kw.setdefault("capacity", CAPACITY)
    kw.setdefault("default_n_steps", N_STEPS)
    kw.setdefault("retry_backoff_s", 0.0)
    return lambda: PricingGateway(replicas=replicas, device="cpu", **kw)


def test_thread_replica_crash_fails_over_and_restarts(jax_quotes):
    faulty = FaultyReplica(faults={0: "crash"}, name="r0", device="cpu")
    quotes, m = _run(_gateway(
        [faulty, LocalReplica("r1", device="cpu")], restart_s=0.01,
        replica_factory=lambda i: LocalReplica(f"r{i}", device="cpu")),
        TRACE, settle_s=0.1)
    _held(quotes, jax_quotes)
    assert m["replica_crashes"] == 1 and m["requeues"] == 1
    assert m["replica_restarts"] == 1 and m["healthy_replicas"] == 2
    assert m["completed"] == len(TRACE) and m["failed"] == 0


@pytest.mark.parametrize("faults,retries,delivered", [
    ({0: "overflow"}, 3, True),
    ({0: "overflow", 1: "overflow"}, 1, False)])
def test_overflow_retries_then_delivers_the_error(jax_quotes, faults,
                                                  retries, delivered):
    rep = FaultyReplica(faults=faults, name="r0", device="cpu")
    quotes, m = _run(_gateway([rep], max_retries=retries), TRACE[:5])
    assert m["replica_crashes"] == 0 and m["healthy_replicas"] == 1
    if delivered:
        _held(quotes, jax_quotes[:5])
        assert m["retries"] == 1
    else:
        assert all(isinstance(q, OverflowError) for q in quotes)
        assert m["failed"] == 5 and m["completed"] == 0


def test_no_replica_left_delivers_gateway_error():
    rep = FaultyReplica(faults={0: "crash"}, name="r0", device="cpu")
    quotes, m = _run(_gateway([rep]), TRACE[:2])
    assert all(isinstance(q, GatewayError) for q in quotes)
    assert m["healthy_replicas"] == 0 and m["failed"] == 2


class FakeTime:
    """Deterministic clock: time only moves when the gateway sleeps."""

    def __init__(self):
        self.t = 0.0

    def clock(self) -> float:
        return self.t

    async def sleep(self, seconds: float) -> None:
        await asyncio.sleep(0)
        self.t += seconds


def test_deadline_flush_with_fake_sleeper(jax_quotes):
    """The timer dispatches the waiting requests as one chunk a bucket
    at exactly ``t_submit + deadline``; nothing polls the gateway."""
    fake = FakeTime()
    dispatched = []

    async def main():
        async with PricingGateway(
                replicas=[LocalReplica("r0", device="cpu")], max_batch=64,
                deadline_ms=50.0, capacity=CAPACITY, device="cpu",
                default_n_steps=N_STEPS, clock=fake.clock,
                sleeper=fake.sleep) as gw:
            orig = gw._dispatch_bucket
            gw._dispatch_bucket = lambda b, force=False: (
                dispatched.append((b, fake.t)), orig(b, force))
            rids = [await gw.submit(r) for r in TRACE]
            quotes = [await gw.result(r) for r in rids]
            return quotes, gw.metrics()

    quotes, m = asyncio.run(main())
    _held(quotes, jax_quotes)
    assert sorted(dispatched) == [((N_STEPS, "notc"), pytest.approx(0.05)),
                                  ((N_STEPS, "rz"), pytest.approx(0.05))]
    assert m["deadline_flushes"] == 2 and m["size_flushes"] == 0
    assert m["batches"] == 2 and m["padded"] == 8 + 2


def test_process_pool_survives_a_real_sigkill(jax_quotes):
    """Two spawned workers on the CPU; the first SIGKILLs itself at its
    first chunk.  The chunk fails over to the second, every quote is
    delivered and equals the JAX package's."""
    wu = warmup_chunk(n_steps=N_STEPS, capacity=CAPACITY)
    pool = [ProcessReplica("p0", device="cpu", warmup=wu,
                           faults={0: "sigkill"}),
            ProcessReplica("p1", device="cpu", warmup=wu)]
    try:
        quotes, m = _run(_gateway(pool, replica_timeout_s=120.0), TRACE,
                         inspect=pool[1].memory)
    finally:
        for p in pool:
            p.close()
    _held(quotes, jax_quotes)
    assert m["replica_crashes"] == 1 and m["requeues"] >= 1
    assert m["healthy_replicas"] == 1 and m["failed"] == 0
    assert pool[0]._exitcode() == -9 and not pool[0].alive
    assert pool[1].warmup_seconds is not None and pool[1].calls >= 1
    assert m["inspect"] == {"pid": pool[1].pid, "peak_allocated": 0,
                            "reserved": 0}


def test_stop_spawn_helper_reaps_the_tracker_after_the_workers():
    """The resource tracker that spawning starts is left alone while a
    worker lives (it waits for every holder of its pipe), then stopped
    and reaped once the last worker is closed: no process outlives a
    program that calls it."""
    from multiprocessing import resource_tracker
    rep = ProcessReplica("p", device="cpu", warmup=None)
    tracker = resource_tracker._resource_tracker._pid
    try:
        assert tracker is not None and rep.alive
        assert stop_spawn_helper(timeout_s=0.2) is False
        assert resource_tracker._resource_tracker._pid == tracker
    finally:
        rep.close()
    assert stop_spawn_helper() is True
    assert resource_tracker._resource_tracker._pid is None
    with pytest.raises(ChildProcessError):   # already reaped
        os.waitpid(tracker, os.WNOHANG)

def test_worker_without_a_card_answers_err(monkeypatch):
    """A worker asked for the card where there is none answers its
    warm-up with the error and exits; it does not price on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parent, child = multiprocessing.Pipe()
    worker = threading.Thread(target=_worker_main,
                              args=(child, {"device": "cuda"}))
    parent.send(("warmup", warmup_chunk()))
    worker.start()
    assert parent.poll(60)
    msg = parent.recv()
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert msg[0] == "err" and msg[1] == "RuntimeError"
    assert "is_available" in msg[2]
    with pytest.raises(RuntimeError, match="is_available"):
        LocalReplica(device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        PricingGateway(replicas=1)


# --------------------------------------------------------------------- #
# streaming book
# --------------------------------------------------------------------- #
_BOOK = dict(n_underlyings=2, per_underlying=4, n_steps=(6, 8), sigma0=0.3)
_BOOK_FIELDS = ("underlying", "s0", "sigma", "rate", "maturity",
                "cost_rate", "payoff", "strike", "strike2", "n_steps",
                "moneyness", "vol_scale")


def _book() -> StreamingBook:
    return StreamingBook.mixed(device="cpu", **_BOOK)


def _assert_same_book(book, ref):
    np.testing.assert_allclose(book.ask, ref.ask, rtol=0, atol=TOL)
    np.testing.assert_allclose(book.bid, ref.bid, rtol=0, atol=TOL)
    np.testing.assert_array_equal(book.row_pieces, ref.row_pieces)
    assert book.max_pieces == ref.max_pieces


def test_book_ticks_and_requotes_match_jax():
    """The JAX package's ``mixed`` book and ``synth_ticks`` feed beside
    the port's: equal inputs and ticks from the same seed, each tick
    folded into the same rows (the same requests out of them), and every
    incremental requote equal to JAX's to 1e-9 with equal row_pieces.
    JAX prices its first book one underlying at a time, so it compiles
    only the shapes of a tick's requote."""
    book, jbook = _book(), JStreamingBook.mixed(**_BOOK)
    ticks = synth_ticks(16, n_underlyings=2, seed=3)
    jticks = j_synth_ticks(16, n_underlyings=2, seed=3)
    assert ([dataclasses.astuple(t) for t in ticks]
            == [dataclasses.astuple(t) for t in jticks])
    assert {t.field for t in ticks} == {"s0", "sigma"}
    book.full_reprice()
    for u in range(_BOOK["n_underlyings"]):
        jbook.requote(np.nonzero(jbook.underlying == u)[0])
    _assert_same_book(book, jbook)
    for t, jt in zip(ticks, jticks):
        idx, jidx = book.apply(t), jbook.apply(jt)
        np.testing.assert_array_equal(idx, jidx)
        for f in _BOOK_FIELDS:
            np.testing.assert_array_equal(getattr(book, f),
                                          getattr(jbook, f))
        assert ([dataclasses.asdict(r) for r in book.to_requests(idx)]
                == [dataclasses.asdict(r) for r in jbook.to_requests(jidx)])
        book.requote(idx)
        jbook.requote(jidx)
        _assert_same_book(book, jbook)


_TICK = st.one_of(
    st.builds(Tick, underlying=st.integers(0, 1), field=st.just("s0"),
              value=st.floats(90.0, 112.0)),
    st.builds(Tick, underlying=st.integers(0, 1), field=st.just("sigma"),
              value=st.floats(0.15, 0.35)))


@settings(max_examples=5, deadline=None)
@given(ticks=st.lists(_TICK, min_size=1, max_size=4))
def test_incremental_requotes_equal_full_reprice(ticks):
    book = _book()
    book.full_reprice()
    for t in ticks:
        book.requote(book.apply(t))
    ref = book.copy()
    ref.full_reprice()
    _assert_same_book(book, ref)
    assert (book.row_pieces >= 0).all()


def test_run_stream_through_gateway_equals_full_reprice():
    book = _book()
    book.full_reprice()
    ticks = synth_ticks(12, n_underlyings=2, seed=3)

    async def main():
        async with PricingGateway(
                replicas=[LocalReplica("r0", device="cpu"),
                          LocalReplica("r1", device="cpu")],
                max_batch=64, deadline_ms=5.0, capacity=48, device="cpu",
                default_n_steps=6) as gw:
            return await gw.run_stream(book, ticks)

    summary = asyncio.run(main())
    assert summary["ticks"] == 12
    assert summary["rows_requoted"] == 12 * 4
    ref = book.copy()
    ref.full_reprice()
    _assert_same_book(book, ref)
