"""Port parity: the pricing service, the engine adapter and the launcher.

The port's ``PricingService`` (on the CPU: the kernels' plain versions,
or the plain level walk) is held to the JAX package's ``PricingService``
on the same contracts, to 1e-9 on ask and bid with equal per-quote
``max_pieces``: under a fake clock's deadline flush, the size trigger,
a heterogeneous batch padded and unpadded, and the transaction-cost
bucket.  Rows are independent, so every batching of the trace must
give JAX's quotes.  Then the deferred-error requeue, ``devices=2``
routing, ``PricingEngine``, ``GridRequest`` routing and the
``serve_pricing`` launcher with ``--device cpu``, whose trace and quotes
are held to the JAX package's launcher trace and service.
"""
import dataclasses

import numpy as np
import pytest

import repro.core  # noqa: F401  (x64)
from repro.serve.engine import PriceRequest as JPriceRequest
from repro.launch.serve_pricing import synth_trace as j_synth_trace
from repro.serve.scheduler import PricingService as JPricingService

from repro_torch import api
from repro_torch.launch import serve_pricing as launch
from repro_torch.serve import scheduler as TSched
from repro_torch.serve.engine import GridRequest, PriceRequest, PricingEngine
from repro_torch.serve.scheduler import PricingService

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-9
N_STEPS = 8
CAPACITY = 16


def _req(s0, cost_rate=0.0, **kw):
    return PriceRequest(s0=s0, sigma=0.25, rate=0.1, maturity=0.5,
                        cost_rate=cost_rate, n_steps=N_STEPS, **kw)


# six friction-free contracts of three families, three under costs
NOTC = [_req(95.0, payoff="put", strike=100.0),
        _req(100.0, payoff="call", strike=95.0),
        _req(105.0, payoff="bull_spread", strike=95.0, strike2=110.0),
        _req(98.0),                              # service defaults
        _req(102.0, payoff="call", strike=105.0),
        _req(110.0, payoff="put", strike=105.0)]
TC = [_req(100.0, 0.01, payoff="put", strike=100.0),
      _req(97.0, 0.005, payoff="call", strike=95.0),
      _req(103.0, 0.01, payoff="bull_spread", strike=95.0)]
TRACE = NOTC + TC


@pytest.fixture(scope="module")
def jax_quotes():
    """The JAX package's service on the trace: one notc chunk padded to
    8 and one rz chunk padded to 4 (two JAX compiles)."""
    svc = JPricingService(max_batch=64, capacity=CAPACITY,
                          default_n_steps=N_STEPS, default_payoff="put",
                          default_strike=100.0)
    ids = [svc.submit(JPriceRequest(**dataclasses.asdict(r)))
           for r in TRACE]
    svc.flush()
    assert svc.metrics()["padded"] == 8 + 4
    return [svc.result(i) for i in ids]


def _held(quotes, want):
    assert len(quotes) == len(want)
    for got, ref in zip(quotes, want):
        assert abs(got.ask - ref.ask) <= TOL and abs(got.bid - ref.bid) <= TOL
        assert got.max_pieces == ref.max_pieces


def _svc(**kw):
    kw.setdefault("capacity", CAPACITY)
    kw.setdefault("device", "cpu")
    kw.setdefault("default_n_steps", N_STEPS)
    return PricingService(**kw)


@pytest.mark.parametrize("backend", ["kernel", "torch", "jnp"])
def test_deadline_flush_on_fake_clock_matches_jax(jax_quotes, backend):
    t = [0.0]
    svc = _svc(max_batch=64, deadline_ms=10.0, backend=backend,
               clock=lambda: t[0])
    assert svc.backend == {"jnp": "torch"}.get(backend, backend)
    ids = [svc.submit(r) for r in TRACE]
    t[0] = 0.005
    assert svc.step() == {} and svc.pending_count == len(TRACE)
    t[0] = 0.011
    done = svc.step()
    assert svc.pending_count == 0 and sorted(done) == ids
    _held([svc.result(i) for i in ids], jax_quotes)
    m = svc.metrics()
    assert m["batches"] == 2 and m["padded"] == 8 + 4
    assert m["engine_batches"] == {"notc": 1, "rz": 1, "lsmc": 0}
    assert m["p50_latency_ms"] == pytest.approx(11.0)


def test_size_trigger_and_heterogeneous_pad_unpad_match_jax(jax_quotes):
    """max_batch 4: the fourth friction-free request flushes inside
    submit; the remaining 2 + 3 pad to 2 and 4 and unpad per request."""
    svc = _svc(max_batch=4, deadline_ms=1e9)
    ids = [svc.submit(r) for r in TRACE]
    m = svc.metrics()
    assert m["batches"] == 1 and m["completed"] == 4
    svc.flush()
    _held([svc.result(i) for i in ids], jax_quotes)
    m = svc.metrics()
    assert m["batches"] == 3 and m["padded"] == 4 + 2 + 4
    assert m["pad_waste"] == pytest.approx(1 - 9 / 10)


def test_tc_bucket_alone_matches_jax(jax_quotes):
    svc = _svc(max_batch=64)
    ids = [svc.submit(r) for r in TC]
    svc.flush()
    quotes = [svc.result(i) for i in ids]
    _held(quotes, jax_quotes[len(NOTC):])
    assert max(q.max_pieces for q in quotes) > 1
    assert all(q.ask >= q.bid for q in quotes)


def test_engine_error_requeues_and_defers(monkeypatch):
    """An engine error at a size-trigger flush is deferred to the next
    flush(); no request is lost, and the retry prices them all."""
    svc = _svc(max_batch=4)
    real = TSched.execute_chunk
    calls = {"n": 0}

    def flaky(chunk, device=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OverflowError("injected PWL capacity overflow")
        return real(chunk, device=device)

    monkeypatch.setattr(TSched, "execute_chunk", flaky)
    ids = [svc.submit(r) for r in NOTC[:4]]     # size trigger fails
    assert svc.pending_count == 4 and svc.result(ids[0]) is None
    with pytest.raises(OverflowError, match="injected"):
        svc.flush()
    assert svc.pending_count == 4
    svc.flush()
    assert svc.pending_count == 0
    assert all(svc.result(i) is not None for i in ids)
    # a real capacity overflow requeues the same way
    tight = _svc(max_batch=64, capacity=2)
    rid = tight.submit(TC[1])
    with pytest.raises(OverflowError):
        tight.flush()
    assert tight.pending_count == 1 and tight.result(rid) is None


def test_devices_two_routes_shards_and_matches_jax(jax_quotes):
    svc = _svc(max_batch=64, devices=2)
    ids = [svc.submit(r) for r in TRACE]
    svc.flush()
    _held([svc.result(i) for i in ids], jax_quotes)
    m = svc.metrics()
    assert m["shard_batches"] == 2 and m["rebalances"] == 2
    assert svc.shard_speed((N_STEPS, "rz")).shape == (2,)
    assert all(k[7] == 2 and k[8][0] == 2 for k in svc._compiled)


def test_pricing_engine_batches_with_per_request_payoff(jax_quotes):
    eng = PricingEngine(None, n_steps=N_STEPS, batch=4, capacity=CAPACITY,
                        round_depth=3, device="cpu")
    ids = [eng.submit(r) for r in TRACE]
    out = eng.flush()
    assert sorted(out) == ids and eng.flush() == {}
    for rid, ref in zip(ids, jax_quotes):
        ask, bid = out[rid]
        assert abs(ask - ref.ask) <= TOL and abs(bid - ref.bid) <= TOL
    # result_cache_size=0: a repeat is priced again
    eng.submit(TRACE[0])
    eng.flush()
    assert eng.service.metrics()["cache_hits"] == 0


def test_grid_request_routes_by_engine_auto():
    eng = PricingEngine(n_steps=N_STEPS, batch=8, capacity=CAPACITY,
                        device="cpu")
    axes = dict(s0=(95.0, 105.0), sigma=0.25, maturity=0.5,
                payoff=("put", "call"), n_steps=N_STEPS)
    notc = eng.price_grid(GridRequest(cost_rate=0.0, **axes))
    tc = eng.price_grid(GridRequest(cost_rate=(0.0, 0.01), **axes))
    mc = eng.price_grid(GridRequest(cost_rate=0.0, n_assets=2,
                                    execution=api.ExecutionConfig(
                                        n_paths=256), **axes))
    assert (notc.engine, tc.engine, mc.engine) == ("notc", "rz", "lsmc")
    assert notc.ask.shape == (2, 1, 1, 1, 1, 2, 1)
    assert tc.ask.shape == (2, 1, 1, 1, 2, 2, 1)
    cpu = api.ExecutionConfig(device="cpu")
    want = api.price_grid(execution=cpu, capacity=CAPACITY,
                          cost_rate=(0.0, 0.01), rate=0.1, **axes)
    np.testing.assert_allclose(tc.ask, want.ask, rtol=0, atol=TOL)
    np.testing.assert_array_equal(tc.row_pieces, want.row_pieces)
    assert eng.grid_stats == {"grids": 3, "scenarios": 4 + 8 + 4}
    m = eng.service.metrics()
    assert m["grids"] == 3 and m["engine_batches"]["lsmc"] == 1
    # a grid's own backend: the JAX package's name maps, a wrong one raises
    jnp = eng.price_grid(GridRequest(cost_rate=0.0, backend="jnp", **axes))
    np.testing.assert_allclose(jnp.ask, notc.ask, rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="backend"):
        eng.price_grid(GridRequest(cost_rate=0.0, backend="xla", **axes))


@pytest.fixture(scope="module")
def jax_launcher_quotes():
    """The JAX package's launcher trace (24 requests, depths 8 and 12, a
    quarter under costs, seed 0) priced by JAX's ``PricingService`` in
    one flush: one chunk a bucket."""
    trace = j_synth_trace(24, n_steps=(8, 12), tc_fraction=0.25)
    svc = JPricingService(max_batch=64, capacity=24, default_n_steps=8)
    ids = [svc.submit(r) for r in trace]
    svc.flush()
    return trace, [svc.result(i) for i in ids]


@pytest.mark.parametrize("argv", [
    ["--qps", "0"],
    ["--qps", "4000", "--backend", "jnp", "--devices", "2"],
    ["--gateway", "--replicas", "2", "--crash-at", "0"],
])
def test_serve_pricing_launcher_roundtrip(argv, capsys, jax_launcher_quotes):
    """The launcher's trace is JAX's request for request, and its quotes
    (service or gateway, in batches of 8) are JAX's service's."""
    base = ["--requests", "24", "--n-steps", "8,12", "--max-batch", "8",
            "--tc-fraction", "0.25", "--capacity", "24", "--device", "cpu"]
    out = launch.main(base + argv)
    text = capsys.readouterr().out
    jtrace, want = jax_launcher_quotes
    trace = launch.synth_trace(24, n_steps=(8, 12), tc_fraction=0.25)
    assert ([dataclasses.asdict(r) for r in trace]
            == [dataclasses.asdict(r) for r in jtrace])
    assert len(out["quotes"]) == 24 and out["metrics"]["completed"] == 24
    _held([q for _, q in sorted(out["quotes"].items())], want)
    assert "latency p50/p99" in text
    if "--gateway" in argv:
        m = out["metrics"]
        assert m["replica_crashes"] == 1 and m["requeues"] >= 1
        assert "crashes=1" in text
