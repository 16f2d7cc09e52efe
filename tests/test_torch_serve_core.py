"""Port parity: the serving core's wire schema, executor and counters.

* ``ChunkSpec``/``ChunkResult`` round-trip through their v1 wire dicts
  (pickle and strict JSON) for every chunk shape the port's scheduler
  emits; a newer version is refused, unknown fields are ignored;
* a chunk made by the JAX package's scheduler prices in the port's
  ``execute_chunk(device="cpu")`` to 1e-9 of the JAX package's
  ``execute_chunk`` on ask, bid and stderr with equal ``max_pieces``
  (``notc``, ``rz``; ``lsmc`` within 3 combined standard errors: the
  port's sampler draws other normals), and the port's ``ChunkResult``
  wire decodes in the JAX package;
* the compile-key counters and ``ServiceMetrics`` under concurrent
  flushes.
"""
import json
import pickle
import sys
import threading

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64)
from repro.serve import core as JC
from repro.serve.engine import PriceRequest as JPriceRequest
from repro.serve.scheduler import PricingService as JPricingService

from repro_torch.serve import core as TC
from repro_torch.serve.engine import PriceRequest
from repro_torch.serve.scheduler import PricingService

from _jax_wire import JAX_CHUNK_WIRES
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-9
N_STEPS = 8
CAPACITY = 16


def _req(cls, s0=100.0, cost_rate=0.0, **kw):
    kw.setdefault("n_steps", N_STEPS)
    return cls(s0=s0, sigma=0.2, rate=0.1, maturity=0.25,
               cost_rate=cost_rate, **kw)


# (shape, request kwargs): one chunk per engine shape a scheduler emits
_SHAPES = {
    "notc": [dict(s0=95.0, payoff="put", strike=100.0),
             dict(s0=105.0, payoff="call", strike=100.0),
             dict(s0=100.0, payoff="bull_spread", strike=95.0)],
    "rz": [dict(s0=98.0, cost_rate=0.01),
           dict(s0=102.0, cost_rate=0.005, payoff="call", strike=95.0)],
    "lsmc": [dict(s0=100.0, n_assets=2),
             dict(s0=97.0, n_assets=2, payoff="call", strike=95.0)],
    "lsmc_bermudan": [dict(s0=100.0, exercise_steps=(2, 4, N_STEPS))],
}


def _drain(svc, reqs):
    """Submit ``reqs`` and take the one chunk the scheduler dispatches,
    prepared as a transport hands it to a replica."""
    for r in reqs:
        svc.submit(r)
    (bucket,) = list(svc.core.buckets)
    chunk = svc.core.take_chunk(bucket, svc.max_batch)
    svc._prepare_chunk(chunk, bucket)
    return chunk


def _port_chunk(shape, **kw):
    svc = PricingService(max_batch=64, capacity=CAPACITY, device="cpu",
                         default_n_steps=N_STEPS, n_paths=256, **kw)
    return _drain(svc, [_req(PriceRequest, **r) for r in _SHAPES[shape]])


def _jax_chunk(shape, **kw):
    kw.setdefault("n_paths", 2048)
    svc = JPricingService(max_batch=64, capacity=CAPACITY,
                          default_n_steps=N_STEPS, clock=lambda: 0.0, **kw)
    return _drain(svc, [_req(JPriceRequest, **r) for r in _SHAPES[shape]])


@pytest.mark.parametrize("shape,devices", [
    ("notc", None), ("rz", None), ("lsmc", None), ("lsmc_bermudan", None),
    ("rz", 2)])
def test_chunk_spec_wire_roundtrip_every_engine_shape(shape, devices):
    chunk = _port_chunk(shape, devices=devices)
    wire = chunk.to_wire()
    assert wire["version"] == TC.WIRE_VERSION == JC.WIRE_VERSION == 1
    assert wire["kind"] == "chunk_spec" and wire["backend"] == "kernel"
    assert (chunk.shard_plan is not None) == (devices is not None)
    assert wire["devices"] == devices          # a count, never a mesh
    assert TC.ChunkSpec.from_wire(wire) == chunk
    assert TC.ChunkSpec.from_wire(pickle.loads(pickle.dumps(wire))) == chunk
    assert TC.ChunkSpec.from_wire(json.loads(json.dumps(wire))) == chunk


def test_chunk_result_wire_roundtrip_with_shard_info():
    chunk = _port_chunk("rz", devices=2)
    res = TC.execute_chunk(chunk, device="cpu")
    assert res.shard_info is not None and res.shard_info.simulated
    back = TC.ChunkResult.from_wire(pickle.loads(pickle.dumps(
        res.to_wire())))
    for f in ("ask", "bid", "row_pieces", "stderr"):
        np.testing.assert_array_equal(getattr(back, f), getattr(res, f))
    assert back.shard_info == res.shard_info
    assert back.max_pieces == res.max_pieces


@pytest.mark.parametrize("mutate,match", [
    (lambda w: w.update(version=2), "newer"),
    (lambda w: w.update(version=True), "version"),
    (lambda w: w.update(kind="chunk_result"), "expected"),
    (lambda w: w.pop("cols"), "missing"),
    (lambda w: w.update(backend="xla"), "backend"),
])
def test_chunk_spec_wire_refuses_what_it_cannot_read(mutate, match):
    wire = _port_chunk("notc").to_wire()
    mutate(wire)
    with pytest.raises(ValueError, match=match):
        TC.ChunkSpec.from_wire(wire)


def test_unknown_wire_fields_are_ignored_and_newer_results_refused():
    chunk = _port_chunk("notc")
    wire = dict(chunk.to_wire(), future_field={"x": 1}, priority=3)
    assert TC.ChunkSpec.from_wire(wire) == chunk
    res = TC.execute_chunk(chunk, device="cpu").to_wire()
    assert TC.ChunkResult.from_wire(dict(res, extra=1)).max_pieces == 0
    with pytest.raises(ValueError, match="newer"):
        TC.ChunkResult.from_wire(dict(res, version=2))


@pytest.mark.parametrize("shape", ["notc", "rz"])
def test_jax_wire_literals_are_what_jax_writes(shape):
    """``tests/_jax_wire.py`` (the card test's input) is JAX-made."""
    wire = _jax_chunk(shape, n_paths=4096).to_wire()
    assert wire == JAX_CHUNK_WIRES[shape]


@pytest.mark.parametrize("shape,backend", [
    ("notc", "jnp"), ("rz", "jnp"), ("notc", "pallas")])
def test_jax_chunk_prices_in_port_executor_like_jax(shape, backend):
    kw = dict(backend=backend)
    if backend == "pallas":
        kw["interpret"] = True            # the Pallas kernels off the TPU
    chunk = TC.ChunkSpec.from_wire(_jax_chunk(shape, **kw).to_wire())
    assert chunk.backend == {"jnp": "torch", "pallas": "kernel"}[backend]
    got = TC.execute_chunk(chunk, device="cpu")
    # held to JAX's jnp engine on the same contracts (its Pallas kernels
    # in interpret mode agree with it, and cost seconds more here)
    want = JC.execute_chunk(_jax_chunk(shape))
    n = chunk.n
    for f in ("ask", "bid", "stderr"):
        np.testing.assert_allclose(getattr(got, f)[:n],
                                   np.asarray(getattr(want, f))[:n],
                                   rtol=0, atol=TOL)
    assert got.max_pieces == want.max_pieces
    assert got.ask.shape == (chunk.padded,)
    # the port's result decodes in the JAX package
    back = JC.ChunkResult.from_wire(pickle.loads(pickle.dumps(
        got.to_wire())))
    np.testing.assert_array_equal(back.ask, got.ask)
    np.testing.assert_array_equal(back.row_pieces, got.row_pieces)
    assert back.max_pieces == got.max_pieces


def test_jax_lsmc_chunk_within_three_se_and_result_decodes_in_jax():
    jchunk = _jax_chunk("lsmc")
    chunk = TC.ChunkSpec.from_wire(jchunk.to_wire())
    assert (chunk.engine, chunk.n_assets, chunk.n_paths) == ("lsmc", 2, 2048)
    got = TC.execute_chunk(chunk, device="cpu")
    want = JC.execute_chunk(jchunk)
    n = chunk.n
    se = np.hypot(got.stderr[:n], np.asarray(want.stderr)[:n])
    assert (got.stderr[:n] > 0).all() and (se > 0).all()
    assert (np.abs(got.ask[:n] - np.asarray(want.ask)[:n]) <= 3 * se).all()
    assert got.max_pieces == want.max_pieces == 0
    back = JC.ChunkResult.from_wire(got.to_wire())
    np.testing.assert_array_equal(back.stderr, got.stderr)


def test_executor_device_contradictions_raise(monkeypatch):
    """No quiet fallback: ``interpret`` that contradicts the executor's
    device raises, and the card raises where there is none."""
    chunk = _port_chunk("notc")
    with pytest.raises(ValueError, match="interpret=True"):
        TC.chunk_device(TC.ChunkSpec(**{**chunk.__dict__, "interpret": True}),
                        "cuda")
    with pytest.raises(ValueError, match="interpret=False"):
        TC.execute_chunk(TC.ChunkSpec(**{**chunk.__dict__,
                                         "interpret": False}), device="cpu")
    assert TC.chunk_device(TC.ChunkSpec(**{**chunk.__dict__,
                                           "interpret": True})).type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TC.execute_chunk(chunk)
    with pytest.raises(RuntimeError, match="is_available"):
        PricingService()


def test_compile_key_counts_launch_shapes():
    svc = PricingService(max_batch=4, deadline_ms=1e9, device="cpu",
                         default_n_steps=N_STEPS, capacity=CAPACITY)
    for s in (90.0, 95.0, 100.0, 105.0):
        svc.submit(_req(PriceRequest, s0=s))
    m = svc.metrics()
    assert m["batches"] == 1                # size trigger
    assert (m["compile_misses"], m["compile_hits"]) == (1, 0)
    for s in (91.0, 96.0, 101.0, 106.0):    # same shape, new data
        svc.submit(_req(PriceRequest, s0=s))
    m = svc.metrics()
    assert (m["compile_misses"], m["compile_hits"]) == (1, 1)
    rid = svc.submit(_req(PriceRequest, s0=95.0))   # result-LRU hit
    m = svc.metrics()
    assert svc.result(rid) is not None and m["cache_hits"] == 1
    assert m["batches"] == 2
    svc.submit(_req(PriceRequest, s0=97.0))          # padded 1: new shape
    svc.flush()
    assert svc.metrics()["compile_misses"] == 2
    (key,) = [k for k in svc._compiled if k[0] == 4]
    assert key[3:5] == ("kernel", "cpu")   # (backend, device type)
    core = svc.core
    assert core.compile_key(4, N_STEPS, "notc", False) == key
    assert core.compile_key(4, N_STEPS, "notc", False, device="cuda") != key
    assert core.compile_key(4, N_STEPS, "notc", False,
                            backend="jnp") != key
    chunk = _port_chunk("notc")
    assert (TC.SchedulerCore.chunk_compile_key(chunk, device="cpu")
            == (4, N_STEPS, "notc", "kernel", "cpu", False, CAPACITY,
                None, None, None))


def test_fresh_snapshot_is_strict_json():
    snap = TC.ServiceMetrics().snapshot()
    assert snap["contracts_per_sec"] == 0.0
    assert json.loads(json.dumps(snap, allow_nan=False)) == snap
    assert set(snap) == set(JC.ServiceMetrics().snapshot())


def test_service_metrics_thread_safe_under_concurrent_flushes():
    """More threads than cores, a short switch interval: every update
    of every thread is counted."""
    m = TC.ServiceMetrics()
    n_threads, n_iter = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_iter):
                m.bump(requests=1)
                m.record_flush(contracts=2, padded=4, engine="rz",
                               seconds=0.001, latencies=[0.01, 0.02])
                m.snapshot()
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = m.snapshot()
    total = n_threads * n_iter
    assert snap["requests"] == total and snap["batches"] == total
    assert snap["contracts"] == snap["completed"] == 2 * total
    assert snap["padded"] == 4 * total
    assert snap["engine_batches"]["rz"] == total
    assert len(m.latencies) <= 2 * m.latency_window
