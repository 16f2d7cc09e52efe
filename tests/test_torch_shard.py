"""Port parity: the grid engines sharded over a 1-D mesh of devices.

On the CPU, ``devices=W`` runs the simulated layout (the process sees
one CPU device) and ``mesh=(cpu,) * W`` the real per-shard dispatch,
as JAX's ``--xla_force_host_platform_device_count`` gives one CPU W
devices.  Rows are independent, so every layout is held **bit-equal**
to the single-device call, on both backends of both lattice engines,
with ``max_pieces``, ``row_pieces`` and the ``OverflowError`` check
unchanged; the plans and ``ShardExecInfo`` are held equal to the JAX
package's simulated path, and the validation errors to its messages.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64)
from repro import api as japi
from repro import scenarios as JS
from repro.core import partition as JP

from repro_torch import api
from repro_torch import scenarios as TS
from repro_torch.core import distributed as TD
from repro_torch.core import partition as TP

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
FIELDS = ("ask", "bid", "row_pieces", "delta_ask", "delta_bid", "vega_ask",
          "vega_bid")
MIXED = dict(s0=(95.0, 105.0), sigma=(0.15, 0.25),
             cost_rate=(0.0, 0.005, 0.01),
             payoff=("put", "call", "bull_spread"),
             strike=(95.0, 100.0, 105.0), n_steps=10)


def _same(a, b, label=""):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), (label, f)
        if x is not None:
            assert np.array_equal(x, y), (label, f)
    assert a.max_pieces == b.max_pieces, label


def _info_dict(info):
    d = dataclasses.asdict(info)
    d["plan"] = dataclasses.asdict(info.plan)
    return d


@pytest.fixture(scope="module")
def mixed():
    return TS.ScenarioGrid.cartesian(**MIXED)


@pytest.mark.parametrize("engine,backend", [("rz", "kernel"), ("rz", "torch"),
                                            ("notc", "kernel"),
                                            ("notc", "torch")])
def test_layouts_bit_equal_on_mixed_grid(mixed, engine, backend):
    price = lambda **kw: api.price_grid(
        mixed, capacity=16, levels=4 if engine == "notc" else None,
        block=16 if engine == "notc" else None, execution=api.ExecutionConfig(
            engine=engine, backend=backend, device="cpu",
            devices=kw.pop("devices", None)), **kw)
    one = price(devices=1)
    assert one.shard_info is None
    for label, kw in (("devices=2", dict(devices=2)),
                      ("devices=8", dict(devices=8)),
                      ("mesh=(cpu,)*4", dict(mesh=(CPU,) * 4))):
        res = price(**kw)
        _same(one, res, label)
        info = res.shard_info
        assert info.simulated == ("mesh" not in label)
        assert sum(info.per_shard_rows) == mixed.n_scenarios
        assert max(info.per_shard_pieces) == res.max_pieces
    if engine == "rz":
        # cost-model plan: uneven row counts, near-equal predicted work
        plan = price(devices=8).shard_info.plan
        assert len(set(plan.sizes)) > 1 and plan.work_spread < 0.10


def test_shard_exec_info_matches_jax_simulated_path(mixed):
    """On a put grid the port's knot counts equal JAX's, and the whole
    ShardExecInfo is equal; on the mixed grid, whose one call row the two
    packages count differently by the last ulp (ROADMAP Queue C), the
    plan is equal and JAX's own bookkeeping of the port's counts gives
    the port's info."""
    kw = dict(s0=(90.0, 100.0, 110.0), cost_rate=(0.0, 0.01), payoff="put",
              strike=(95.0, 105.0), n_steps=6)
    want = JS.price_grid_rz(JS.ScenarioGrid.cartesian(**kw), capacity=8,
                            devices=5)
    got = TS.price_grid_rz(TS.ScenarioGrid.cartesian(**kw), capacity=8,
                           devices=5, device="cpu")
    assert _info_dict(got.shard_info) == _info_dict(want.shard_info)
    np.testing.assert_allclose(got.ask, want.ask, rtol=0, atol=1e-9)
    res = TS.price_grid_rz(mixed, capacity=16, devices=8, device="cpu")
    jgrid = JS.ScenarioGrid.cartesian(**MIXED)
    plan = JP.plan_shards(np.tile(JP.scenario_costs(
        10, jgrid.cost_rate, capacity=16), 1), 8)
    assert dataclasses.asdict(res.shard_info.plan) == dataclasses.asdict(plan)
    want = JS._shard_exec_info(plan, None, jgrid, 1,
                               res.row_pieces.ravel().astype(float))
    assert _info_dict(res.shard_info) == _info_dict(want)
    small = dict(s0=(90.0, 100.0, 110.0), payoff=("put", "call"), n_steps=6)
    notc = TS.price_grid_notc(TS.ScenarioGrid.cartesian(**small), devices=4,
                              device="cpu")
    jnotc = JS.price_grid_notc(JS.ScenarioGrid.cartesian(**small), devices=4)
    assert _info_dict(notc.shard_info) == _info_dict(jnotc.shard_info)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_greeks_and_flat_padding_under_sharding(backend):
    grid = TS.ScenarioGrid.cartesian(s0=(95.0, 105.0), cost_rate=(0.0, 0.01),
                                     payoff=("put",), strike=100.0,
                                     n_steps=8)
    want = TS.price_grid_rz(grid, capacity=16, greeks=True, backend=backend,
                            device="cpu")
    for kw in (dict(devices=4), dict(mesh=(CPU,) * 3)):
        got = TS.price_grid_rz(grid, capacity=16, greeks=True,
                               backend=backend, device="cpu", **kw)
        _same(want, got, str(kw))
        assert got.shard_info.plan.n_rows == 5 * grid.n_scenarios
    flat = dict(s0=(95.0, 100.0, 105.0, 98.0, 101.0),
                payoff=("put", "call", "put", "bull_spread", "put"),
                cost_rate=(0.0, 0.01, 0.005, 0.0, 0.01), strike=100.0,
                sigma=0.2, rate=0.1, maturity=0.25, n_steps=8, capacity=16,
                pad_to=8)
    cfg = lambda d: api.ExecutionConfig(backend=backend, device="cpu",
                                        devices=d)
    one = api.price_flat(**flat, execution=cfg(None))
    four = api.price_flat(**flat, execution=cfg(4))
    _same(one, four, "price_flat")
    assert four.shard_info.plan.n_rows == 8


def test_overflow_under_sharding_matches_single_device():
    """The same message, needed count included, on every layout."""
    kw = dict(s0=(95.0, 100.0, 105.0), cost_rate=(0.0, 0.01),
              payoff=("put", "call"), strike=100.0, n_steps=8)
    grid = TS.ScenarioGrid.cartesian(**kw)
    with pytest.raises(OverflowError, match="PWL capacity overflow") as one:
        TS.price_grid_rz(grid, capacity=3, device="cpu")
    for kw in (dict(devices=2), dict(devices=8), dict(mesh=(CPU,) * 2)):
        with pytest.raises(OverflowError) as got:
            TS.price_grid_rz(grid, capacity=3, device="cpu", **kw)
        assert str(got.value) == str(one.value)


def test_shard_plan_validation_matches_jax():
    kw = dict(s0=(95.0, 100.0), n_steps=8)
    jg, tg = JS.ScenarioGrid.cartesian(**kw), TS.ScenarioGrid.cartesian(**kw)
    cases = [
        (dict(shard_plan=JP.plan_shards(np.ones(5), 2)),
         dict(shard_plan=TP.plan_shards(np.ones(5), 2))),
        (dict(shard_plan=JP.plan_shards(np.ones(2), 2), devices=4),
         dict(shard_plan=TP.plan_shards(np.ones(2), 2), devices=4)),
    ]
    for jkw, tkw in cases:
        with pytest.raises(ValueError) as jx:
            JS.price_grid_notc(jg, **jkw)
        with pytest.raises(ValueError) as tx:
            TS.price_grid_notc(tg, device="cpu", **tkw)
        assert str(tx.value) == str(jx.value)
    # a plan is honoured as given, on the simulated path
    plan = TP.plan_shards(np.array([1.0, 3.0]), 2)
    got = TS.price_grid_notc(tg, device="cpu", shard_plan=plan)
    assert got.shard_info.plan == plan and got.shard_info.simulated
    with pytest.raises(TypeError) as jx:
        japi.price_grid(n_steps=[4, 8], shard_plan=JP.plan_shards(
            np.ones(1), 1))
    with pytest.raises(TypeError) as tx:
        api.price_grid(n_steps=[4, 8], shard_plan=plan,
                       execution=api.ExecutionConfig(device="cpu"))
    assert str(tx.value) == str(jx.value)


@pytest.mark.parametrize("layout", [{}, dict(mesh=(CPU,) * 2)],
                         ids=["single", "mesh"])
def test_notc_backend_picks_the_row_function(monkeypatch, layout):
    """backend="kernel" goes through lattice_round_param on every layout
    and needs its levels/block; backend="torch" never reaches it."""
    from repro_torch.kernels import binomial_step
    calls = []
    real = binomial_step.lattice_round_param

    def spy(*a, **kw):
        calls.append(kw["levels"])
        return real(*a, **kw)

    monkeypatch.setattr(binomial_step, "lattice_round_param", spy)
    grid = TS.ScenarioGrid.cartesian(s0=(95.0, 105.0), n_steps=8)
    want = TS.price_grid_notc(grid, backend="torch", device="cpu", **layout)
    assert calls == []
    got = TS.price_grid_notc(grid, backend="kernel", levels=4, block=16,
                             device="cpu", **layout)
    assert calls and set(calls) == {4}
    np.testing.assert_allclose(got.ask, want.ask, rtol=0, atol=1e-12)
    for kw in (dict(levels=None), dict(block=None)):
        with pytest.raises(ValueError, match="needs levels and block"):
            TS.price_grid_notc(grid, backend="kernel", device="cpu",
                               **kw, **layout)


def test_mesh_resolution():
    assert TD.resolve_grid_mesh(None, None, kind="cpu") == (None, 1)
    assert TD.resolve_grid_mesh(1, None, kind="cpu") == (None, 1)
    assert TD.resolve_grid_mesh(4, None, kind="cpu") == (None, 4)
    assert TD.resolve_grid_mesh(None, ["cpu", "cpu"], kind="cpu") == (
        (CPU, CPU), 2)
    assert TD.grid_mesh(1, kind="cpu") == (CPU,)
    with pytest.raises(ValueError, match="must be 1-D"):
        TD.resolve_grid_mesh(mesh=((CPU,), (CPU,)), kind="cpu")
    with pytest.raises(ValueError, match="conflicts"):
        TD.resolve_grid_mesh(3, (CPU,) * 2, kind="cpu")
    with pytest.raises(ValueError, match="device type"):
        TD.resolve_grid_mesh(None, (CPU,), kind="cuda")
    with pytest.raises(TypeError, match="sequence of torch.device"):
        TD.resolve_grid_mesh(None, object(), kind="cpu")
    with pytest.raises(ValueError, match="devices"):
        TD.grid_mesh(2, kind="cpu")
    assert TD.GRID_AXIS == "scenarios"
