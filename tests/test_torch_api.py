"""Port parity: the grid API around the engines, on the CPU.

The friction-free grid (``price_grid_notc`` on both port backends against
the JAX package's ``jnp`` and ``pallas`` backends), the fused FD Greeks,
``OverflowError`` parity, the halo round plan, the single-contract entry
points, the JAX package's individual execution kwargs, closure-only
payoffs, the grid layout and routing, the paths not yet ported, the
device contract and the import boundary.  LSMC, sharding and the
launcher are in ``tests/test_torch_lsmc.py``, ``test_torch_shard.py``
and ``test_torch_launch.py``.  The transaction-cost grid
against JAX is in ``tests/test_torch_grid.py``.
"""
import ast
import pathlib
import re
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64)
from repro import api as japi
from repro.core import LatticeModel as JLatticeModel
from repro.core import cash_settled as j_cash_settled
from repro.core.rz import price_rz as j_price_rz
from repro.core import american_call as j_call
from repro.core import american_put as j_put
from repro.core import bull_spread as j_bull
from repro.core import price_ref
from repro import scenarios as JS

from repro_torch import api
from repro_torch.convert import grid_from_columns
from repro_torch.core import device as D
from repro_torch.core.lattice import LatticeModel
from repro_torch.core.rz import price_rz
from repro_torch.scenarios import ScenarioGrid, route_engine

TOL = 1e-9
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cfg(backend, engine=None, device="cpu"):
    return api.ExecutionConfig(engine=engine, backend=backend, device=device)


@pytest.fixture(scope="module")
def grid108():
    return JS.ScenarioGrid.cartesian(
        s0=(95.0, 105.0), sigma=(0.15, 0.25), cost_rate=(0.0, 0.005, 0.01),
        payoff=("put", "call", "bull_spread"), strike=(95.0, 100.0, 105.0),
        n_steps=10)


@pytest.fixture(scope="module")
def jax_notc(grid108):
    return (JS.price_grid_notc(grid108, backend="jnp"),
            JS.price_grid_notc(grid108, backend="pallas", levels=4, block=16))


_GREEKS_GRID = dict(s0=(100.0, 104.0), sigma=0.2, rate=0.1, maturity=0.25,
                    cost_rate=0.01, payoff=("put", "bull_spread"),
                    strike=(100.0, 95.0), n_steps=10)


@pytest.fixture(scope="module")
def rz_fd_refs():
    """Central differences of the exact sequential oracle for the Greeks
    grid's rows: (delta_ask, delta_bid, vega_ask, vega_bid) per row."""
    g = _GREEKS_GRID
    refs = []
    for i, pay in enumerate((j_put(100.0), j_bull(95.0, 105.0))):
        m = lambda s0, sig: JLatticeModel(s0=s0, sigma=sig, rate=0.1,
                                          maturity=0.25, n_steps=10,
                                          cost_rate=0.01)
        s0, ds, dv = g["s0"][i], 1e-4 * g["s0"][i], 1e-4
        up, dn = price_ref(m(s0 + ds, 0.2), pay), price_ref(m(s0 - ds, 0.2), pay)
        vu, vd = price_ref(m(s0, 0.2 + dv), pay), price_ref(m(s0, 0.2 - dv), pay)
        refs.append(((up.ask - dn.ask) / (2 * ds), (up.bid - dn.bid) / (2 * ds),
                     (vu.ask - vd.ask) / (2 * dv), (vu.bid - vd.bid) / (2 * dv)))
    return refs


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_grid_notc_matches_jax(backend, grid108, jax_notc):
    res = api.price_grid(grid_from_columns(grid108), levels=4, block=16,
                         execution=_cfg(backend, "notc"))
    for ref in jax_notc:
        np.testing.assert_allclose(res.ask, ref.ask, rtol=0, atol=TOL)
        np.testing.assert_allclose(res.bid, ref.bid, rtol=0, atol=TOL)
    assert res.max_pieces == 0 and not res.row_pieces.any()


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_grid_greeks_match_jax(backend, grid108, rz_fd_refs):
    """Fused FD Greeks: the friction-free grid against JAX's, and the TC
    rows against central differences of the exact sequential oracle."""
    res = api.price_grid(grid_from_columns(grid108), greeks=True,
                         levels=4, block=16,
                         execution=_cfg(backend, "notc"))
    want = JS.price_grid_notc(grid108, backend="jnp", greeks=True)
    for name in ("delta_ask", "delta_bid", "vega_ask", "vega_bid"):
        np.testing.assert_allclose(getattr(res, name), getattr(want, name),
                                   rtol=0, atol=1e-6)
    g = ScenarioGrid.explicit(**_GREEKS_GRID)
    rz = api.price_grid(g, greeks=True, capacity=16, execution=_cfg(backend))
    for i, (d_ask, d_bid, v_ask, v_bid) in enumerate(rz_fd_refs):
        assert rz.delta_ask[i] == pytest.approx(d_ask, abs=1e-6)
        assert rz.delta_bid[i] == pytest.approx(d_bid, abs=1e-6)
        assert rz.vega_ask[i] == pytest.approx(v_ask, abs=1e-5)
        assert rz.vega_bid[i] == pytest.approx(v_bid, abs=1e-5)


def test_capacity_overflow_raises_where_jax_does():
    g = JS.ScenarioGrid.cartesian(s0=100.0, cost_rate=0.01,
                                  payoff="bull_spread", strike=95.0,
                                  strike2=105.0, n_steps=12)
    with pytest.raises(OverflowError):
        JS.price_grid_rz(g, capacity=3)
    for backend in ("kernel", "torch"):
        with pytest.raises(OverflowError, match="capacity overflow"):
            api.price_grid(grid_from_columns(g), capacity=3,
                           execution=_cfg(backend))
    # the same grid fits at the tests' capacity
    ok = api.price_grid(grid_from_columns(g), capacity=16,
                        execution=_cfg("kernel"))
    assert 3 < ok.max_pieces <= 16


def test_call_knots_outgrow_capacity_where_jax_does():
    """A call's knot count grows with N (ROADMAP Queue C): at N=40 the
    American call (s0=K=100, k=0.01) needs 17 knots, so JAX's grid
    engine raises at capacity 16, and the port raises with the same
    count on both backends; at N=20 it fits."""
    kw = dict(s0=100.0, cost_rate=0.01, payoff="call", strike=100.0)
    g = JS.ScenarioGrid.cartesian(n_steps=40, **kw)
    with pytest.raises(OverflowError, match=r"needed 17 > K=16"):
        JS.price_grid_rz(g, capacity=16)
    for backend in ("kernel", "torch"):
        with pytest.raises(OverflowError, match=r"needed 17 > K=16"):
            api.price_grid(grid_from_columns(g), capacity=16,
                           execution=_cfg(backend))
    small = api.price_grid(ScenarioGrid.cartesian(n_steps=20, **kw),
                           capacity=16, execution=_cfg("kernel"))
    assert small.max_pieces < 17


def test_halo_plan_matches_single_block_plan():
    g = ScenarioGrid.explicit(
        s0=(95.0, 105.0, 100.0, 100.0), sigma=0.2, rate=0.1, maturity=0.25,
        cost_rate=(0.01, 0.0, 0.005, 0.01),
        payoff=("put", "call", "bull_spread", "put"), strike=100.0,
        n_steps=12)
    a = api.price_grid(g, capacity=16, execution=_cfg("torch"))
    b = api.price_grid(g, capacity=16, levels=6, block=8,
                       execution=_cfg("kernel"))
    np.testing.assert_allclose(b.ask, a.ask, rtol=0, atol=TOL)
    np.testing.assert_allclose(b.bid, a.bid, rtol=0, atol=TOL)
    assert b.max_pieces == a.max_pieces


def test_price_american_and_flat_match_oracles():
    kw = dict(s0=100.0, sigma=0.2, rate=0.1, maturity=0.25, n_steps=12)
    ref = price_ref(JLatticeModel(cost_rate=0.01, **kw), j_call(100.0))
    for backend in ("kernel", "torch"):
        q = api.price_american(payoff="call", strike=100.0, cost_rate=0.01,
                               capacity=16, execution=_cfg(backend), **kw)
        assert q.ask == pytest.approx(ref.ask, abs=TOL)
        assert q.bid == pytest.approx(ref.bid, abs=TOL)
        q0 = api.price_american(payoff="put", strike=100.0,
                                execution=_cfg(backend), **kw)
        assert q0.ask == q0.bid
        assert q.bid - TOL <= api.price_american(
            payoff="call", strike=100.0, execution=_cfg(backend),
            **kw).ask <= q.ask + TOL
    res = api.price_flat(s0=(95.0, 100.0), payoff=("put", "call"),
                         strike=(100.0, 90.0), sigma=0.2, rate=0.1,
                         maturity=0.25, n_steps=8, pad_to=4,
                         execution=_cfg("kernel"))
    assert res.ask.shape == (4,) and res.ask[1] == res.ask[3]


@pytest.fixture
def fresh_legacy_warning():
    api._reset_legacy_exec_warning()
    japi._reset_legacy_exec_warning()
    yield
    api._reset_legacy_exec_warning()
    japi._reset_legacy_exec_warning()


_LEGACY_GRID = dict(s0=(95.0, 105.0), cost_rate=(0.0, 0.01),
                    payoff=("put", "bull_spread"), strike=100.0, n_steps=8)

# the JAX package's individual kwargs -> the port's ExecutionConfig
_LEGACY_CASES = [
    (dict(backend="jnp", platform="cpu"),
     dict(backend="torch", device="cpu")),
    (dict(backend="pallas", platform="cpu"),
     dict(backend="kernel", device="cpu")),
    (dict(interpret=True), dict(backend="kernel", device="cpu")),
    (dict(engine="rz", backend="jnp", platform="cpu"),
     dict(engine="rz", backend="torch", device="cpu")),
    (dict(engine="notc", interpret=True, devices=1),
     dict(engine="notc", backend="kernel", device="cpu", devices=1)),
]


@pytest.mark.parametrize("legacy,mapped", _LEGACY_CASES,
                         ids=lambda c: ",".join(sorted(c)))
def test_legacy_execution_kwargs_match_execution(legacy, mapped,
                                                 fresh_legacy_warning):
    """JAX's individual kwargs price as ``execution=`` does, warn once
    per process, and agree with the JAX package called the same way."""
    want = api.price_grid(capacity=16, execution=api.ExecutionConfig(
        **mapped), **_LEGACY_GRID)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = api.price_grid(capacity=16, **legacy, **_LEGACY_GRID)
        flat = api.price_flat(s0=(95.0, 105.0), sigma=0.2, rate=0.1,
                              maturity=0.25, cost_rate=(0.01, 0.0),
                              payoff=("put", "bull_spread"), n_steps=8,
                              capacity=16, **legacy)
    dep = [x for x in w if issubclass(x.category, DeprecationWarning)]
    assert len(dep) == 1 and "ExecutionConfig" in str(dep[0].message)
    np.testing.assert_array_equal(got.ask, want.ask)
    np.testing.assert_array_equal(got.bid, want.bid)
    assert got.max_pieces == want.max_pieces
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = japi.price_grid(capacity=16, **legacy, **_LEGACY_GRID)
        jflat = japi.price_flat(s0=(95.0, 105.0), sigma=0.2, rate=0.1,
                                maturity=0.25, cost_rate=(0.01, 0.0),
                                payoff=("put", "bull_spread"), n_steps=8,
                                capacity=16, **legacy)
    for g, r in ((got, ref), (flat, jflat)):
        np.testing.assert_allclose(g.ask, np.asarray(r.ask), rtol=0, atol=TOL)
        np.testing.assert_allclose(g.bid, np.asarray(r.bid), rtol=0, atol=TOL)


def test_legacy_kwargs_beside_execution_are_a_type_error(fresh_legacy_warning):
    cfg = _cfg("torch")
    with pytest.raises(TypeError, match="both execution="):
        api.price_grid(execution=cfg, backend="jnp", **_LEGACY_GRID)
    with pytest.raises(TypeError, match="both execution="):
        api.price_flat(s0=100.0, sigma=0.2, rate=0.1, maturity=0.25,
                       execution=cfg, platform="cpu")
    with pytest.raises(TypeError, match="both execution="):
        japi.price_grid(execution=japi.ExecutionConfig(), backend="jnp",
                        **_LEGACY_GRID)


@pytest.mark.parametrize("legacy,err,match", [
    (dict(devices=3, platform="cpu", mesh=("cpu", "cpu")), ValueError,
     "conflicts"),
    (dict(n_paths=255, engine="lsmc", platform="cpu"), ValueError,
     "even n_paths"),
    (dict(seed=3, basis="hermite", engine="lsmc", platform="cpu"),
     ValueError, "unknown basis"),
    (dict(platform="tpu"), ValueError, "platform"),
    (dict(interpret=True, platform="gpu"), ValueError, "interpret"),
    (dict(interpret=False, platform="cpu"), ValueError, "interpret"),
], ids=["devices", "n_paths", "seed", "tpu", "interpret-gpu", "compiled-cpu"])
def test_legacy_kwargs_the_port_cannot_honour_raise(legacy, err, match,
                                                   fresh_legacy_warning):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(err, match=match):
            api.price_grid(**legacy, **_LEGACY_GRID)
        with pytest.raises(err, match=match):
            api.price_flat(s0=100.0, sigma=0.2, rate=0.1, maturity=0.25,
                           n_steps=4, **legacy)


def _weird():
    """A cash-settled payoff outside the 4-parameter family, in both
    frameworks: (90 - S/2)^+ in cash."""
    return (api.cash_settled(
        "weird", lambda s: torch.clamp_min(90.0 - 0.5 * s, 0.0)),
        j_cash_settled("weird", lambda s: jnp.maximum(90.0 - 0.5 * s, 0.0)))


def test_closure_only_payoff_intrinsic_matches_jax():
    pay, jpay = _weird()
    assert pay.params is None and jpay.params is None
    s = np.linspace(60.0, 220.0, 33)
    want = np.asarray(jpay.intrinsic(s))
    np.testing.assert_array_equal(pay.intrinsic(s), want)
    np.testing.assert_array_equal(pay.intrinsic(torch.from_numpy(s)).numpy(),
                                  want)
    # the family's own form and its closure form agree
    bull = api.bull_spread(95.0, 105.0)
    g = api.cash_settled("b", lambda x: torch.clamp_min(x - 95.0, 0.0)
                         - torch.clamp_min(x - 105.0, 0.0))
    np.testing.assert_allclose(g.intrinsic(s), bull.intrinsic(s), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("cost_rate", [0.0, 0.01])
def test_closure_only_payoff_prices_match_jax(cost_rate):
    """``cash_settled`` with a closure prices on ``backend="torch"`` as the
    JAX package's jnp engine (and its numpy oracle at cost 0) does."""
    pay, jpay = _weird()
    kw = dict(s0=100.0, sigma=0.2, rate=0.1, maturity=0.25, n_steps=12)
    ref = japi.price_american(payoff=jpay, cost_rate=cost_rate, capacity=16,
                              **kw)
    got = api.price_american(payoff=pay, cost_rate=cost_rate, capacity=16,
                             execution=_cfg("torch"), **kw)
    assert got.ask == pytest.approx(ref.ask, abs=TOL)
    assert got.bid == pytest.approx(ref.bid, abs=TOL)
    assert got.ask > 0.0
    if cost_rate > 0.0:
        m = dict(kw, cost_rate=cost_rate)
        jr = j_price_rz(JLatticeModel(**m), jpay, capacity=16, backend="jnp")
        r = price_rz(LatticeModel(**m), pay, capacity=16, backend="torch",
                     device="cpu")
        assert r.ask == pytest.approx(jr.ask, abs=TOL)
        assert r.bid == pytest.approx(jr.bid, abs=TOL)
        assert r.max_pieces == int(jr.max_pieces)
        assert r.ask > r.bid


def test_kernel_backend_refuses_closure_only_payoff_as_jax_does():
    pay, jpay = _weird()
    kw = dict(s0=100.0, sigma=0.2, rate=0.1, maturity=0.25, n_steps=8)
    with pytest.raises(ValueError, match="pallas"):
        j_price_rz(JLatticeModel(cost_rate=0.01, **kw), jpay, capacity=16,
                   backend="pallas")
    with pytest.raises(ValueError, match="closure-only.*backend='torch'"):
        price_rz(LatticeModel(cost_rate=0.01, **kw), pay, capacity=16,
                 backend="kernel", device="cpu")
    for cost_rate in (0.0, 0.01):
        with pytest.raises(ValueError, match="closure-only"):
            api.price_american(payoff=pay, cost_rate=cost_rate, capacity=16,
                               execution=_cfg("kernel"), **kw)


def test_scenario_grid_matches_jax_layout():
    kw = dict(s0=(95.0, 105.0), cost_rate=(0.0, 0.01),
              payoff=("put", "bull_spread"), strike=(100.0,), n_steps=6)
    j, t = JS.ScenarioGrid.cartesian(**kw), ScenarioGrid.cartesian(**kw)
    c = grid_from_columns(j)
    for name in ("s0", "sigma", "rate", "maturity", "cost_rate", "strike",
                 "strike2"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        np.testing.assert_array_equal(getattr(c, name), getattr(j, name))
    assert t.payoff == j.payoff and t.shape == j.shape == c.shape
    for got, want in ((t.pad_to(11), j.pad_to(11)),):
        assert got.shape == want.shape and got.payoff == want.payoff
        np.testing.assert_array_equal(got.s0, want.s0)
    assert t.flat().shape == (t.n_scenarios,)
    for any_tc in (True, False):
        for n_assets, ex in ((1, None), (2, None)):
            assert route_engine(any_tc=any_tc, n_assets=n_assets,
                                exercise_steps=ex) == JS.route_engine(
                any_tc=any_tc, n_assets=n_assets, exercise_steps=ex)


def test_unported_paths_raise_naming_the_roadmap():
    """LSMC (Queue A #6), scenario sharding (#7) and the pricing
    service (#8) run now; what is left unported raises naming its
    ROADMAP item: the launcher's node axis (#7) and the language models
    not ported yet (#11)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import price as launch
    g = ScenarioGrid.cartesian(s0=100.0, n_steps=4)
    mc = api.price_grid(g, execution=api.ExecutionConfig(
        engine="lsmc", device="cpu", n_paths=256))
    assert mc.engine == "lsmc" and (mc.stderr > 0).all()
    two = api.price_grid(g, execution=api.ExecutionConfig(device="cpu",
                                                          devices=2))
    assert two.shard_info.plan.n_shards == 2 and two.shard_info.simulated
    with pytest.raises(TypeError, match="sequence of torch.device"):
        api.price_grid(g, mesh=object(), execution=_cfg("torch"))
    with pytest.raises(ValueError, match="backend"):
        api.price_grid(g, execution=_cfg("jnp"))
    with pytest.raises(NotImplementedError,
                       match=r"Queue A #7 \(node axis\)"):
        launch.main(["--model", "2", "--device", "cpu", "--n-steps", "4"])
    with pytest.raises(KeyError, match="Queue A #11"):
        get_config("qwen3-0.6b")


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    """No quiet CPU fallback: asking for the card where there is none
    raises; the CPU runs only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert api.ExecutionConfig().resolved().device == "cuda"
    assert api.ExecutionConfig().resolved().backend == "kernel"
    g = ScenarioGrid.cartesian(s0=100.0, n_steps=4)
    with pytest.raises(RuntimeError, match="cuda"):
        api.price_grid(g)
    with pytest.raises(RuntimeError, match="cuda"):
        api.price_american(s0=100.0, sigma=0.2, rate=0.1, maturity=0.25,
                           n_steps=4, cost_rate=0.01)
    with pytest.raises(RuntimeError):
        D.resolve_device("cuda")
    assert D.resolve_device("cpu").type == "cpu"
    assert api.price_grid(g, execution=_cfg("kernel")).ask.shape == g.shape


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in files
             if "repro_torch" in str(p)}
    assert {"kernels/flash_attention.py", "kernels/lru_scan.py",
            "models/layers.py", "models/transformer.py", "serve/engine.py",
            "launch/serve.py", "configs/base.py",
            "configs/recurrentgemma_2b.py", "core/lsmc.py",
            "core/distributed.py", "core/partition.py",
            "launch/price.py"} <= names
    for path in files:
        text = path.read_text()
        assert not _FORBIDDEN.search(text), path
        for node in ast.walk(ast.parse(text)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                    path, name)
