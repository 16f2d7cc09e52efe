"""Port parity: the least-squares Monte Carlo engine, on the CPU.

The port draws JAX's own normals (``core/lsmc.py``: threefry2x32 keys
and counters, the float64 uniform, ``sqrt(2) * erfinv``), so it is held
to the JAX package directly:

* **the keys and the sampler**: ``path_keys`` equals JAX's bit for bit;
  the uniforms equal ``jax.random.uniform``'s bit for bit and the
  normals ``jax.random.normal``'s within 1e-12 relative
  (``torch.erfinv`` against XLA's ``erf_inv``);
* **the estimator on JAX's own normals** (``lsmc_rows(z=...)``) and
  **``price_grid_lsmc`` with the same seed**: ask, bid and stderr agree
  with JAX's ``price_grid_lsmc`` to 1e-9 (float64, at most 2048 paths, so
  no exercise decision sits within a few ulps of its continuation
  value);
* **statistically** (``tests/_stats.py``), as ``tests/test_lsmc.py``
  holds JAX's: within 3 standard errors of the lattice oracle at N=200
  with 8192 paths, and bit-equal across repeats, padding, simulated and
  explicit meshes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _stats import assert_within_se

import repro.core  # noqa: F401  (x64)
from repro import scenarios as JS
from repro.core import lsmc as JL

from repro_torch import api
from repro_torch import scenarios as TS
from repro_torch.core import lsmc as TL
from repro_torch.core.lattice import LatticeModel
from repro_torch.core.notc import price_notc_np
from repro_torch.core.payoff import american_put

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-9
# torch.erfinv against XLA's erf_inv, float64, relative: the two differ
# by up to 2.4e-13 of the value, 1.1e-12 absolute at |z| of about 4.7
NORMAL_RTOL = 1e-12
CPU = torch.device("cpu")
MKT = dict(s0=100.0, sigma=0.2, rate=0.1, maturity=0.25)

# (label, grid kwargs, n_paths, basis, degree, antithetic, seed)
_PARITY = [
    ("poly-anti-d1", dict(n_steps=20), 2048, "poly", 3, True, 0),
    ("laguerre-anti-d1", dict(n_steps=20), 2048, "laguerre", 3, True, 1),
    ("poly-plain-d1-tc", dict(n_steps=16, cost_rate=(0.0, 0.01)), 1024,
     "poly", 2, False, 2),
    ("laguerre-d3-step0", dict(n_steps=20, n_assets=3,
                               exercise_steps=(0, 5, 10, 20)),
     2048, "laguerre", 3, True, 3),
    ("poly-plain-d3-bermudan-tc", dict(n_steps=12, n_assets=3,
                                       cost_rate=0.01,
                                       exercise_steps=(4, 12)),
     1024, "poly", 4, False, 4),
    ("laguerre-plain-d1-one-date", dict(n_steps=8, exercise_steps=(0, 8)),
     512, "laguerre", 1, False, 5),
]


def _parity_grid(kw):
    base = dict(s0=(90.0, 100.0, 110.0), sigma=(0.2, 0.3), rate=0.06,
                maturity=0.5, strike=100.0, payoff=("put", "call"))
    base.update(kw)
    return JS.ScenarioGrid.cartesian(**base), TS.ScenarioGrid.cartesian(**base)


@pytest.mark.parametrize("case", _PARITY, ids=lambda c: c[0])
def test_estimator_on_jax_normals_matches_jax(case):
    _, kw, paths, basis, degree, anti, seed = case
    jg, tg = _parity_grid(kw)
    want = JS.price_grid_lsmc(jg, n_paths=paths, seed=seed, basis=basis,
                              degree=degree, antithetic=anti)
    steps = TL.exercise_schedule(tg.n_steps, tg.exercise_steps)
    assert steps == JL.exercise_schedule(jg.n_steps, jg.exercise_steps)
    n_sim = sum(1 for s in steps if s > 0)
    m = paths // 2 if anti else paths
    keys = JL.path_keys(seed, jg.n_scenarios)
    z = np.stack([np.asarray(jax.random.normal(
        keys[i], (m, n_sim, tg.n_assets), jnp.float64))
        for i in range(jg.n_scenarios)])
    cols = TS._grid_inputs(tg, CPU)
    ask, bid, se = TL.lsmc_rows(
        *cols, None, n_steps=tg.n_steps, steps=steps, n_paths=paths,
        n_assets=tg.n_assets, degree=degree, basis=basis, antithetic=anti,
        z=torch.from_numpy(z))
    for got, ref in ((ask, want.ask), (bid, want.bid), (se, want.stderr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref).ravel(),
                                   rtol=0, atol=TOL)
    assert (se.numpy() > 0).all()
    # the port's own draws are JAX's, and so are its prices
    tkeys = TL.path_keys(seed, tg.n_scenarios)
    np.testing.assert_allclose(
        TL.normals(tkeys, (m, n_sim, tg.n_assets)).numpy(), z,
        rtol=NORMAL_RTOL)
    own = TS.price_grid_lsmc(tg, n_paths=paths, seed=seed, basis=basis,
                             degree=degree, antithetic=anti, device="cpu")
    for f in ("ask", "bid", "stderr"):
        np.testing.assert_allclose(getattr(own, f), np.asarray(
            getattr(want, f)), rtol=0, atol=TOL, err_msg=f)


@pytest.mark.parametrize("kind", TL.LSMC_BASES)
def test_basis_matrix_matches_jax(kind):
    x = np.random.default_rng(0).uniform(0.3, 2.5, 64)
    for degree in range(6):
        got = TL.basis_matrix(torch.from_numpy(x), degree, kind).numpy()
        want = np.asarray(JL.basis_matrix(jnp.asarray(x), degree, kind))
        assert got.shape == want.shape == (64, degree + 1)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for bad_kind, bad_degree in ((kind, -1), ("hermite", 2)):
        with pytest.raises(ValueError) as jx:
            JL.basis_matrix(jnp.asarray(x), bad_degree, bad_kind)
        with pytest.raises(ValueError) as tx:
            TL.basis_matrix(torch.from_numpy(x), bad_degree, bad_kind)
        assert str(tx.value) == str(jx.value)


@pytest.mark.parametrize("n,steps", [(10, None), (10, (10, 3)),
                                     (10, (3, 5)), (10, (0, 11, 10)),
                                     (10, ()), (7, [7, 7, 0])])
def test_exercise_schedule_matches_jax(n, steps):
    try:
        want = JL.exercise_schedule(n, steps)
    except ValueError as exc:
        with pytest.raises(ValueError) as tx:
            TL.exercise_schedule(n, steps)
        assert str(tx.value) == str(exc)
    else:
        assert TL.exercise_schedule(n, steps) == want


def test_grid_and_simulate_guards_match_jax():
    for kw in (dict(exercise_steps=(3, 5)), dict(n_assets=0)):
        with pytest.raises(ValueError) as jx:
            JS.ScenarioGrid.cartesian(n_steps=10, **kw)
        with pytest.raises(ValueError) as tx:
            TS.ScenarioGrid.cartesian(n_steps=10, **kw)
        assert str(tx.value) == str(jx.value)
    one = torch.ones(1, dtype=torch.float64)
    for steps, paths in (((0,), 4), ((0, 4), 5)):
        kw = dict(n_steps=4, steps=steps, n_paths=paths, n_assets=1,
                  antithetic=True)
        with pytest.raises(ValueError) as jx:
            JL.simulate_basket(100.0, 0.2, 0.1, 1.0, None, **kw)
        with pytest.raises(ValueError) as tx:
            TL.simulate_basket(one, one, one, one, **kw)
        assert str(tx.value) == str(jx.value)
    for kw in (dict(n_paths=255), dict(basis="hermite")):
        g = JS.ScenarioGrid.cartesian(n_steps=8, exercise_steps=(0, 8))
        with pytest.raises(ValueError) as jx:
            JS.price_grid_lsmc(g, **kw)
        with pytest.raises(ValueError) as tx:
            TS.price_grid_lsmc(TS.ScenarioGrid.cartesian(
                n_steps=8, exercise_steps=(0, 8)), device="cpu", **kw)
        assert str(tx.value) == str(jx.value)


def _oracle_put(n_steps=200):
    return price_notc_np(LatticeModel(n_steps=n_steps, **MKT),
                         american_put(100.0))


@pytest.fixture(scope="module")
def deep_runs():
    grid = TS.ScenarioGrid.cartesian(n_steps=200, strike=100.0,
                                     payoff="put", **MKT)
    return {seed: TS.price_grid_lsmc(grid, n_paths=8192, seed=seed,
                                     device="cpu") for seed in (0, 1)}


def test_own_sampler_within_3se_of_lattice_oracle(deep_runs):
    res = deep_runs[0]
    se = float(res.stderr.ravel()[0])
    assert se > 0.0 and res.engine == "lsmc"
    assert_within_se(res.ask.ravel()[0], _oracle_put(), se, k=3.0,
                     label="port lsmc vs notc american put")


def test_seed_changes_price_but_stays_in_band(deep_runs):
    target = _oracle_put()
    p0, p1 = (float(deep_runs[s].ask.ravel()[0]) for s in (0, 1))
    assert p0 != p1
    for s in (0, 1):
        assert_within_se(deep_runs[s].ask.ravel()[0], target,
                         float(deep_runs[s].stderr.ravel()[0]), k=4.0,
                         label=f"seed={s}")


def test_repeat_pad_and_layouts_bit_equal():
    grid = TS.ScenarioGrid.cartesian(s0=(90.0, 100.0, 110.0), sigma=0.2,
                                     rate=0.1, maturity=0.25, n_steps=50,
                                     strike=100.0, cost_rate=(0.0, 0.01),
                                     exercise_steps=(10, 25, 50))
    run = lambda g, **kw: TS.price_grid_lsmc(g, n_paths=1024, seed=3,
                                             device="cpu", **kw)
    a = run(grid)
    outs = {"repeat": run(grid), "devices=4": run(grid, devices=4),
            "mesh=(cpu,)*4": run(grid, mesh=(CPU,) * 4)}
    for label, b in outs.items():
        for f in ("ask", "bid", "stderr", "row_pieces"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (label, f)
    assert outs["devices=4"].shard_info.simulated
    assert not outs["mesh=(cpu,)*4"].shard_info.simulated
    assert outs["devices=4"].shard_info.plan == \
        outs["mesh=(cpu,)*4"].shard_info.plan
    d = run(grid.pad_to(8))
    for f in ("ask", "bid", "stderr"):
        assert np.array_equal(getattr(a, f).ravel(),
                              getattr(d, f).ravel()[:6]), f


def test_row_seed_depends_on_seed_and_index_only():
    """The row keys are JAX's ``path_keys`` bit for bit (a seed past 2^32
    fills both words of ``PRNGKey``), and a function of (seed, row)
    only; the uniforms of a key equal ``jax.random.uniform``'s bit for
    bit, its normals ``jax.random.normal``'s within 1e-12
    relative."""
    for seed in (0, 7, 2 ** 40 + 3):
        want = np.asarray(JL.path_keys(seed, 9)).astype(np.int64)
        got = TL.path_keys(seed, 9)
        assert got.dtype == torch.int64 and got.shape == (9, 2)
        assert np.array_equal(got.numpy(), want), seed
    a, b = TL.path_keys(7, 4), TL.path_keys(7, 9)
    assert torch.equal(a, b[:4]) and not torch.equal(TL.path_keys(8, 4), a)
    assert len({tuple(r) for r in b.tolist()}) == 9
    shape = (40, 3, 2)
    keys, jkeys = TL.path_keys(2 ** 40 + 3, 3), JL.path_keys(2 ** 40 + 3, 3)
    lo = np.nextafter(-1.0, 0.0)
    ju = np.stack([np.asarray(jax.random.uniform(
        jkeys[i], shape, jnp.float64, lo, 1.0)) for i in range(3)])
    jz = np.stack([np.asarray(jax.random.normal(jkeys[i], shape,
                                                jnp.float64))
                   for i in range(3)])
    assert np.array_equal(TL.uniforms(keys, shape).numpy(), ju)
    np.testing.assert_allclose(TL.normals(keys, shape).numpy(), jz,
                               rtol=NORMAL_RTOL)
    assert TL.chunk_rows(100_000, 50, 1) == TL.chunk_rows(100_000, 50, 1)


def test_greeks_share_the_rows_seed_and_shard_alike():
    grid = TS.ScenarioGrid.cartesian(s0=(95.0, 105.0), n_steps=12,
                                     strike=100.0, n_assets=2,
                                     exercise_steps=(6, 12))
    run = lambda **kw: TS.price_grid_lsmc(grid, n_paths=512, seed=0,
                                          greeks=True, device="cpu", **kw)
    one, four = run(), run(devices=4)
    assert four.shard_info.plan.n_rows == 5 * grid.n_scenarios
    for f in ("ask", "delta_ask", "vega_ask", "stderr"):
        assert np.array_equal(getattr(one, f), getattr(four, f)), f
    # common random numbers: the bumped copies draw the row's own normals,
    # so delta is the difference of two grids priced alone with one seed
    ds = 1e-4 * grid.s0
    up, down = (TS.price_grid_lsmc(
        TS.ScenarioGrid.cartesian(s0=tuple(grid.s0 + sgn * ds), n_steps=12,
                                  strike=100.0, n_assets=2,
                                  exercise_steps=(6, 12)),
        n_paths=512, seed=0, device="cpu") for sgn in (1.0, -1.0))
    np.testing.assert_allclose(
        one.delta_ask.ravel(), (up.ask.ravel() - down.ask.ravel()) / (2 * ds),
        rtol=1e-12, atol=0)


def test_api_prices_lsmc_through_execution_and_legacy_kwargs():
    kw = dict(s0=(95.0, 105.0), n_steps=12, strike=100.0, n_assets=2,
              exercise_steps=(6, 12))
    cfg = api.ExecutionConfig(device="cpu", n_paths=512, mc_seed=4,
                              basis="laguerre", degree=2, antithetic=False)
    via_cfg = api.price_flat(execution=cfg, sigma=0.2, rate=0.1,
                             maturity=0.25, **kw)
    api._reset_legacy_exec_warning()
    with pytest.warns(DeprecationWarning):
        legacy = api.price_flat(platform="cpu", n_paths=512, seed=4,
                                basis="laguerre", degree=2, antithetic=False,
                                sigma=0.2, rate=0.1, maturity=0.25, **kw)
    api._reset_legacy_exec_warning()
    assert via_cfg.engine == legacy.engine == "lsmc"     # auto routes
    for f in ("ask", "bid", "stderr"):
        assert np.array_equal(getattr(via_cfg, f), getattr(legacy, f)), f
    assert (via_cfg.stderr > 0).all() and via_cfg.shard_info is None
