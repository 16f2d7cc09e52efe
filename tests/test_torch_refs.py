"""Port parity: the numpy oracles and the pricing path's remaining
functions, against the JAX package on the CPU.

* ``core/pwl_ref.py`` and ``core/rz_ref.py``, the port's own copies of
  JAX's numpy oracles, give JAX's numbers exactly (the same numpy code;
  the payoff's xi and zeta come from its parameters);
* ``pwl.merge_sorted`` is exact, ``from_ref`` and ``to_ref`` give JAX's
  records and oracle functions exactly;
* ``rz.rz_level_step`` and ``notc.price_notc_torch`` (the twin of
  ``price_notc_jax``) agree with JAX's to the repo's 1e-9 with equal
  knot counts; ``rz.price_rz_batch`` with JAX's exact oracle, row by row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64)
from repro.core import LatticeModel as JLatticeModel
from repro.core import pwl as JP
from repro.core import pwl_ref as JR
from repro.core.notc import price_notc_jax
from repro.core.payoff import american_call as j_call
from repro.core.payoff import american_put as j_put
from repro.core.payoff import bull_spread as j_bull
from repro.core.rz import _leaf_level as j_leaf_level
from repro.core.rz import rz_level_step as j_rz_level_step
from repro.core.rz_ref import price_ref as j_price_ref

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.core import pwl as P
from repro_torch.core import pwl_ref as TR
from repro_torch.core import rz as R
from repro_torch.core.lattice import LatticeModel
from repro_torch.core.notc import price_notc_torch
from repro_torch.core.payoff import (american_call, american_put,
                                     bull_spread, cash_settled)
from repro_torch.core.rz_ref import price_ref

TOL = 1e-9
MODEL = dict(s0=100.0, sigma=0.2, rate=0.1, maturity=0.25, n_steps=8,
             cost_rate=0.01)
PAYOFFS = [(american_put(100.0), j_put(100.0)),
           (american_call(100.0), j_call(100.0)),
           (bull_spread(95.0, 105.0), j_bull(95.0, 105.0))]


def _random_ref(rng, m, mod):
    xs = np.sort(rng.uniform(-5.0, 5.0, m))
    return mod.PWLRef(xs, rng.uniform(-50.0, 50.0, m),
                      rng.uniform(-120.0, -90.0), rng.uniform(-110.0, -80.0))


def _same_ref(a, b):
    np.testing.assert_array_equal(a.xs, b.xs)
    np.testing.assert_array_equal(a.ys, b.ys)
    assert (a.s_left, a.s_right) == (b.s_left, b.s_right)


@pytest.mark.parametrize("pair", PAYOFFS, ids=["put", "call", "bull"])
def test_rz_oracle_equals_jax_oracle(pair):
    ours, theirs = pair
    got = price_ref(LatticeModel(**MODEL), ours)
    want = j_price_ref(JLatticeModel(**MODEL), theirs)
    assert (got.ask, got.bid, got.max_pieces) == (want.ask, want.bid,
                                                  want.max_pieces)
    _same_ref(got.z_seller_root, want.z_seller_root)
    _same_ref(got.z_buyer_root, want.z_buyer_root)
    # the port's engine against the port's own oracle
    eng = R.price_rz(LatticeModel(**MODEL), ours, capacity=16,
                     backend="torch", device="cpu")
    assert eng.ask == pytest.approx(got.ask, abs=TOL)
    assert eng.bid == pytest.approx(got.bid, abs=TOL)


def test_rz_oracle_takes_a_closure_only_payoff():
    g = cash_settled("g", lambda s: torch.clamp_min(100.0 - s, 0.0))
    got = price_ref(LatticeModel(**MODEL), g)
    eng = R.price_rz(LatticeModel(**MODEL), g, capacity=16, backend="torch",
                     device="cpu")
    assert eng.ask == pytest.approx(got.ask, abs=TOL)
    assert eng.bid == pytest.approx(got.bid, abs=TOL)


def test_pwl_oracle_equals_jax_oracle():
    rng = np.random.default_rng(5)
    for _ in range(6):
        m1, m2 = rng.integers(1, 6, 2)
        f, g = _random_ref(rng, m1, TR), _random_ref(rng, m2, TR)
        jf, jg = (JR.PWLRef(h.xs, h.ys, h.s_left, h.s_right) for h in (f, g))
        _same_ref(TR.pwl_max(f, g), JR.pwl_max(jf, jg))
        _same_ref(TR.pwl_min(f, g), JR.pwl_min(jf, jg))
        _same_ref(f.scale(0.97), jf.scale(0.97))
        a, b = 101.0, 99.0
        lo = TR.pwl_max(f, TR.expense_function(0.0, 0.0, a, b))
        jlo = JR.pwl_max(jf, JR.expense_function(0.0, 0.0, a, b))
        _same_ref(TR.cone_infconv(lo, a, b), JR.cone_infconv(jlo, a, b))
        breaks, slopes = np.sort(rng.uniform(-3, 3, 3)), rng.normal(size=4)
        _same_ref(TR.PWLRef.from_slopes(breaks, slopes, 1.5),
                  JR.PWLRef.from_slopes(breaks, slopes, 1.5))
        y = rng.uniform(-8.0, 8.0, 7)
        np.testing.assert_array_equal(f(y), jf(y))


def test_merge_sorted_and_ref_conversions_match_jax():
    rng = np.random.default_rng(9)
    K = 8
    for _ in range(4):
        na, nb = rng.integers(1, K + 1, 2)
        a = np.full(K, P.BIG)
        b = np.full(K, P.BIG)
        a[:na] = np.sort(rng.uniform(-5, 5, na))
        b[:nb] = np.sort(np.concatenate([a[:min(na, nb) // 2],
                                         rng.uniform(-5, 5, nb - min(na, nb) // 2)]))
        got = P.merge_sorted(torch.tensor(a), torch.tensor(b)).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            JP.merge_sorted(jnp.asarray(a), jnp.asarray(b))))
        ref = _random_ref(rng, int(na), TR)
        jref = JR.PWLRef(ref.xs, ref.ys, ref.s_left, ref.s_right)
        mine, theirs = P.from_ref(ref, K), JP.from_ref(jref, K)
        for x, y in zip(mine, theirs):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        assert mine.m.dtype == torch.int32
        _same_ref(P.to_ref(mine), JP.to_ref(theirs))
    with pytest.raises(ValueError, match="capacity"):
        P.from_ref(_random_ref(rng, 5, TR), 4)


def test_rz_level_step_matches_jax():
    """One seller step and one buyer step from the leaf (N=8, K=8), JAX's
    compiled once with the side as data."""
    n, K = 8, 8
    dt = 0.25 / n
    jparams = dict(s0=jnp.float64(100.0), k=jnp.float64(0.01),
                   sig_sqrt_dt=0.2 * jnp.sqrt(jnp.float64(dt)),
                   r=jnp.exp(jnp.float64(0.1 * dt)))
    leaf = j_leaf_level(n, jparams, K, jnp.float64)
    jpay = j_put(100.0)
    step = jax.jit(lambda z, lvl, side: j_rz_level_step(
        z, lvl, jparams, capacity=K, seller=side, payoff=jpay,
        dtype=jnp.float64))
    t = lambda x: torch.tensor([x], dtype=torch.float64)
    params = R.rz_params(t(100.0), t(0.2), t(0.1), t(0.25), t(0.01),
                         n_steps=n)
    col = {k: v[:, None] for k, v in params.items()}
    z = R.leaf_level(n, params, K)
    pay = american_put(100.0).params
    for seller in (True, False):
        jz, jp = step(leaf, jnp.float64(n), jnp.asarray(seller))
        tz, tp = R.rz_level_step(z, float(n), col, pay, capacity=K,
                                 seller=seller)
        assert int(tp) == int(jp)
        for a, b in zip(tz, jz):
            np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=0,
                                       atol=TOL)


def test_price_rz_batch_matches_jax():
    """A batch of puts against the JAX package's exact oracle, row by row
    (prices to 1e-9), and each row's knot count against the port's
    single-contract engine (JAX's ``price_rz_batch`` is its vmapped
    ``price_rz``)."""
    s0 = np.array([92.0, 100.0, 108.0])
    k = np.array([0.005, 0.01, 0.0])
    ask, bid, pieces = R.price_rz_batch(s0, 0.2, 0.1, 0.25, k, n_steps=8,
                                        capacity=16,
                                        payoff=american_put(100.0),
                                        device="cpu")
    assert ask.shape == bid.shape == pieces.shape == (3,)
    for i in range(3):
        kw = dict(MODEL, s0=float(s0[i]), cost_rate=float(k[i]))
        want = j_price_ref(JLatticeModel(**kw), j_put(100.0))
        assert float(ask[i]) == pytest.approx(want.ask, abs=TOL)
        assert float(bid[i]) == pytest.approx(want.bid, abs=TOL)
        one = R.price_rz(LatticeModel(**kw), american_put(100.0),
                         capacity=16, backend="torch", device="cpu")
        assert int(pieces[i]) == one.max_pieces


@pytest.mark.parametrize("pair", PAYOFFS, ids=["put", "call", "bull"])
def test_price_notc_torch_matches_price_notc_jax(pair):
    ours, theirs = pair
    m = dict(s0=98.0, sigma=0.3, rate=0.06, maturity=1.0, n_steps=30)
    if ours.name.startswith("bull"):
        with pytest.raises(ValueError, match="vanilla put/call"):
            price_notc_torch(LatticeModel(**m), ours, device="cpu")
        with pytest.raises(ValueError, match="vanilla put/call"):
            price_notc_jax(JLatticeModel(**m), theirs)
        return
    got = price_notc_torch(LatticeModel(**m), ours, device="cpu")
    assert got == pytest.approx(price_notc_jax(JLatticeModel(**m), theirs),
                                abs=TOL)
