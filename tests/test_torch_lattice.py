"""Port parity: the friction-free lattice kernel and its host loops.

The same numpy inputs go through the JAX package (Pallas kernels in
interpret mode on the CPU) and the port (the kernels' plain versions on
the CPU).  Tolerances: one round compares at a relative 1e-13 (a few ulps: the two
packages' ``exp`` differ in the last ulp, and node values reach 1e4 at
the far lanes) plus 1e-12 absolute, prices at the repo's 1e-9.  The card tests hold each CUDA kernel against its plain
version on the same card.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64)
from repro.core import LatticeModel as JLatticeModel
from repro.core import american_call as j_call
from repro.core import american_put as j_put
from repro.core.notc import price_notc_np as j_price_notc_np
from repro.kernels import binomial_step as JB
from repro.kernels.ops import price_notc_kernel as j_price_notc_kernel

from repro_torch.core.lattice import LatticeModel
from repro_torch import api
from repro_torch.core.notc import price_notc_np
from repro_torch.core.payoff import american_call, american_put, bull_spread
from repro_torch.kernels import binomial_step as TB
from repro_torch.kernels.ops import price_notc_kernel

ROUND_TOL = 1e-12
ROUND_RTOL = 1e-13
PRICE_TOL = 1e-9




def _inputs(seed, rows, P, kind):
    rng = np.random.default_rng(seed)
    v = rng.uniform(0.0, 20.0, (rows, P))
    lvl0 = float(P - 20)
    base = [lvl0, 0.51, 0.998]
    if kind == "param":
        sc = [base + [rng.uniform(90, 110), 0.02,
                      *fam, 95.0 + r, 105.0 + r]
              for fam, r in zip([(1.0, -1.0, 0.0, 0.0), (0.0, 0.0, 1.0, -1.0),
                                 (-1.0, 1.0, 0.0, 0.0)][:rows],
                                rng.uniform(-3, 3, rows))]
    else:
        sc = [base + [100.0 + r, rng.uniform(90, 110), 0.02]
              for r in rng.uniform(-3, 3, rows)]
    return v, np.asarray(sc, np.float64)


@pytest.mark.parametrize("levels,block", [(6, 16), (16, 16), (3, 8)])
def test_lattice_round_param_matches_pallas(levels, block):
    v, sc = _inputs(1, 3, 4 * block, "param")
    want = np.stack([np.asarray(JB.lattice_round_param(
        v[i], sc[i], levels=levels, block=block)) for i in range(3)])
    got = TB.lattice_round_param(torch.tensor(v), torch.tensor(sc),
                                 levels=levels, block=block)
    np.testing.assert_allclose(got.numpy(), want, rtol=ROUND_RTOL, atol=ROUND_TOL)


@pytest.mark.parametrize("kind", ["put", "call"])
def test_lattice_round_matches_pallas(kind):
    block, levels = 32, 12
    v, sc = _inputs(2, 2, 3 * block, kind)
    want = np.stack([np.asarray(JB.lattice_round(
        v[i], sc[i], levels=levels, block=block, kind=kind))
        for i in range(2)])
    got = TB.lattice_round(torch.tensor(v), torch.tensor(sc), levels=levels,
                           block=block, kind=kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=ROUND_RTOL, atol=ROUND_TOL)
    # the single-row form of the wrapper
    one = TB.lattice_round(torch.tensor(v[0]), torch.tensor(sc[0]),
                           levels=levels, block=block, kind=kind)
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())


def test_final_short_round_is_a_noop_below_level_zero():
    """Steps whose level is below 0 leave the lanes untouched."""
    v, sc = _inputs(3, 1, 128, "param")
    sc[0, 0] = 2.0                          # levels 1, 0, then no-ops
    a = TB.lattice_round_param(torch.tensor(v), torch.tensor(sc), levels=2,
                               block=64)
    b = TB.lattice_round_param(torch.tensor(v), torch.tensor(sc), levels=30,
                               block=64)
    np.testing.assert_array_equal(a.numpy()[:, :33], b.numpy()[:, :33])


@pytest.mark.parametrize("kind,n", [("put", 24), ("call", 19)])
def test_price_notc_kernel_matches_jax_and_oracles(kind, n):
    m = LatticeModel(s0=100.0, sigma=0.3, rate=0.06, maturity=1.0, n_steps=n)
    jm = JLatticeModel(s0=100.0, sigma=0.3, rate=0.06, maturity=1.0,
                       n_steps=n)
    got = price_notc_kernel(m, 100.0, kind=kind, levels=8, block=16,
                            device="cpu")
    want = j_price_notc_kernel(jm, 100.0, kind=kind, levels=8, block=16)
    jpay = (j_put if kind == "put" else j_call)(100.0)
    tpay = (american_put if kind == "put" else american_call)(100.0)
    assert got == pytest.approx(want, abs=PRICE_TOL)
    assert got == pytest.approx(j_price_notc_np(jm, jpay), abs=PRICE_TOL)
    assert got == pytest.approx(price_notc_np(m, tpay), abs=PRICE_TOL)
    plain = api.price_american(
        s0=100.0, sigma=0.3, rate=0.06, maturity=1.0, n_steps=n,
        payoff=kind, strike=100.0,
        execution=api.ExecutionConfig(backend="torch", device="cpu"))
    assert got == pytest.approx(plain.ask, abs=PRICE_TOL)


def test_numpy_oracle_matches_jax_oracle_on_every_family():
    jm = JLatticeModel(s0=98.0, sigma=0.25, rate=0.05, maturity=0.5,
                       n_steps=12)
    m = LatticeModel(s0=98.0, sigma=0.25, rate=0.05, maturity=0.5,
                     n_steps=12)
    from repro.core import bull_spread as j_bull
    for tp, jp in ((american_put(100.0), j_put(100.0)),
                   (american_call(95.0), j_call(95.0)),
                   (bull_spread(95.0, 105.0), j_bull(95.0, 105.0))):
        assert price_notc_np(m, tp) == pytest.approx(
            j_price_notc_np(jm, jp), abs=PRICE_TOL)


def test_lattice_model_matches_jax():
    kw = dict(s0=100.0, sigma=0.2, rate=0.1, maturity=0.25, n_steps=7,
              cost_rate=0.01)
    a, b = LatticeModel(**kw), JLatticeModel(**kw)
    for name in ("u", "d", "r"):
        assert getattr(a, name) == getattr(b, name)
    assert a.p == b.p_star and a.dt == b.maturity / b.n_steps
    np.testing.assert_array_equal(a.stock_level(7), b.stock_level(7))
    with pytest.raises(ValueError):
        LatticeModel(**{**kw, "cost_rate": 1.0})


def test_wrapper_contracts_and_no_launch_on_cpu():
    v = torch.zeros(1, 128, dtype=torch.float64)
    sc = torch.zeros(1, TB.PARAM_SCALARS, dtype=torch.float64)
    before = dict(TB.LAUNCHES)
    TB.lattice_round_param(v, sc, levels=4, block=64)
    assert TB.LAUNCHES == before            # the plain version is no launch
    with pytest.raises(ValueError, match="multiple of block"):
        TB.lattice_round_param(v, sc, levels=4, block=96)
    with pytest.raises(ValueError, match="levels <= block"):
        TB.lattice_round_param(v, sc, levels=65, block=64)
    with pytest.raises(ValueError, match="scalars"):
        TB.lattice_round_param(v, sc[:, :6], levels=4, block=64)
    with pytest.raises(TypeError, match="float64"):
        TB.lattice_round_param(v.float(), sc, levels=4, block=64)
    with pytest.raises(ValueError, match="kind"):
        TB.lattice_round(v, sc[:, :6], levels=4, block=64, kind="digital")
