"""Port parity: the node axis of ``core/distributed.py``, on the CPU.

``plan_rounds`` equals the JAX package's dict.  ``build_rz_sharded`` and
``build_notc_sharded`` run on meshes that repeat the CPU, in this one
process: every node-axis width W in {1, 2, 3, 4}, round depths {1, 3,
8} and a forced small ``collapse_lanes`` give ask, bid, price and
``max_pieces`` equal bit for bit to the port's own W=1 run (every lane
does the same arithmetic wherever it lies), within 1e-9 of the JAX
package's numpy oracles, with ``max_pieces`` equal to the count of
JAX's engine (``price_grid``, both payoffs in one compile).  The JAX
builders themselves, on a 1 x 1 mesh with halo rounds, are held to the
port in ``tests/test_torch_launch.py``, which compiles them for the
launcher already.  ``lane0`` on both kernels' plain versions gives a
window of an unshifted round.  No subprocess and no ``XLA_FLAGS``.
"""
import numpy as np
import pytest
import torch

import repro.core as JC  # noqa: F401  (x64)
from repro import api as j_api
from repro.core.distributed import plan_rounds as j_plan_rounds
from repro.core.lattice import LatticeModel as JLatticeModel
from repro.core.payoff import american_call as j_call
from repro.core.payoff import american_put as j_put
from repro.core.payoff import bull_spread as j_bull

from repro_torch.core import distributed as D
from repro_torch.core.payoff import american_put, bull_spread, cash_settled
from repro_torch.core.rz import _fused_leaf, rz_params
from repro_torch.kernels import binomial_step as TB
from repro_torch.kernels import rz_step as TR
from repro_torch.launch.mesh import make_test_mesh

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-9
CPU = torch.device("cpu")
SPOTS = np.linspace(90.0, 110.0, 4)
TC_STEPS, TC_K, COST = 16, 16, 0.01
NOTC_STEPS, NOTC_BLOCK = 40, 8
# the numpy oracles are slow here (their payoffs call jnp on every
# level's spots), so they check two of the rows
ORACLE_ROWS = (1, 2)
# (W, round depth, collapse_lanes): every width, every depth, and small
# collapse widths that force halo rounds on one shard too; each is held
# to the first, W=1
LAYOUTS = ((1, 3, 5), (2, 1, None), (3, 3, 5), (4, 8, 3))


def _mesh(model, data=1):
    return D.DeviceMesh([[CPU] * model] * data, ("data", "model"))


def _col(x):
    return np.full(len(SPOTS), x)


@pytest.mark.parametrize("n_steps,n_shards,depth,collapse", [
    (1500, 1, 5, None), (1500, 2, 5, None), (1500, 4, 5, None),
    (39999, 4, 50, None), (20, 3, 3, 5), (20, 4, 8, 3), (20, 2, 1, None),
    (6, 2, 3, None), (16, 2, 3, None), (5, 8, 3, None), (30, 3, 40, 2),
    (149, 4, 8, 3)])
def test_plan_rounds_equals_jax(n_steps, n_shards, depth, collapse):
    assert (D.plan_rounds(n_steps, n_shards, depth, collapse)
            == j_plan_rounds(n_steps, n_shards, depth, collapse))


def _rz(layout, pay, backend="kernel", data=1):
    W, depth, collapse = layout
    f = D.build_rz_sharded(_mesh(W, data), n_steps=TC_STEPS, payoff=pay,
                           capacity=TC_K, round_depth=depth,
                           collapse_lanes=collapse, backend=backend)
    return f(SPOTS, _col(0.2), _col(0.1), _col(0.25), _col(COST))


@pytest.fixture(scope="module")
def jax_pieces():
    """JAX's knot count of the TC rows, each payoff's max over its rows:
    one grid, payoffs as data, one compile."""
    n = len(SPOTS)
    grid = j_api.ScenarioGrid.explicit(
        s0=np.r_[SPOTS, SPOTS], sigma=0.2, rate=0.1, maturity=0.25,
        cost_rate=COST, payoff=("put",) * n + ("bull_spread",) * n,
        strike=(100.0,) * n + (95.0,) * n,
        strike2=(100.0,) * n + (105.0,) * n, n_steps=TC_STEPS)
    rp = j_api.price_grid(grid, capacity=TC_K).row_pieces.ravel()
    return {"put": int(rp[:n].max()), "bull_spread": int(rp[n:].max())}


@pytest.mark.parametrize("name", ["put", "bull_spread"])
def test_rz_node_axis_every_width_equals_one_and_the_oracles(name,
                                                               jax_pieces):
    pay, jpay = ((american_put(100.0), j_put(100.0)) if name == "put"
                 else (bull_spread(), j_bull()))
    ask, bid, pieces = _rz(LAYOUTS[0], pay)
    for layout in LAYOUTS:
        assert D.plan_rounds(TC_STEPS, layout[0], layout[1],
                             layout[2])["rounds"] > 0
    for layout in LAYOUTS[1:]:
        a, b, p = _rz(layout, pay)
        assert torch.equal(a, ask) and torch.equal(b, bid), layout
        assert p == pieces, layout
    a, b, p = _rz(LAYOUTS[2], pay, backend="torch")
    assert torch.equal(a, ask) and torch.equal(b, bid) and p == pieces
    for i in ORACLE_ROWS:
        ref = JC.price_ref(JLatticeModel(
            s0=float(SPOTS[i]), sigma=0.2, rate=0.1, maturity=0.25,
            n_steps=TC_STEPS, cost_rate=COST), jpay)
        assert abs(float(ask[i]) - ref.ask) <= TOL
        assert abs(float(bid[i]) - ref.bid) <= TOL
    assert pieces == jax_pieces[name]


def test_rz_node_axis_over_a_data_axis_equals_one_row():
    ask, bid, pieces = _rz(LAYOUTS[0], american_put(100.0))
    a, b, p = _rz((2, 3, 5), american_put(100.0), data=2)
    assert torch.equal(a, ask) and torch.equal(b, bid) and p == pieces


def _notc(layout, kind, backend="kernel"):
    W, depth, collapse = layout
    f = D.build_notc_sharded(_mesh(W), n_steps=NOTC_STEPS, strike=100.0,
                             kind=kind, round_depth=depth,
                             collapse_lanes=collapse, backend=backend,
                             block=NOTC_BLOCK)
    return f(SPOTS, _col(0.3), _col(0.06), _col(1.0))


@pytest.mark.parametrize("kind", ["put", "call"])
def test_notc_node_axis_every_width_equals_one_and_the_oracle(kind):
    price = _notc(LAYOUTS[0], kind)
    for layout in LAYOUTS:
        assert D.plan_rounds(NOTC_STEPS - 1, layout[0], layout[1],
                             layout[2])["rounds"] > 0
    for layout in LAYOUTS[1:]:
        assert torch.equal(_notc(layout, kind), price), layout
    assert (_notc(LAYOUTS[2], kind, backend="torch") - price).abs().max() \
        <= TOL
    jpay = j_put(100.0) if kind == "put" else j_call(100.0)
    for i in ORACLE_ROWS:
        want = JC.price_notc_np(JLatticeModel(
            s0=float(SPOTS[i]), sigma=0.3, rate=0.06, maturity=1.0,
            n_steps=NOTC_STEPS), jpay)
        assert abs(float(price[i]) - want) <= TOL


def test_rz_round_lane0_is_a_window_of_the_unshifted_round():
    """Windows of S owned and L halo lanes at tree columns lane0 = 0, S,
    2S, ... step as the whole row does; their pieces over the owned lanes
    make up the row's."""
    n, K, L, S = TC_STEPS, TC_K, 4, 6
    lanes = 4 * S + L
    t = lambda *x: torch.tensor(x, dtype=torch.float64)
    params = rz_params(t(100.0, 95.0), t(0.2, 0.3), t(0.1, 0.1),
                       t(0.25, 0.25), t(0.01, 0.005), n_steps=n)
    z = _fused_leaf(n, params, K, lanes)
    pay = bull_spread().params
    sc = torch.stack([t(n + 1.0, n + 1.0), params["s0"],
                      params["sig_sqrt_dt"], params["r"], params["k"],
                      *(t(x, x) for x in pay)], dim=1)
    full, full_pc = TR.rz_round(z, sc, levels=L, block=lanes, owned=4 * S)
    pcs = []
    for a in range(0, 4 * S, S):
        win = z.map(lambda x: x[:, :, a:a + S + L].contiguous())
        got, pc = TR.rz_round(win, sc, levels=L, block=S + L, lane0=a,
                              owned=S)
        for g, w in zip(got, full):
            assert torch.equal(g[:, :, :S], w[:, :, a:a + S])
        pcs.append(pc)
    assert torch.equal(torch.stack(pcs).amax(dim=0), full_pc)
    assert tuple(TR.tile_plan(S + L, S + L, L, lvl0=12.0, lane0=6)) == \
        (TR.Tile(0, S + L, 7),)


@pytest.mark.parametrize("kind", ["param", "put"])
def test_lattice_round_lane0_is_a_window_of_the_unshifted_round(kind):
    rng = np.random.default_rng(3)
    P, block, levels = 64, 16, 12
    v = torch.tensor(rng.uniform(0.0, 30.0, (3, P)))
    sc = [[60.0, 0.5, 0.99998, 100.0, 0.01, 1.0, -1.0, 0.0, 0.0, 100.0,
           100.0] for _ in range(3)]
    sc = torch.tensor(sc, dtype=torch.float64)
    if kind == "put":
        sc = sc[:, [0, 1, 2, 9, 3, 4]].contiguous()
    kw = {} if kind == "param" else {"kind": kind}
    fn = TB.lattice_round_param if kind == "param" else TB.lattice_round
    full = fn(v, sc, levels=levels, block=block, **kw)
    for a in (16, 20, 32):
        got = fn(v[:, a:a + 32].contiguous(), sc, levels=levels, block=block,
                 lane0=a, **kw)
        assert torch.equal(got[:, :32 - levels], full[:, a:a + 32 - levels])


def test_node_axis_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="split evenly"):
        D.build_notc_sharded(_mesh(1, data=2), n_steps=8, strike=100.0)(
            SPOTS[:3], _col(0.3)[:3], _col(0.06)[:3], _col(1.0)[:3])
    g = cash_settled("g", lambda s: torch.clamp_min(100.0 - s, 0.0))
    with pytest.raises(ValueError, match="closure-only"):
        D.build_rz_sharded(_mesh(2), n_steps=8, payoff=g)
    for build, kw in ((D.build_rz_sharded, dict(payoff=american_put(100.0))),
                      (D.build_notc_sharded, dict(strike=100.0))):
        with pytest.raises(ValueError, match="float64 or torch.float32"):
            build(_mesh(2), n_steps=8, dtype=torch.float16, **kw)
    with pytest.raises(ValueError, match="axes"):
        D.build_notc_sharded(_mesh(2), n_steps=8, strike=100.0,
                             model_axis="nodes")
    with pytest.raises(ValueError, match="sees 1"):
        make_test_mesh(1, 2, kind="cpu")
    mesh = make_test_mesh(2, 3, kind="cpu", repeat=True)
    assert mesh.shape == {"data": 2, "model": 3}
    assert mesh.axis_names == ("data", "model")
