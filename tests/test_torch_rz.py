"""Port parity: the transaction-cost engine and its round kernel.

``rz_round``'s plain version is held against the JAX package's Pallas
``rz_round`` in interpret mode on the same PWL state (single-block and
halo rounds), and white-box against a chain of level steps on its owned
lanes, as ``tests/test_kernels_rz.py`` holds the Pallas kernel.  Knot
counts must be equal; knot values agree to 1e-12 relative.  Prices are
held to the exact sequential oracle (``core/rz_ref.py``) at 1e-9.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64)
from repro.core import LatticeModel as JLatticeModel
from repro.core import bull_spread as j_bull
from repro.core import american_put as j_put
from repro.core import pwl as JP
from repro.core import price_ref
from repro.kernels.rz_step import rz_round as j_rz_round

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.convert import pwl_to_numpy
from repro_torch.core.lattice import LatticeModel
from repro_torch.core.notc import price_notc_np
from repro_torch.core.partition import kernel_round_plan
from repro_torch.core.payoff import american_put, bull_spread
from repro_torch.core.rz import (leaf_level, price_rz, rz_level_step_lanes,
                                 rz_params)
from repro_torch.kernels import rz_step as TR

TOL = 1e-9
RTOL = 1e-12




def _t(*vals, device="cpu"):
    return torch.tensor(vals, dtype=torch.float64, device=device)


def _state(n_steps, capacity, lanes, walk, device="cpu"):
    """A fused (1, 2, lanes) seller/buyer state ``walk`` levels below the
    leaf of a bull spread, and its round scalars; made by the port's
    plain level walk."""
    pay = (0.0, 0.0, 1.0, -1.0, 95.0, 105.0)
    params = rz_params(_t(100.0, device=device), _t(0.2, device=device),
                       _t(0.1, device=device), _t(0.25, device=device),
                       _t(0.01, device=device), n_steps=n_steps)
    z = leaf_level(n_steps, params, capacity, lanes).map(
        lambda a: a[:, None].expand((1, 2) + a.shape[1:]).contiguous())
    col = {k: v[:, None, None] for k, v in params.items()}
    payc = tuple(_t(p, device=device) for p in pay)
    sides = torch.tensor([[True], [False]], device=device)
    for j in range(walk):
        z, _ = rz_level_step_lanes(z, float(n_steps - j), col, payc,
                                   capacity=capacity, seller=sides)
    lvl0 = n_steps + 1 - walk
    sc = torch.stack([_t(lvl0, device=device), params["s0"],
                      params["sig_sqrt_dt"], params["r"], params["k"],
                      *(_t(p, device=device) for p in pay)], dim=1)
    return z, sc


def _assert_state(got, want):
    g = pwl_to_numpy(got)
    w = [np.asarray(a) for a in want]
    np.testing.assert_array_equal(g[4], w[4])
    for a, b in zip(g[:4], w[:4]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("lanes,block,levels,walk",
                         [(12, 12, 5, 2), (12, 4, 3, 1)],
                         ids=["single-block", "halo"])
def test_rz_round_matches_pallas(lanes, block, levels, walk):
    z, sc = _state(10, 12, lanes, walk)
    got, pieces = TR.rz_round(z, sc, levels=levels, block=block)
    jz = JP.PWL(*(jnp.asarray(a[0]) for a in pwl_to_numpy(z)))
    want, jpieces = j_rz_round(jz, jnp.asarray(sc[0].numpy()), levels=levels,
                               block=block)
    _assert_state(got.map(lambda a: a[0]), want)
    assert int(pieces[0]) == int(jpieces)


def test_rz_round_equals_level_step_chain():
    """White-box: one halo round == ``levels`` full-width level steps on
    the owned lanes (the block/halo construction is exact)."""
    n_steps, capacity, block, levels = 9, 12, 4, 3
    z, sc = _state(n_steps, capacity, 12, 0)
    got, pieces = TR.rz_round(z, sc, levels=levels, block=block)
    params = {k: sc[:, i, None, None] for i, k in
              enumerate(("s0", "sig_sqrt_dt", "r", "k"), start=1)}
    pay = tuple(sc[:, 5 + j, None, None] for j in range(6))
    sides = torch.tensor([[True], [False]])
    ref, pc_max = z, torch.zeros(1, dtype=torch.int32)
    for j in range(levels):
        ref, pc = rz_level_step_lanes(ref, float(n_steps + 1 - (j + 1)),
                                      params, pay, capacity=capacity,
                                      seller=sides)
        pc_max = torch.maximum(pc_max, pc.amax(dim=(1, 2)))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(pieces, pc_max)


def test_rz_round_value_errors_match_pallas_contract():
    z, sc = _state(6, 8, 8, 0)
    with pytest.raises(ValueError, match="side axis"):
        TR.rz_round(z, sc, levels=2, block=8, sellers=(True,))
    with pytest.raises(ValueError, match="not a multiple of block"):
        TR.rz_round(z, sc, levels=2, block=3)
    with pytest.raises(ValueError, match="scalars"):
        TR.rz_round(z, sc[:, :6], levels=2, block=8)
    with pytest.raises(ValueError, match="halo staleness"):
        TR.rz_round(z, sc, levels=5, block=4)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("kind", ["put", "bull_spread"])
def test_price_rz_matches_sequential_oracle(backend, kind):
    kw = dict(s0=100.0, sigma=0.2, rate=0.1, maturity=0.25, n_steps=10,
              cost_rate=0.01)
    tp, jp = ((american_put(100.0), j_put(100.0)) if kind == "put"
              else (bull_spread(95.0, 105.0), j_bull(95.0, 105.0)))
    ref = price_ref(JLatticeModel(**kw), jp)
    got = price_rz(LatticeModel(**kw), tp, capacity=16, backend=backend,
                   device="cpu")
    assert got.ask == pytest.approx(ref.ask, abs=TOL)
    assert got.bid == pytest.approx(ref.bid, abs=TOL)
    assert got.bid <= got.ask


def test_price_rz_halo_plan_matches_single_block():
    m = LatticeModel(s0=100.0, sigma=0.2, rate=0.1, maturity=0.25,
                     n_steps=10, cost_rate=0.01)
    pay = american_put(100.0)
    a = price_rz(m, pay, capacity=16, device="cpu")
    b = price_rz(m, pay, capacity=16, levels=3, block=4, device="cpu")
    assert b.ask == pytest.approx(a.ask, abs=TOL)
    assert b.bid == pytest.approx(a.bid, abs=TOL)
    assert b.max_pieces == a.max_pieces


def test_lambda0_collapses_to_notc():
    m = LatticeModel(s0=100.0, sigma=0.2, rate=0.1, maturity=0.25,
                     n_steps=12, cost_rate=0.0)
    want = price_notc_np(m, american_put(100.0))
    for backend in ("torch", "kernel"):
        r = price_rz(m, american_put(100.0), capacity=16, backend=backend,
                     device="cpu")
        assert r.ask == pytest.approx(want, abs=TOL)
        assert r.bid == pytest.approx(want, abs=TOL)


def test_round_plan_matches_jax():
    from repro.core.partition import kernel_round_plan as j_plan
    for n, levels, block in ((10, None, None), (1500, None, None),
                             (12, 6, 8), (40000, 50, 256)):
        got = [(r.lvl0, r.depth, r.lanes, r.block) for r in
               kernel_round_plan(n, levels=levels, block=block)]
        want = [(r.lvl0, r.depth, r.lanes, r.block) for r in
                j_plan(n, levels=levels, block=block)]
        assert got == want


def test_call_knots_are_genuine_kinks():
    """The knot growth of calls (ROADMAP Queue C) is not rounding noise:
    at N=80 the widest function of an American call's walk (s0=K=100,
    k=0.01) has tens of knots, and every two adjacent pieces differ in
    slope by far more than the 1e-9 relative merge threshold."""
    n, capacity = 80, 64
    params = rz_params(_t(100.0), _t(0.2), _t(0.1), _t(0.25), _t(0.01),
                       n_steps=n)
    z = leaf_level(n, params, capacity).map(
        lambda a: a[:, None].expand((1, 2) + a.shape[1:]).contiguous())
    col = {k: v[:, None, None] for k, v in params.items()}
    pay = tuple(_t(p) for p in (-1.0, 1.0, 0.0, 0.0, 100.0, 110.0))
    sides = torch.tensor([[True], [False]])
    widest = (0, None)
    for lvl in range(n, -1, -1):
        z = z.map(lambda a, w=lvl + 2: a[:, :, :w])     # the live tree
        z, _ = rz_level_step_lanes(z, float(lvl), col, pay,
                                   capacity=capacity, seller=sides)
        live = z.m[..., :lvl + 1]
        if int(live.max()) > widest[0]:
            at = np.unravel_index(int(live.argmax()), tuple(live.shape))
            widest = (int(live.max()), z.map(lambda a: a[at]))
    m, f = widest
    assert m >= 20
    xs, ys = f.xs[:m].numpy(), f.ys[:m].numpy()
    slopes = np.concatenate([[float(f.sl)], np.diff(ys) / np.diff(xs),
                             [float(f.sr)]])
    change = np.abs(np.diff(slopes)) / (
        1.0 + np.maximum(np.abs(slopes[1:]), np.abs(slopes[:-1])))
    assert change.min() > 1e-5, change.min()
