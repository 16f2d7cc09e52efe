"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``gpu``: every test skips with a reason where
``torch.cuda.is_available()`` is False (decided inside a fixture, never
at import).  The module imports neither JAX nor the JAX package, so on a
machine without them it runs as

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerance: the kernels repeat their plain versions' float64 arithmetic
operation for operation (no fused multiply-add), so values agree to
1e-9 and knot counts exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.rz import leaf_level, rz_level_step_lanes, rz_params
from repro_torch.kernels import binomial_step as TB
from repro_torch.kernels import rz_step as TR

TOL = 1e-9

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _lattice_inputs(kind, rows, P, device):
    rng = np.random.default_rng(4)
    v = torch.tensor(rng.uniform(0.0, 30.0, (rows, P)), device=device)
    u = rng.uniform(0.0, 1.0, rows)
    if kind == "param":
        fam = [(1.0, -1.0, 0.0, 0.0), (-1.0, 1.0, 0.0, 0.0),
               (0.0, 0.0, 1.0, -1.0)]
        sc = [[P - 100.0, 0.5, 0.99998, 90 + 20 * x, 0.0026, *fam[i % 3],
               95.0 + x, 105.0 + x] for i, x in enumerate(u)]
    else:
        sc = [[P - 100.0, 0.5, 0.99998, 95 + 10 * x, 90 + 20 * x, 0.0026]
              for x in u]
    return v, torch.tensor(sc, dtype=torch.float64, device=device)


@pytest.mark.parametrize("kind", ["param", "put", "call"])
def test_lattice_kernel_matches_plain(cuda, kind):
    v, sc = _lattice_inputs(kind, 4, 40192, cuda)
    fn = TB.lattice_round_param if kind == "param" else TB.lattice_round
    kw = {} if kind == "param" else {"kind": kind}
    n0 = sum(TB.LAUNCHES.values())
    got = fn(v, sc, levels=50, block=256, **kw)
    torch.cuda.synchronize()
    assert sum(TB.LAUNCHES.values()) == n0 + 1
    want = TB.lattice_round_plain(v, sc, levels=50, block=256, kind=kind)
    assert (got - want).abs().max().item() <= TOL


def _rz_state(n_steps, capacity, lanes, walk, device):
    t = lambda *x: torch.tensor(x, dtype=torch.float64, device=device)
    pay = (0.0, 0.0, 1.0, -1.0, 95.0, 105.0)
    params = rz_params(t(100.0, 96.0), t(0.2, 0.25), t(0.1, 0.1),
                       t(0.25, 0.25), t(0.01, 0.005), n_steps=n_steps)
    z = leaf_level(n_steps, params, capacity, lanes).map(
        lambda a: a[:, None].expand((2, 2) + a.shape[1:]).contiguous())
    col = {k: v[:, None, None] for k, v in params.items()}
    payc = tuple(t(p) for p in pay)
    sides = torch.tensor([[True], [False]], device=device)
    for j in range(walk):
        z, _ = rz_level_step_lanes(z, float(n_steps - j), col, payc,
                                   capacity=capacity, seller=sides)
    sc = torch.stack([t(n_steps + 1.0 - walk, n_steps + 1.0 - walk),
                      params["s0"], params["sig_sqrt_dt"], params["r"],
                      params["k"], *(t(p, p) for p in pay)], dim=1)
    return z, sc


@pytest.mark.parametrize("lanes,block,levels,walk",
                         [(302, 302, 64, 20), (384, 128, 64, 20)],
                         ids=["single-block", "halo"])
def test_rz_kernel_matches_plain(cuda, lanes, block, levels, walk):
    z, sc = _rz_state(300, 48, lanes, walk, cuda)
    n0 = TR.LAUNCHES["rz_round"]
    got, pieces = TR.rz_round(z, sc, levels=levels, block=block)
    torch.cuda.synchronize()
    assert TR.LAUNCHES["rz_round"] == n0 + 1
    want, wp = TR.rz_round_plain(z, sc, levels=levels, block=block)
    assert torch.equal(got.m, want.m)
    assert torch.equal(pieces, wp)
    for a, b in zip(got[:4], want[:4]):
        assert (a - b).abs().max().item() <= TOL


def test_grids_on_card_match_the_plain_walks(cuda):
    from repro_torch.kernels import binomial_step, rz_step
    g = api.ScenarioGrid.cartesian(
        s0=(95.0, 105.0), sigma=(0.15, 0.25), cost_rate=(0.0, 0.005, 0.01),
        payoff=("put", "call", "bull_spread"), strike=(95.0, 100.0, 105.0),
        n_steps=10)
    n_rz = rz_step.LAUNCHES["rz_round"]
    n_lat = binomial_step.LAUNCHES["lattice_round_param"]
    tc = api.price_grid(g, capacity=16)
    nt = api.price_grid(g, levels=4, block=16,
                        execution=api.ExecutionConfig(engine="notc"))
    assert rz_step.LAUNCHES["rz_round"] > n_rz
    assert binomial_step.LAUNCHES["lattice_round_param"] > n_lat
    plain = api.ExecutionConfig(backend="torch")
    tc_ref = api.price_grid(g, capacity=16, execution=plain)
    np.testing.assert_allclose(tc.ask, tc_ref.ask, rtol=0, atol=TOL)
    np.testing.assert_allclose(tc.bid, tc_ref.bid, rtol=0, atol=TOL)
    np.testing.assert_array_equal(tc.row_pieces, tc_ref.row_pieces)
    nt_ref = api.price_grid(g, execution=api.ExecutionConfig(
        engine="notc", backend="torch"))
    np.testing.assert_allclose(nt.ask, nt_ref.ask, rtol=0, atol=TOL)
