"""Port parity: the transaction-cost scenario grid, end to end on the CPU.

``repro_torch.api.price_grid`` on the 108-scenario grid of
``tests/test_scenarios.py`` (N=10, capacity 16), on both port backends
(``kernel``: the round loop around ``rz_round``'s plain version;
``torch``: the plain level walk), against ``repro.scenarios``'
``price_grid_rz`` on both JAX backends.  Ask and bid agree to 1e-9 and
``max_pieces`` is equal.  Per-row knot counts are discontinuous in the
last ulp of the arithmetic (see ``test_grid_rz_row_pieces_match_jax``).
The same port grids are held against both surfaces of the committed
golden file ``tests/golden/grid108.json`` at 1e-9, never bitwise: the
file drifts by up to 4.3e-14 even for JAX on this jax version (ROADMAP
Queue C).
The friction-free grid, the Greeks and the rest of the grid API are in
``tests/test_torch_api.py``.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import repro.core  # noqa: F401  (x64)
from repro import scenarios as JS

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch import api
from repro_torch.convert import grid_from_columns

TOL = 1e-9
ROOT = pathlib.Path(__file__).resolve().parents[1]
AXES = dict(s0=(95.0, 105.0), sigma=(0.15, 0.25), cost_rate=(0.0, 0.005, 0.01),
            payoff=("put", "call", "bull_spread"), strike=(95.0, 100.0, 105.0),
            n_steps=10)


def _cfg(backend):
    return api.ExecutionConfig(engine="rz", backend=backend, device="cpu")


_NO_FMA_SCRIPT = """
import json, sys
import repro.core
from repro.scenarios import ScenarioGrid, price_grid_rz
g = ScenarioGrid.cartesian(**json.loads(sys.argv[1]))
res = price_grid_rz(g, capacity=16)
print(json.dumps(res.row_pieces.ravel().tolist()))
"""


@pytest.fixture(scope="module")
def no_fma_run():
    """JAX's compiled walk of the grid with XLA held to an instruction set
    without fused multiply-add, in a fresh process (XLA reads its flags
    once per process).  Started before the in-process references so the
    two compile side by side; read by ``jax_rz_no_fma``."""
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-c", _NO_FMA_SCRIPT,
                             json.dumps(AXES)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def grid108(no_fma_run):
    return JS.ScenarioGrid.cartesian(**AXES)


@pytest.fixture(scope="module")
def jax_rz(grid108):
    return {b: JS.price_grid_rz(grid108, capacity=16, backend=b)
            for b in ("jnp", "pallas")}


@pytest.fixture(scope="module")
def port_rz(grid108):
    return {b: api.price_grid(grid_from_columns(grid108), capacity=16,
                              execution=_cfg(b))
            for b in ("kernel", "torch")}


@pytest.fixture(scope="module")
def jax_rz_no_fma(grid108, no_fma_run):
    out, err = no_fma_run.communicate(timeout=600)
    assert no_fma_run.returncode == 0, err
    pieces = np.asarray(json.loads(out.strip().splitlines()[-1]))
    assert pieces.size == grid108.n_scenarios
    return pieces


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_grid_rz_matches_jax(backend, grid108, jax_rz, port_rz):
    res = port_rz[backend]
    assert res.ask.shape == grid108.shape
    for ref in jax_rz.values():
        np.testing.assert_allclose(res.ask, ref.ask, rtol=0, atol=TOL)
        np.testing.assert_allclose(res.bid, ref.bid, rtol=0, atol=TOL)
        assert res.max_pieces == ref.max_pieces
    assert (res.spread >= -1e-12).all()


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_grid_rz_row_pieces_match_jax(backend, jax_rz, port_rz,
                                      jax_rz_no_fma):
    """Per-row knot counts equal JAX's.  A knot count can change with the
    last ulp of the arithmetic: JAX's own compiled walk gives two
    different counts on a few rows of this grid depending on whether XLA
    may fuse a multiply and an add (ROADMAP Queue C).  The port never
    fuses; each of its counts must be one that JAX itself gives, and the
    rows where JAX disagrees with itself must stay few."""
    fma = jax_rz["jnp"].row_pieces.ravel()
    np.testing.assert_array_equal(jax_rz["pallas"].row_pieces.ravel(), fma)
    got = port_rz[backend].row_pieces.ravel()
    unstable = np.nonzero(fma != jax_rz_no_fma)[0]
    assert len(unstable) <= 2, unstable
    stable = np.setdiff1d(np.arange(got.size), unstable)
    np.testing.assert_array_equal(got[stable], fma[stable])
    for row in unstable:
        assert got[row] in (fma[row], jax_rz_no_fma[row]), row


def _golden_module():
    spec = importlib.util.spec_from_file_location(
        "golden_prices", ROOT / "tests" / "test_golden_prices.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_golden_grid_axes_are_the_fixtures(grid108):
    golden = _golden_module()._grid()
    assert golden.shape == grid108.shape
    assert golden.n_steps == grid108.n_steps == AXES["n_steps"]
    assert tuple(golden.payoff) == tuple(grid108.payoff)
    for name in ("s0", "sigma", "rate", "maturity", "cost_rate", "strike",
                 "strike2"):
        np.testing.assert_array_equal(getattr(golden, name),
                                      getattr(grid108, name))


@pytest.mark.parametrize("surface", ["jnp", "pallas"])
@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_grid_rz_matches_golden_file(backend, surface, port_rz):
    golden = json.loads((ROOT / "tests" / "golden" / "grid108.json")
                        .read_text())
    assert golden["n_scenarios"] == 108 and golden["capacity"] == 16
    want = golden["engines"][surface]
    res = port_rz[backend]
    np.testing.assert_allclose(res.ask.ravel(), want["ask"], rtol=0, atol=TOL)
    np.testing.assert_allclose(res.bid.ravel(), want["bid"], rtol=0, atol=TOL)
    assert res.max_pieces == want["max_pieces"]
