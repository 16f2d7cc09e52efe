"""Port parity: the pricing launcher ``repro_torch.launch.price``, on the CPU.

Grid mode prints what ``api.price_grid`` returns for the same execution
(the ``[simulated mesh: ...]`` line and the ``se=`` column included);
the non-grid mode prices its contracts through the port's node-axis
engines on a ``--data`` x ``--model`` mesh (here 1 x 2, with halo
rounds) and agrees to 1e-9 with the JAX package's node-sharded builders
on a 1 x 1 mesh, given a ``collapse_lanes`` that makes them run halo
rounds too.  On one shard JAX's halo lanes lie beyond the tree, so its
``stat`` is the exact knot count, which the launcher prints.
"""
import argparse
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core  # noqa: F401  (x64)
from repro.core.distributed import build_notc_sharded, build_rz_sharded
from repro.core.distributed import plan_rounds as j_plan_rounds
from repro.core.payoff import american_put
from repro.launch.mesh import make_test_mesh

from repro_torch import api
from repro_torch.core import distributed as PT
from repro_torch.launch import price as launch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-9
_ROW = re.compile(r"ask=\s*([-\d.]+) bid=\s*([-\d.]+)(?:\s+se=([\d.]+))?")


@pytest.mark.parametrize("argv,execution,grid", [
    (["--engine", "lsmc", "--n-steps", "12", "--paths", "256",
      "--devices", "4", "--exercise-dates", "4,12", "--n-assets", "2",
      "--basis", "laguerre", "--mc-seed", "5"],
     dict(engine="lsmc", devices=4, n_paths=256, mc_seed=5,
          basis="laguerre", degree=3),
     dict(n_steps=12, n_assets=2, exercise_steps=(4, 12))),
    (["--n-steps", "8", "--capacity", "16", "--backend", "jnp",
      "--payoffs", "put,call"],
     dict(backend="torch"), dict(n_steps=8, payoff=("put", "call"))),
], ids=["lsmc-devices4", "lattice-jnp"])
def test_grid_mode_prints_the_api_prices(capsys, argv, execution, grid):
    res = launch.main(["--grid", "--device", "cpu"] + argv)
    out = capsys.readouterr().out
    axes = dict(s0=(90.0, 100.0, 110.0), sigma=0.2, rate=0.1,
                maturity=0.25, cost_rate=(0.0, 0.005, 0.01), payoff="put",
                strike=100.0)
    axes.update(grid)
    want = api.price_grid(capacity=16, execution=api.ExecutionConfig(
        device="cpu", **execution), **axes)
    rows = _ROW.findall(out)
    assert len(rows) == want.grid.n_scenarios
    for i, (ask, bid, se) in enumerate(rows):
        assert ask == f"{want.ask.ravel()[i]:.6f}"
        assert bid == f"{want.bid.ravel()[i]:.6f}"
        if want.stderr is not None:
            assert se == f"{want.stderr.ravel()[i]:.6f}"
    assert np.array_equal(res.ask, want.ask)
    if "--devices" in argv:
        assert "[simulated mesh: 4 shards" in out
        assert res.shard_info.plan == want.shard_info.plan
    assert f"engine={want.engine}" in out


@pytest.mark.parametrize("extra", [[], ["--no-tc"]], ids=["put", "notc"])
def test_contract_mode_matches_jax_node_sharded_builders(capsys, extra):
    n_steps, n, depth = 16, 4, 3
    res = launch.main(["--device", "cpu", "--n-steps", str(n_steps),
                       "--contracts", str(n), "--capacity", "8",
                       "--round-depth", str(depth), "--data", "1",
                       "--model", "2"] + extra)
    out = capsys.readouterr().out
    assert "[mesh: 1 x 2 on cpu]" in out
    assert PT.plan_rounds(n_steps - ("--no-tc" in extra), 2, depth)[
        "rounds"] > 0
    mesh = make_test_mesh(1, 1)
    collapse = 5
    assert j_plan_rounds(n_steps - ("--no-tc" in extra), 1, depth,
                         collapse)["rounds"] > 0
    s0 = jnp.linspace(90.0, 110.0, n).astype(jnp.float64)
    col = lambda x: jnp.full((n,), x)
    if "--no-tc" in extra:
        f = jax.jit(build_notc_sharded(mesh, n_steps=n_steps, strike=100.0,
                                       round_depth=depth,
                                       collapse_lanes=collapse))
        want = np.asarray(f(s0, col(0.2), col(0.1), col(0.25)))
        np.testing.assert_allclose(res.ask, want, rtol=0, atol=TOL)
        assert "price=" in out
        return
    f = jax.jit(build_rz_sharded(mesh, n_steps=n_steps,
                                 payoff=american_put(100.0), capacity=8,
                                 round_depth=depth, collapse_lanes=collapse))
    ask, bid, pieces = f(s0, col(0.2), col(0.1), col(0.25), col(0.005))
    np.testing.assert_allclose(res.ask, np.asarray(ask), rtol=0, atol=TOL)
    np.testing.assert_allclose(res.bid, np.asarray(bid), rtol=0, atol=TOL)
    assert f"max PWL knots: {int(pieces)} (capacity 8)" in out


def test_execution_flags_map_as_the_api_does():
    def parse(platform, interpret, backend, device):
        return launch._execution(argparse.Namespace(
            platform=platform, interpret=interpret, backend=backend,
            device=device, n_steps=8))

    assert parse(None, None, None, "cpu") == api.ExecutionConfig(
        device="cpu").resolved()
    assert parse("cpu", None, "pallas", "cuda").device == "cpu"
    assert parse(None, True, None, "cuda") == api.ExecutionConfig(
        device="cpu", backend="kernel").resolved()
    assert parse(None, True, "jnp", "cuda").backend == "torch"
    assert parse("gpu", None, None, "cpu").device == "cuda"
    with pytest.raises(ValueError, match="platform"):
        parse("tpu", None, None, "cuda")
    with pytest.raises(ValueError, match="interpret"):
        parse("gpu", True, None, "cuda")

