"""Pricing launcher: the paper's workload from the command line.

    PYTHONPATH=src python -m repro_torch.launch.price --n-steps 500 \\
        --contracts 8 [--data D --model M] [--no-tc] [--device cpu]

The port of the JAX package's ``launch/price.py``, with the same flags
and output lines, plus ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions).  This mode prices through the node-axis
engines (``core/distributed.py::build_rz_sharded`` /
``build_notc_sharded``, the paper's §4 halo rounds of ``--round-depth``
levels) on a ``D x M`` mesh: contracts over ``--data D``, each tree's
nodes over ``--model M``.  Where the process sees fewer than ``D * M``
devices of ``--device``'s kind, the mesh repeats its first one; the
``[mesh: ...]`` line says which ran.

Scenario-grid mode (one call over the cartesian product of the axes)::

    PYTHONPATH=src python -m repro_torch.launch.price --grid \\
        --n-steps 100 --s0 90,100,110 --sigmas 0.15,0.25 \\
        --lambdas 0,0.005,0.01 --payoffs put,call,bull_spread [--greeks] \\
        [--backend kernel|torch [--levels L] [--block B]] [--devices W]

``--backend`` also takes the JAX package's ``jnp`` (-> ``torch``) and
``pallas`` (-> ``kernel``).  ``--devices W`` shards the scenario batch
over W devices under the cost-model plan; more devices than the process
sees runs the identical layout on one (the simulated mesh).

Monte Carlo engine (grid mode): ``--engine lsmc``, or ``--n-assets`` > 1
or ``--exercise-dates`` under ``--engine auto``::

    PYTHONPATH=src python -m repro_torch.launch.price --grid --engine lsmc \\
        --n-steps 50 --s0 90,100,110 --paths 8192 \\
        --exercise-dates 10,25,50 --n-assets 3 [--mc-seed 0] \\
        [--basis laguerre --degree 4]

``--exercise-dates`` is a comma list of lattice steps (it must include
``--n-steps``); lsmc output adds each scenario's standard error.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np

from ..api import price_grid
from ..configs.pricing import (LEGACY_BACKENDS, ExecutionConfig,
                               PricingConfig)
from ..core.distributed import (DeviceMesh, build_notc_sharded,
                                build_rz_sharded)
from ..core.payoff import american_put, bull_spread
from .mesh import make_test_mesh


def _floats(csv: str):
    return tuple(float(x) for x in csv.split(","))


def _steps(csv):
    return (None if csv is None
            else tuple(int(x) for x in csv.split(",")))


def _execution(args, **fields) -> ExecutionConfig:
    """The run's resolved config: ``--platform``/``--interpret`` mapped by
    :meth:`PricingConfig.execution`, then ``--device`` (where those leave
    the device open), ``--backend`` and ``fields``."""
    ex = PricingConfig(name="launch", n_steps=args.n_steps,
                       platform=args.platform,
                       interpret=args.interpret).execution()
    open_device = args.platform is None and args.interpret is None
    backend = LEGACY_BACKENDS.get(args.backend, args.backend) or ex.backend
    return dataclasses.replace(
        ex, device=args.device if open_device else ex.device,
        backend=backend, **fields).resolved()


def run_grid(args):
    grid_kwargs = dict(
        s0=_floats(args.s0), sigma=_floats(args.sigmas),
        rate=_floats(args.rates), maturity=_floats(args.maturities),
        cost_rate=_floats(args.lambdas),
        payoff=tuple(args.payoffs.split(",")),
        strike=_floats(args.strikes), n_assets=args.n_assets,
        exercise_steps=_steps(args.exercise_dates))
    t0 = time.perf_counter()
    res = price_grid(n_steps=args.n_steps,
                     execution=_execution(
                         args, engine=args.engine, devices=args.devices,
                         n_paths=args.paths, mc_seed=args.mc_seed,
                         basis=args.basis, degree=args.degree),
                     capacity=args.capacity, greeks=args.greeks,
                     levels=args.levels, block=args.block, **grid_kwargs)
    n = res.grid.n_scenarios
    dt = time.perf_counter() - t0
    if res.shard_info is not None:
        si = res.shard_info
        kind = "simulated" if si.simulated else "device"
        print(f"[{kind} mesh: {si.plan.n_shards} shards, "
              f"{si.plan.lanes} lanes/shard, rows {si.plan.sizes}, "
              f"predicted work spread {si.plan.work_spread:.1%}]")
    ask, bid = res.ask.ravel(), res.bid.ravel()
    se = None if res.stderr is None else res.stderr.ravel()
    g = res.grid
    for i in range(n):
        line = (f"{g.payoff[i]:>11s} K={g.strike[i]:6.1f} "
                f"S0={g.s0[i]:6.1f} sig={g.sigma[i]:.2f} "
                f"lam={g.cost_rate[i]:.3f}  ask={ask[i]:9.6f} "
                f"bid={bid[i]:9.6f}")
        if se is not None:
            line += f"  se={se[i]:.6f}"
        if args.greeks:
            line += (f"  delta={res.delta_ask.ravel()[i]:+.4f} "
                     f"vega={res.vega_ask.ravel()[i]:8.4f}")
        print(line)
    extra = (f", engine={res.engine}" if res.engine else "")
    print(f"\n{n} scenarios, N={args.n_steps}{extra}: {dt:.2f}s "
          f"({n / dt:.1f} contracts/s; the first call on a card includes "
          "building the kernels)")
    return res


@dataclasses.dataclass
class ContractRun:
    """What the non-grid mode priced: ``ask`` and ``bid`` (equal, the
    price, without costs), the largest knot count (``None`` without
    costs) and the mesh it ran on."""
    ask: np.ndarray
    bid: np.ndarray
    max_pieces: Optional[int]
    mesh: DeviceMesh


def _mesh_line(mesh: DeviceMesh) -> str:
    devs = mesh.devices.ravel()
    names = (str(devs[0]) if all(d == devs[0] for d in devs)
             else ", ".join(str(d) for d in devs))
    return f"[mesh: {mesh.shape['data']} x {mesh.shape['model']} on {names}]"


def run_contracts(args):
    """Non-grid mode: ``--contracts`` puts (or bull spreads) at spots
    90..110 through the node-axis engines on a ``--data`` x ``--model``
    mesh, as the JAX package's launcher does."""
    ex = _execution(args)
    mesh = make_test_mesh(args.data, args.model, kind=ex.device, repeat=True)
    print(_mesh_line(mesh))
    n = args.contracts
    s0 = np.linspace(90.0, 110.0, n)
    sig, rate, mat = (np.full(n, x) for x in (0.2, 0.1, 0.25))
    t0 = time.perf_counter()
    if args.no_tc:
        f = build_notc_sharded(mesh, n_steps=args.n_steps, strike=100.0,
                               round_depth=args.round_depth,
                               backend=ex.backend)
        ask = bid = f(s0, sig, rate, mat).numpy()
        pieces = None
        dt = time.perf_counter() - t0
        for i in range(n):
            print(f"S0={s0[i]:6.1f}  price={ask[i]:.6f}")
    else:
        pay = american_put(100.0) if args.payoff == "put" else bull_spread()
        f = build_rz_sharded(mesh, n_steps=args.n_steps, payoff=pay,
                             capacity=args.capacity,
                             round_depth=args.round_depth,
                             backend=ex.backend)
        ask, bid, pieces = f(s0, sig, rate, mat, np.full(n, args.cost_rate))
        ask, bid = ask.numpy(), bid.numpy()
        dt = time.perf_counter() - t0
        for i in range(n):
            print(f"S0={s0[i]:6.1f}  ask={ask[i]:.6f}  bid={bid[i]:.6f}")
        print(f"max PWL knots: {pieces} (capacity {args.capacity})")
    print(f"{n} contracts, N={args.n_steps}: {dt:.2f}s (the first call on "
          "a card includes building the kernels)")
    return ContractRun(ask=ask, bid=bid, max_pieces=pieces, mesh=mesh)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-steps", type=int, default=500)
    ap.add_argument("--contracts", type=int, default=8)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--round-depth", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=48)
    ap.add_argument("--cost-rate", type=float, default=0.005)
    ap.add_argument("--payoff", default="put", choices=["put", "bull_spread"])
    ap.add_argument("--no-tc", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to price (cpu: the kernels' plain versions)")
    # scenario-grid mode
    ap.add_argument("--grid", action="store_true",
                    help="price the cartesian scenario grid in one call")
    ap.add_argument("--s0", default="90,100,110")
    ap.add_argument("--sigmas", default="0.2")
    ap.add_argument("--rates", default="0.1")
    ap.add_argument("--maturities", default="0.25")
    ap.add_argument("--lambdas", default="0,0.005,0.01")
    ap.add_argument("--payoffs", default="put")
    ap.add_argument("--strikes", default="100")
    ap.add_argument("--greeks", action="store_true")
    ap.add_argument("--backend", default=None,
                    choices=["kernel", "torch", "jnp", "pallas"],
                    help="grid-engine implementation: the CUDA kernels "
                         "(default) or the plain PyTorch walk; jnp/pallas "
                         "are the JAX package's names for torch/kernel")
    ap.add_argument("--platform", default=None,
                    choices=["cpu", "gpu", "tpu"],
                    help="the JAX package's platform: gpu -> --device cuda, "
                         "cpu -> --device cpu (tpu is refused)")
    ap.add_argument("--interpret", default="auto",
                    choices=["auto", "on", "off"],
                    help="on: the kernels' plain versions on the CPU; off: "
                         "the compiled kernels on the card")
    ap.add_argument("--levels", type=int, default=None,
                    help="round depth L (default: partition.py pick)")
    ap.add_argument("--block", type=int, default=None,
                    help="node-block size (default: one re-balanced block "
                         "per round)")
    ap.add_argument("--devices", type=int, default=None,
                    help="shard the scenario batch over a 1-D mesh of this "
                         "many devices (grid mode; cost-model shard plan)")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "notc", "rz", "lsmc"],
                    help="grid engine (auto routes by contract shape then "
                         "cost rate; lsmc = least-squares Monte Carlo)")
    ap.add_argument("--paths", type=int, default=4096,
                    help="Monte Carlo paths per scenario (lsmc engine)")
    ap.add_argument("--exercise-dates", default=None,
                    help="comma list of Bermudan exercise step indices "
                         "(must include --n-steps; routes to lsmc)")
    ap.add_argument("--n-assets", type=int, default=1,
                    help="basket size per scenario (>1 routes to lsmc)")
    ap.add_argument("--mc-seed", type=int, default=0,
                    help="seed of the lsmc engine (deterministic)")
    ap.add_argument("--basis", default="poly", choices=["poly", "laguerre"],
                    help="lsmc regression basis")
    ap.add_argument("--degree", type=int, default=3,
                    help="lsmc regression basis degree")
    args = ap.parse_args(argv)
    args.interpret = {"auto": None, "on": True, "off": False}[args.interpret]
    if args.grid:
        return run_grid(args)
    return run_contracts(args)


if __name__ == "__main__":
    main()
