"""Public pricing API of the port.

* :func:`price_american` — one contract -> :class:`PriceQuote`;
* :func:`price_grid` — a grid of scenarios -> ``GridResult``;
* :func:`price_flat` — a flat batch of heterogeneous contracts.

Every entry point runs on ``device="cuda"`` unless the caller asks for
``"cpu"``, and raises where the device is unavailable.  **The default
backend is ``"kernel"``** — the hand-written CUDA kernels on the card
(their plain versions on the CPU) — where the JAX package defaults to
its plain ``"jnp"`` walk: on the card the normal entry points go through
the kernels.  ``backend="torch"`` selects the plain PyTorch level walk.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .configs.pricing import ExecutionConfig
from .core.device import DEFAULT_DTYPE, resolve_device
from .core.lattice import LatticeModel
from .core.notc import notc_rows
from .core.payoff import (PAYOFF_FAMILIES, PayoffProcess, american_call,
                          american_put, bull_spread, param_payoff)
from .core.rz import price_rz
from .scenarios import (_NOT_PORTED, GridResult, ScenarioGrid,
                        _notc_rows_kernel, price_grid_notc, price_grid_rz,
                        route_engine)

__all__ = ["price_american", "price_grid", "price_flat", "PriceQuote",
           "GridResult", "ExecutionConfig", "ScenarioGrid", "LatticeModel",
           "PayoffProcess", "PAYOFF_FAMILIES", "american_put",
           "american_call", "bull_spread", "param_payoff", "route_engine"]


@dataclasses.dataclass(frozen=True)
class PriceQuote:
    """Two-sided quote for one contract (ask == bid without costs)."""
    ask: float
    bid: float
    max_pieces: int = 0

    @property
    def mid(self) -> float:
        return 0.5 * (self.ask + self.bid)

    @property
    def spread(self) -> float:
        return self.ask - self.bid


def _mk_payoff(payoff: Union[str, PayoffProcess], strike: float,
               strike2: Optional[float]) -> PayoffProcess:
    if isinstance(payoff, PayoffProcess):
        return payoff
    if payoff == "put":
        return american_put(strike)
    if payoff == "call":
        return american_call(strike)
    if payoff == "bull_spread":
        return bull_spread(strike, strike + 10.0 if strike2 is None
                           else strike2)
    raise ValueError(f"unknown payoff {payoff!r}; "
                     f"supported: {PAYOFF_FAMILIES} or a PayoffProcess")


def price_american(*, s0: float, sigma: float, rate: float, maturity: float,
                   n_steps: int, payoff: Union[str, PayoffProcess] = "put",
                   strike: float = 100.0, strike2: Optional[float] = None,
                   cost_rate: float = 0.0, capacity: int = 48,
                   execution: Optional[ExecutionConfig] = None) -> PriceQuote:
    """Price one American option: the friction-free lattice at
    ``cost_rate == 0``, else the Roux–Zastawniak ask/bid interval."""
    cfg = (execution or ExecutionConfig()).resolved()
    model = LatticeModel(s0=s0, sigma=sigma, rate=rate, maturity=maturity,
                         n_steps=n_steps, cost_rate=cost_rate)
    pay = _mk_payoff(payoff, strike, strike2)
    if cost_rate > 0.0:
        res = price_rz(model, pay, capacity=capacity, backend=cfg.backend,
                       device=cfg.device)
        return PriceQuote(ask=res.ask, bid=res.bid, max_pieces=res.max_pieces)
    dev = resolve_device(cfg.device)
    cols = [torch.tensor([float(x)], dtype=DEFAULT_DTYPE, device=dev)
            for x in (s0, sigma, rate, maturity, *pay.params)]
    if cfg.backend == "kernel":
        v = _notc_rows_kernel(*cols, n_steps=n_steps, levels=64, block=256)
    else:
        v = notc_rows(*cols, n_steps=n_steps)
    p = float(v[0])
    return PriceQuote(ask=p, bid=p, max_pieces=0)


def price_grid(grid: Optional[ScenarioGrid] = None, *,
               execution: Optional[ExecutionConfig] = None,
               capacity: int = 48, greeks: bool = False,
               n_steps: Union[int, Sequence[int], None] = None,
               levels: Optional[int] = None, block: Optional[int] = None,
               mesh=None, shard_plan=None,
               **axes) -> Union[GridResult, list]:
    """Price a whole grid of scenarios in one batch.

    Pass a :class:`ScenarioGrid` or cartesian axes as keywords (forwarded
    to :meth:`ScenarioGrid.cartesian`); a sequence of ``n_steps`` prices
    one grid per depth.  ``engine="auto"`` routes through
    :func:`route_engine`: ``rz`` when any scenario has ``cost_rate > 0``,
    else ``notc``.  ``levels``/``block`` tune the kernels' round plan.
    """
    cfg = (execution or ExecutionConfig()).resolved()
    if grid is None:
        if isinstance(n_steps, (list, tuple)):
            return [price_grid(execution=cfg, capacity=capacity,
                               greeks=greeks, n_steps=int(n), levels=levels,
                               block=block, mesh=mesh, shard_plan=shard_plan,
                               **axes) for n in n_steps]
        grid = ScenarioGrid.cartesian(n_steps=int(n_steps or 100), **axes)
    elif axes or n_steps is not None:
        raise TypeError("pass either a ScenarioGrid or cartesian axes, "
                        "not both")
    eng = cfg.engine
    if eng == "auto":
        eng = route_engine(any_tc=bool(np.any(grid.cost_rate > 0.0)),
                           n_assets=grid.n_assets,
                           exercise_steps=grid.exercise_steps)
    shard = dict(mesh=mesh, devices=cfg.devices, shard_plan=shard_plan)
    if eng == "rz":
        return price_grid_rz(grid, capacity=capacity, greeks=greeks,
                             backend=cfg.backend, levels=levels, block=block,
                             device=cfg.device, **shard)
    if eng == "notc":
        return price_grid_notc(grid, backend=cfg.backend, greeks=greeks,
                               levels=64 if levels is None else levels,
                               block=256 if block is None else block,
                               device=cfg.device, **shard)
    if eng == "lsmc":
        raise NotImplementedError(_NOT_PORTED["lsmc"])
    raise ValueError(f"unknown engine {eng!r}; use 'auto', 'rz' or 'notc'")


def price_flat(*, s0, sigma, rate, maturity, cost_rate=0.0, payoff="put",
               strike=100.0, strike2=None, n_steps: int = 100,
               n_assets: int = 1, exercise_steps=None,
               execution: Optional[ExecutionConfig] = None,
               capacity: int = 48, greeks: bool = False,
               levels: Optional[int] = None, block: Optional[int] = None,
               pad_to: Optional[int] = None, mesh=None,
               shard_plan=None) -> GridResult:
    """Price a flat batch of heterogeneous contracts (row ``i`` is request
    ``i``); ``pad_to`` pads by repeating the last row."""
    grid = ScenarioGrid.explicit(
        s0=s0, sigma=sigma, rate=rate, maturity=maturity,
        cost_rate=cost_rate, payoff=payoff, strike=strike, strike2=strike2,
        n_steps=n_steps, n_assets=n_assets, exercise_steps=exercise_steps)
    if pad_to is not None:
        grid = grid.pad_to(pad_to)
    return price_grid(grid, execution=execution, capacity=capacity,
                      greeks=greeks, levels=levels, block=block, mesh=mesh,
                      shard_plan=shard_plan)
