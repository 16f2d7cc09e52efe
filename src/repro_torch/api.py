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
import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .configs.pricing import ExecutionConfig, execution_device
from .core.device import DEFAULT_DTYPE, resolve_device
from .core.lattice import LatticeModel
from .core.notc import notc_payoff_rows
from .core.payoff import (PAYOFF_FAMILIES, PayoffProcess, american_call,
                          american_put, bull_spread, cash_settled,
                          kernel_params, param_payoff)
from .core.rz import price_rz
from .scenarios import (GridResult, ScenarioGrid, _notc_rows_kernel,
                        price_grid_lsmc, price_grid_notc, price_grid_rz,
                        route_engine)

__all__ = ["price_american", "price_grid", "price_flat", "PriceQuote",
           "GridResult", "ExecutionConfig", "ScenarioGrid", "LatticeModel",
           "PayoffProcess", "PAYOFF_FAMILIES", "american_put",
           "american_call", "bull_spread", "cash_settled", "param_payoff",
           "route_engine"]

# the JAX package's individual execution kwargs warn once per process
_legacy_exec_warned = False


def _reset_legacy_exec_warning() -> None:
    """Re-arm the once-per-process deprecation warning (test hook)."""
    global _legacy_exec_warned
    _legacy_exec_warned = False


def _merge_execution(fn: str, execution: Optional[ExecutionConfig], *,
                     engine=None, backend=None, platform=None,
                     interpret=None, devices=None, n_paths=None, seed=None,
                     basis=None, degree=None,
                     antithetic=None) -> ExecutionConfig:
    """Collapse ``execution=`` and the JAX package's individual execution
    kwargs into one resolved :class:`ExecutionConfig`.

    Passing both is a ``TypeError``; the individual kwargs alone warn
    once per process (``DeprecationWarning``) and map onto the port:

    * ``backend``: ``"jnp"`` -> ``"torch"``, ``"pallas"`` -> ``"kernel"``
      (the port's own names pass through);
    * ``platform``: ``"gpu"`` -> ``device="cuda"``, ``"cpu"`` ->
      ``"cpu"``; ``"tpu"`` raises ``ValueError``;
    * ``interpret=True`` (the kernels' semantics off the card) ->
      ``device="cpu"`` and, unless ``backend`` says otherwise,
      ``backend="kernel"``: the kernels' plain versions.  It raises
      ``ValueError`` with ``platform="gpu"``, as ``interpret=False`` (the
      compiled kernels) does with ``platform="cpu"``
      (``configs/pricing.py::execution_device``);
    * ``engine``, ``devices`` and the LSMC knobs ``n_paths``/``basis``/
      ``degree``/``antithetic`` keep their meaning; ``seed`` is
      ``mc_seed``.
    """
    legacy = {name: v for name, v in (
        ("engine", engine), ("backend", backend), ("platform", platform),
        ("interpret", interpret), ("devices", devices),
        ("n_paths", n_paths), ("seed", seed), ("basis", basis),
        ("degree", degree), ("antithetic", antithetic)) if v is not None}
    if execution is not None:
        if legacy:
            raise TypeError(
                f"{fn}() got both execution= and the individual kwargs "
                f"{sorted(legacy)}; set them on the ExecutionConfig instead")
        return execution.resolved()
    if legacy:
        global _legacy_exec_warned
        if not _legacy_exec_warned:
            _legacy_exec_warned = True
            warnings.warn(
                f"{fn}({', '.join(sorted(legacy))}=...): passing execution "
                "knobs as individual kwargs is deprecated; pass "
                "execution=ExecutionConfig(...) "
                "(repro_torch.api.ExecutionConfig)",
                DeprecationWarning, stacklevel=3)
    device, backend = execution_device(platform, interpret, backend)
    return ExecutionConfig(
        engine=engine, backend=backend, device=device, devices=devices,
        n_paths=n_paths, mc_seed=seed, basis=basis, degree=degree,
        antithetic=antithetic).resolved()


@dataclasses.dataclass(frozen=True)
class PriceQuote:
    """Two-sided quote for one contract (ask == bid without costs).
    ``stderr`` is the Monte Carlo standard error when the quote came
    from the ``lsmc`` engine (0.0 from the deterministic lattices)."""
    ask: float
    bid: float
    max_pieces: int = 0
    stderr: float = 0.0

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
    ``cost_rate == 0``, else the Roux–Zastawniak ask/bid interval.

    A closure-only payoff (:func:`cash_settled` with ``params=None``)
    prices on ``backend="torch"``; ``"kernel"`` raises ``ValueError``.
    """
    cfg = (execution or ExecutionConfig()).resolved()
    model = LatticeModel(s0=s0, sigma=sigma, rate=rate, maturity=maturity,
                         n_steps=n_steps, cost_rate=cost_rate)
    pay = _mk_payoff(payoff, strike, strike2)
    if cost_rate > 0.0:
        res = price_rz(model, pay, capacity=capacity, backend=cfg.backend,
                       device=cfg.device)
        return PriceQuote(ask=res.ask, bid=res.bid, max_pieces=res.max_pieces)
    dev = resolve_device(cfg.device)
    col = lambda x: torch.tensor([float(x)], dtype=DEFAULT_DTYPE, device=dev)
    market = [col(x) for x in (s0, sigma, rate, maturity)]
    if cfg.backend == "kernel":
        v = _notc_rows_kernel(*market, *map(col, kernel_params(pay)),
                              n_steps=n_steps, levels=64, block=256)
    else:
        v = notc_payoff_rows(*market, pay, n_steps=n_steps)
    p = float(v[0])
    return PriceQuote(ask=p, bid=p, max_pieces=0)


def price_grid(grid: Optional[ScenarioGrid] = None, *,
               execution: Optional[ExecutionConfig] = None,
               engine: Optional[str] = None, capacity: int = 48,
               greeks: bool = False, backend: Optional[str] = None,
               n_steps: Union[int, Sequence[int], None] = None,
               levels: Optional[int] = None, block: Optional[int] = None,
               interpret: Optional[bool] = None,
               platform: Optional[str] = None,
               n_paths: Optional[int] = None, seed: Optional[int] = None,
               basis: Optional[str] = None, degree: Optional[int] = None,
               antithetic: Optional[bool] = None,
               mesh=None, devices: Optional[int] = None, shard_plan=None,
               **axes) -> Union[GridResult, list]:
    """Price a whole grid of scenarios in one batch.

    Pass a :class:`ScenarioGrid` or cartesian axes as keywords (forwarded
    to :meth:`ScenarioGrid.cartesian`); a sequence of ``n_steps`` prices
    one grid per depth.  ``engine="auto"`` routes through
    :func:`route_engine`: a basket (``n_assets > 1``) or a Bermudan
    ``exercise_steps`` grid goes to ``lsmc``; otherwise ``rz`` when any
    scenario has ``cost_rate > 0``, else ``notc``.  ``levels``/``block``
    tune the kernels' round plan; ``n_paths``/``mc_seed``/``basis``/
    ``degree``/``antithetic`` of the config tune ``lsmc``.

    ``mesh`` (a tuple of ``torch.device``) or the config's ``devices``
    shard the flat batch over a 1-D mesh under a cost-model plan
    (``core/partition.py::plan_shards``; ``shard_plan`` overrides it);
    ``devices`` above the card count runs the simulated layout.  Results
    are those of the single-device call.

    The JAX package's individual execution kwargs (``engine``,
    ``backend``, ``platform``, ``interpret``, ``devices`` and the LSMC
    knobs) are accepted beside ``execution=`` as in the JAX package: a
    once-per-process ``DeprecationWarning``, a ``TypeError`` when both
    are given, and the names mapped as :func:`_merge_execution` says.
    """
    cfg = _merge_execution("price_grid", execution, engine=engine,
                           backend=backend, platform=platform,
                           interpret=interpret, devices=devices,
                           n_paths=n_paths, seed=seed, basis=basis,
                           degree=degree, antithetic=antithetic)
    if grid is None:
        if isinstance(n_steps, (list, tuple)):
            if shard_plan is not None:
                raise TypeError(
                    "shard_plan cannot combine with a sequence of n_steps: "
                    "one plan covers one flat batch (pass mesh=/devices= "
                    "and let each depth plan itself)")
            return [price_grid(execution=cfg, capacity=capacity,
                               greeks=greeks, n_steps=int(n), levels=levels,
                               block=block, mesh=mesh, **axes)
                    for n in n_steps]
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
        return price_grid_lsmc(grid, n_paths=cfg.n_paths, seed=cfg.mc_seed,
                               basis=cfg.basis, degree=cfg.degree,
                               antithetic=cfg.antithetic, greeks=greeks,
                               device=cfg.device, **shard)
    raise ValueError(f"unknown engine {eng!r}; use 'auto', 'rz', 'notc' "
                     "or 'lsmc'")


def price_flat(*, s0, sigma, rate, maturity, cost_rate=0.0, payoff="put",
               strike=100.0, strike2=None, n_steps: int = 100,
               n_assets: int = 1, exercise_steps=None,
               execution: Optional[ExecutionConfig] = None,
               engine: Optional[str] = None, capacity: int = 48,
               greeks: bool = False, backend: Optional[str] = None,
               levels: Optional[int] = None, block: Optional[int] = None,
               interpret: Optional[bool] = None,
               platform: Optional[str] = None,
               n_paths: Optional[int] = None, seed: Optional[int] = None,
               basis: Optional[str] = None, degree: Optional[int] = None,
               antithetic: Optional[bool] = None,
               pad_to: Optional[int] = None, mesh=None,
               devices: Optional[int] = None, shard_plan=None) -> GridResult:
    """Price a flat batch of heterogeneous contracts (row ``i`` is request
    ``i``); ``pad_to`` pads by repeating the last row, and a
    ``shard_plan`` must cover the padded batch.  The execution kwargs
    and ``mesh``/``devices``/``shard_plan`` behave as in
    :func:`price_grid`."""
    cfg = _merge_execution("price_flat", execution, engine=engine,
                           backend=backend, platform=platform,
                           interpret=interpret, devices=devices,
                           n_paths=n_paths, seed=seed, basis=basis,
                           degree=degree, antithetic=antithetic)
    grid = ScenarioGrid.explicit(
        s0=s0, sigma=sigma, rate=rate, maturity=maturity,
        cost_rate=cost_rate, payoff=payoff, strike=strike, strike2=strike2,
        n_steps=n_steps, n_assets=n_assets, exercise_steps=exercise_steps)
    if pad_to is not None:
        grid = grid.pad_to(pad_to)
    return price_grid(grid, execution=cfg, capacity=capacity,
                      greeks=greeks, levels=levels, block=block, mesh=mesh,
                      shard_plan=shard_plan)
