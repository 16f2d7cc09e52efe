"""Scenario-grid pricing: whole grids of contracts through the engines.

The port of the JAX package's ``scenarios.py``.  A grid is a flat
structure-of-arrays batch of contracts sharing one tree depth; mixed
payoff families batch together because the payoff is data (the
4-parameter family of ``core/payoff.py``).  Each engine prices the rows
as one batch (the row dimension JAX vmapped over):

* :func:`price_grid_rz` — Roux–Zastawniak ask/bid under transaction
  costs (exact at cost rate 0 too);
* :func:`price_grid_notc` — the friction-free binomial price.

``backend="kernel"`` runs the round loops around the CUDA kernels (their
plain versions on the CPU); ``backend="torch"`` runs the plain level
walks.  Central-difference Greeks (delta, vega) ride in the same batch.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import numpy as np
import torch

from .core.device import DEFAULT_DTYPE, resolve_device
from .core.notc import notc_rows
from .core.payoff import PAYOFF_FAMILIES, payoff_params
from .core.rz import RZ_BACKENDS, rz_backward, rz_backward_kernel

__all__ = ["ScenarioGrid", "GridResult", "price_grid_rz", "price_grid_notc",
           "route_engine", "PAYOFF_FAMILIES", "payoff_params"]

_DELTA_REL_BUMP = 1e-4
_VEGA_BUMP = 1e-4

_NOT_PORTED = {
    "lsmc": "engine='lsmc' is not ported yet (ROADMAP Queue A #6, LSMC)",
    "shard": "mesh/devices/shard_plan are not ported yet "
             "(ROADMAP Queue A #7, scenario sharding)",
}


@dataclasses.dataclass(frozen=True)
class ScenarioGrid:
    """A flat SoA batch of pricing scenarios sharing one tree depth.

    Per-scenario fields are float64 numpy arrays of length
    ``n_scenarios``; ``shape`` is the logical grid shape results take.
    ``n_assets``/``exercise_steps`` other than 1/None belong to the LSMC
    engine, which is not ported: the lattice engines reject them.
    """
    s0: np.ndarray
    sigma: np.ndarray
    rate: np.ndarray
    maturity: np.ndarray
    cost_rate: np.ndarray
    strike: np.ndarray
    strike2: np.ndarray
    payoff: tuple
    n_steps: int
    shape: tuple
    axes: tuple = ()
    n_assets: int = 1
    exercise_steps: Optional[tuple] = None

    def __post_init__(self):
        if int(self.n_assets) < 1:
            raise ValueError(f"need n_assets >= 1, got {self.n_assets}")

    @property
    def n_scenarios(self) -> int:
        return self.s0.shape[0]

    def payoff_param_arrays(self):
        """(alpha, zeta, w1, w2) as float64 arrays over scenarios."""
        by_kind = {k: payoff_params(k) for k in set(self.payoff)}
        p = np.asarray([by_kind[k] for k in self.payoff], dtype=np.float64)
        return p[:, 0], p[:, 1], p[:, 2], p[:, 3]

    @classmethod
    def cartesian(cls, *, s0=100.0, sigma=0.2, rate=0.1, maturity=0.25,
                  cost_rate=0.0, payoff="put", strike=100.0, strike2=None,
                  n_steps: int = 100, n_assets: int = 1,
                  exercise_steps=None) -> "ScenarioGrid":
        """Cartesian product of the axes (scalars are length-1 axes);
        ``strike2`` defaults to ``strike + 10``."""
        def ax(v, name):
            if isinstance(v, str):
                v = (v,)
            return (name, tuple(np.atleast_1d(v).tolist()))

        axes = (ax(s0, "s0"), ax(sigma, "sigma"), ax(rate, "rate"),
                ax(maturity, "maturity"), ax(cost_rate, "cost_rate"),
                ax(payoff, "payoff"), ax(strike, "strike"))
        shape = tuple(len(vals) for _, vals in axes)
        rows = list(itertools.product(*(vals for _, vals in axes)))
        cols = {name: [r[i] for r in rows] for i, (name, _) in enumerate(axes)}
        k1 = np.asarray(cols["strike"], np.float64)
        k2 = (k1 + 10.0 if strike2 is None else
              np.broadcast_to(np.asarray(strike2, np.float64), k1.shape).copy())
        f64 = lambda n: np.asarray(cols[n], np.float64)
        return cls(s0=f64("s0"), sigma=f64("sigma"), rate=f64("rate"),
                   maturity=f64("maturity"), cost_rate=f64("cost_rate"),
                   strike=k1, strike2=k2, payoff=tuple(cols["payoff"]),
                   n_steps=int(n_steps), shape=shape, axes=axes,
                   n_assets=int(n_assets), exercise_steps=exercise_steps)

    @classmethod
    def explicit(cls, *, s0, sigma, rate, maturity, cost_rate=0.0,
                 payoff="put", strike=100.0, strike2=None, n_steps: int = 100,
                 n_assets: int = 1, exercise_steps=None) -> "ScenarioGrid":
        """Element-wise scenario list; array arguments broadcast together."""
        arrs = [np.atleast_1d(np.asarray(v, np.float64))
                for v in (s0, sigma, rate, maturity, cost_rate, strike)]
        n = max(a.shape[0] for a in arrs)
        s0a, siga, ra, ma, ka, k1 = (np.broadcast_to(a, (n,)) for a in arrs)
        if isinstance(payoff, str):
            payoff = (payoff,) * n
        if len(payoff) != n:
            raise ValueError(f"payoff has {len(payoff)} entries, expected {n}")
        k2 = (k1 + 10.0 if strike2 is None else
              np.broadcast_to(np.asarray(strike2, np.float64), (n,)))
        return cls(s0=s0a.copy(), sigma=siga.copy(), rate=ra.copy(),
                   maturity=ma.copy(), cost_rate=ka.copy(), strike=k1.copy(),
                   strike2=np.asarray(k2, np.float64).copy(),
                   payoff=tuple(payoff), n_steps=int(n_steps), shape=(n,),
                   n_assets=int(n_assets), exercise_steps=exercise_steps)

    def flat(self) -> "ScenarioGrid":
        """The same scenarios as a flat grid (``shape == (n,)``)."""
        return dataclasses.replace(self, shape=(self.n_scenarios,), axes=())

    def pad_to(self, to: int) -> "ScenarioGrid":
        """Flat copy padded to ``to`` scenarios by repeating the last row."""
        n = self.n_scenarios
        if to < n:
            raise ValueError(f"pad_to({to}) below batch size {n}")
        if to == n and self.shape == (n,):
            return self
        pad = to - n
        rep = lambda a: np.concatenate([a, np.repeat(a[-1:], pad)])
        return ScenarioGrid(
            s0=rep(self.s0), sigma=rep(self.sigma), rate=rep(self.rate),
            maturity=rep(self.maturity), cost_rate=rep(self.cost_rate),
            strike=rep(self.strike), strike2=rep(self.strike2),
            payoff=self.payoff + (self.payoff[-1],) * pad,
            n_steps=self.n_steps, shape=(to,), n_assets=self.n_assets,
            exercise_steps=self.exercise_steps)


@dataclasses.dataclass
class GridResult:
    """Ask/bid surfaces (and optional Greeks) over a scenario grid.

    Arrays have ``grid.shape``; ``max_pieces`` is the batch-wide peak PWL
    knot count and ``row_pieces`` the per-scenario peak (zeros on the
    friction-free path).
    """
    grid: ScenarioGrid
    ask: np.ndarray
    bid: np.ndarray
    max_pieces: int = 0
    delta_ask: Optional[np.ndarray] = None
    delta_bid: Optional[np.ndarray] = None
    vega_ask: Optional[np.ndarray] = None
    vega_bid: Optional[np.ndarray] = None
    row_pieces: Optional[np.ndarray] = None
    engine: Optional[str] = None

    @property
    def price(self) -> np.ndarray:
        return self.ask

    @property
    def spread(self) -> np.ndarray:
        return self.ask - self.bid


def route_engine(*, any_tc: bool, n_assets: int = 1,
                 exercise_steps=None) -> str:
    """The ``engine="auto"`` rule: baskets and Bermudan schedules go to
    ``lsmc``; otherwise ``rz`` when any row has costs, else ``notc``."""
    if int(n_assets) > 1 or exercise_steps is not None:
        return "lsmc"
    return "rz" if any_tc else "notc"


def _require_lattice(grid: ScenarioGrid, engine: str):
    if grid.n_assets > 1 or grid.exercise_steps is not None:
        raise ValueError(
            f"engine {engine!r} prices single-asset American contracts only "
            f"(got n_assets={grid.n_assets}, exercise_steps="
            f"{grid.exercise_steps!r}); baskets and Bermudan schedules need "
            "the 'lsmc' engine")


def _require_single_device(mesh, devices, shard_plan):
    if mesh is not None or shard_plan is not None or (
            devices is not None and int(devices) != 1):
        raise NotImplementedError(_NOT_PORTED["shard"])


def _grid_inputs(grid: ScenarioGrid, device) -> tuple:
    """The 11 row columns as float64 tensors on ``device``: s0, sigma,
    rate, maturity, cost_rate, alpha, zeta, w1, w2, k1, k2."""
    alpha, zeta, w1, w2 = grid.payoff_param_arrays()
    cols = np.stack([grid.s0, grid.sigma, grid.rate, grid.maturity,
                     grid.cost_rate, alpha, zeta, w1, w2, grid.strike,
                     grid.strike2]).astype(np.float64)
    t = torch.as_tensor(cols, dtype=DEFAULT_DTYPE, device=device)
    return tuple(t.unbind(0))


def _with_bumps(inputs, greeks: bool):
    """Stack [base, s0+, s0-, sigma+, sigma-] along the row axis."""
    if not greeks:
        return inputs, 1
    s0, sigma = inputs[0], inputs[1]
    ds = _DELTA_REL_BUMP * s0
    dv = _VEGA_BUMP
    variants = [(s0, sigma), (s0 + ds, sigma), (s0 - ds, sigma),
                (s0, sigma + dv), (s0, sigma - dv)]
    out = []
    for i, a in enumerate(inputs):
        if i < 2:
            out.append(torch.cat([v[i] for v in variants]))
        else:
            out.append(a.repeat(5))
    return tuple(out), 5


def _split_bumps(vals, n: int, copies: int, s0, shape):
    """(surface, d/ds0, d/dsigma) from the stacked FD evaluation."""
    r = lambda a: np.asarray(a).reshape(shape)
    base = r(vals[:n])
    if copies == 1:
        return base, None, None
    ds = (_DELTA_REL_BUMP * s0).reshape(shape)
    delta = (r(vals[n:2 * n]) - r(vals[2 * n:3 * n])) / (2.0 * ds)
    vega = (r(vals[3 * n:4 * n]) - r(vals[4 * n:5 * n])) / (2.0 * _VEGA_BUMP)
    return base, delta, vega


def price_grid_rz(grid: ScenarioGrid, *, capacity: int = 48,
                  greeks: bool = False, backend: str = "kernel",
                  levels: Optional[int] = None, block: Optional[int] = None,
                  device="cuda", mesh=None, devices: Optional[int] = None,
                  shard_plan=None) -> GridResult:
    """Price every scenario of ``grid`` under transaction costs.

    ``backend="kernel"`` walks the ``core/partition.py`` round plan
    through ``kernels/rz_step.py::rz_round`` (``levels``/``block`` tune
    it); ``backend="torch"`` is the plain level walk.  Raises
    ``OverflowError`` if any scenario needs more than ``capacity`` knots.
    """
    _require_lattice(grid, "rz")
    _require_single_device(mesh, devices, shard_plan)
    dev = resolve_device(device)
    inputs, copies = _with_bumps(_grid_inputs(grid, dev), greeks)
    args, pay = inputs[:5], inputs[5:]
    if backend == "kernel":
        ask, bid, pieces = rz_backward_kernel(
            *args, pay, n_steps=grid.n_steps, capacity=capacity,
            levels=levels, block=block)
    elif backend == "torch":
        ask, bid, pieces = rz_backward(*args, pay, n_steps=grid.n_steps,
                                       capacity=capacity)
    else:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{RZ_BACKENDS}")
    ask, bid, pieces = (a.cpu().numpy() for a in (ask, bid, pieces))
    n = grid.n_scenarios
    max_pieces = int(pieces.max())
    if max_pieces > capacity:
        raise OverflowError(
            f"PWL capacity overflow: needed {max_pieces} > K={capacity}; "
            "re-run with a larger capacity")
    a, da, va = _split_bumps(ask, n, copies, grid.s0, grid.shape)
    b, db, vb = _split_bumps(bid, n, copies, grid.s0, grid.shape)
    row_pieces = pieces[:n].reshape(grid.shape).astype(int)
    return GridResult(grid=grid, ask=a, bid=b, max_pieces=max_pieces,
                      delta_ask=da, delta_bid=db, vega_ask=va, vega_bid=vb,
                      row_pieces=row_pieces, engine="rz")


def _notc_rows_kernel(s0, sigma, rate, maturity, alpha, zeta, w1, w2, k1, k2,
                      *, n_steps: int, levels: int, block: int):
    """Host round loop around ``lattice_round_param`` over all rows."""
    from .kernels.binomial_step import lattice_round_param
    dt = maturity / n_steps
    u = torch.exp(sigma * torch.sqrt(dt))
    r = torch.exp(rate * dt)
    p_up = (r - 1.0 / u) / (u - 1.0 / u)
    sig = sigma * torch.sqrt(dt)
    P = -(-(n_steps + 1) // block) * block
    idx = torch.arange(P, dtype=s0.dtype, device=s0.device)
    col = lambda a: a[:, None]
    s_leaf = col(s0) * torch.exp((2.0 * idx - n_steps) * col(sig))
    pay = (col(alpha) * col(k1) + col(w1) * torch.clamp_min(s_leaf - col(k1), 0.0)
           + col(w2) * torch.clamp_min(s_leaf - col(k2), 0.0)
           + col(zeta) * s_leaf)
    v = torch.clamp_min(pay, 0.0)
    scalars = torch.stack([torch.zeros_like(s0), p_up, 1.0 / r, s0, sig,
                           alpha, zeta, w1, w2, k1, k2], dim=1)
    for rr in range(math.ceil(n_steps / levels)):
        scalars[:, 0] = float(n_steps - rr * levels)
        v = lattice_round_param(v, scalars, levels=levels, block=block)
    return v[:, 0]


def price_grid_notc(grid: ScenarioGrid, *, backend: str = "kernel",
                    greeks: bool = False, levels: int = 64, block: int = 256,
                    device="cuda", mesh=None, devices: Optional[int] = None,
                    shard_plan=None) -> GridResult:
    """Friction-free binomial prices for every scenario of ``grid``.

    ``backend="kernel"`` runs the host round loop around
    ``kernels/binomial_step.py::lattice_round_param``; ``backend="torch"``
    the fixed-buffer level walk.  ``grid.cost_rate`` is ignored.
    """
    _require_lattice(grid, "notc")
    _require_single_device(mesh, devices, shard_plan)
    dev = resolve_device(device)
    inputs, copies = _with_bumps(_grid_inputs(grid, dev), greeks)
    args = inputs[:4] + inputs[5:]
    if backend == "kernel":
        vals = _notc_rows_kernel(*args, n_steps=grid.n_steps, levels=levels,
                                 block=block)
    elif backend == "torch":
        vals = notc_rows(*args, n_steps=grid.n_steps)
    else:
        raise ValueError(f"unknown backend {backend!r}; use 'kernel' or "
                         "'torch'")
    n = grid.n_scenarios
    p, dp, vp = _split_bumps(vals.cpu().numpy(), n, copies, grid.s0,
                             grid.shape)
    cp = lambda a: None if a is None else a.copy()
    return GridResult(grid=grid, ask=p, bid=p.copy(), max_pieces=0,
                      delta_ask=dp, delta_bid=cp(dp), vega_ask=vp,
                      vega_bid=cp(vp),
                      row_pieces=np.zeros(grid.shape, dtype=int),
                      engine="notc")
