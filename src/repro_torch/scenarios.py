"""Scenario-grid pricing: whole grids of contracts through the engines.

The port of the JAX package's ``scenarios.py``.  A grid is a flat
structure-of-arrays batch of contracts sharing one tree depth; mixed
payoff families batch together because the payoff is data (the
4-parameter family of ``core/payoff.py``).  Each engine prices the rows
as one batch (the row dimension JAX vmapped over):

* :func:`price_grid_rz` — Roux–Zastawniak ask/bid under transaction
  costs (exact at cost rate 0 too);
* :func:`price_grid_notc` — the friction-free binomial price;
* :func:`price_grid_lsmc` — least-squares Monte Carlo, for baskets and
  Bermudan schedules (``core/lsmc.py``).

``backend="kernel"`` runs the round loops around the CUDA kernels (their
plain versions on the CPU); ``backend="torch"`` runs the plain level
walks.  Central-difference Greeks (delta, vega) ride in the same batch.

``mesh``/``devices``/``shard_plan`` shard the flat batch over a 1-D mesh
of devices (``core/distributed.py``) under a cost-model plan
(``core/partition.py::plan_shards``): rows are permuted so that each
shard's predicted work is near-equal, each shard's slice is padded with
duplicates of its own rows, and results gather back through the inverse
permutation.  Pads are duplicates, so ``max_pieces``, ``row_pieces`` and
the ``OverflowError`` check see exactly the single-device values.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from functools import partial
from typing import Optional

import numpy as np
import torch

from .core.device import DEFAULT_DTYPE, resolve_device
from .core.distributed import resolve_grid_mesh, sharded_rows
from .core.lsmc import (LSMC_BASES, exercise_schedule, lsmc_rows,
                        path_keys)
from .core.notc import notc_rows
from .core.partition import (ShardPlan, plan_shards, scenario_costs,
                             shard_layout)
from .core.payoff import PAYOFF_FAMILIES, payoff_params
from .core.rz import RZ_BACKENDS, rz_backward, rz_backward_kernel

__all__ = ["ScenarioGrid", "GridResult", "ShardExecInfo", "price_grid_rz",
           "price_grid_notc", "price_grid_lsmc", "route_engine",
           "PAYOFF_FAMILIES", "payoff_params"]

_DELTA_REL_BUMP = 1e-4
_VEGA_BUMP = 1e-4


@dataclasses.dataclass(frozen=True)
class ScenarioGrid:
    """A flat SoA batch of pricing scenarios sharing one tree depth.

    Per-scenario fields are float64 numpy arrays of length
    ``n_scenarios``; ``shape`` is the logical grid shape results take.
    ``n_assets > 1`` (a basket a row) and ``exercise_steps`` (a Bermudan
    schedule of lattice steps, terminal step included) belong to the
    LSMC engine: the lattice engines reject them.
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
        if self.exercise_steps is not None:
            object.__setattr__(self, "exercise_steps", exercise_schedule(
                self.n_steps, self.exercise_steps))
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


@dataclasses.dataclass(frozen=True)
class ShardExecInfo:
    """How a grid call was laid out over a device mesh.

    ``plan`` is the :class:`~repro_torch.core.partition.ShardPlan` the
    call ran under; ``simulated`` is True when no mesh was available and
    the identical layout ran on the one device (bit-equal results; see
    ``resolve_grid_mesh``).  ``per_shard_pieces`` is the *measured* peak
    PWL knot count of each shard's rows (zero off the TC engine) and
    ``measured_work`` the cost model re-evaluated with those pieces: the
    signal a rebalancer feeds back into the next plan.
    """
    plan: ShardPlan
    mesh_shape: tuple
    simulated: bool
    per_shard_pieces: tuple
    per_shard_rows: tuple
    measured_work: tuple


@dataclasses.dataclass
class GridResult:
    """Ask/bid surfaces (and optional Greeks) over a scenario grid.

    Arrays have ``grid.shape``; ``max_pieces`` is the batch-wide peak PWL
    knot count and ``row_pieces`` the per-scenario peak (zeros on the
    friction-free path).  ``shard_info`` is set when the call ran over a
    mesh (or its simulation); ``stderr`` is the per-scenario Monte Carlo
    standard error (``lsmc`` only, None from the lattice engines).
    """
    grid: ScenarioGrid
    ask: np.ndarray
    bid: np.ndarray
    max_pieces: int = 0
    delta_ask: Optional[np.ndarray] = None
    delta_bid: Optional[np.ndarray] = None
    vega_ask: Optional[np.ndarray] = None
    vega_bid: Optional[np.ndarray] = None
    shard_info: Optional[ShardExecInfo] = None
    row_pieces: Optional[np.ndarray] = None
    stderr: Optional[np.ndarray] = None
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




# --------------------------------------------------------------------- #
# sharded dispatch over a 1-D mesh (core/distributed.py)
# --------------------------------------------------------------------- #
def _resolve_shard(grid: ScenarioGrid, n_rows: int, copies: int, *,
                   capacity: int, mesh, devices, kind: str,
                   shard_plan: Optional[ShardPlan], costs=None):
    """Normalise sharding knobs to ``(mesh_or_None, plan_or_None)``.

    A caller's ``shard_plan`` (a serving layer's rebalanced plan) must
    cover the *bumped* flat batch; otherwise a fresh cost-model plan is
    made here (``costs``, when given, overrides the lattice cost model:
    the lsmc engine passes its own).  ``(None, None)`` is the
    single-device path.
    """
    mesh, n_shards = resolve_grid_mesh(devices, mesh, kind=kind)
    if shard_plan is None and n_shards <= 1:
        return None, None
    if shard_plan is None:
        if costs is None:
            costs = np.tile(scenario_costs(grid.n_steps, grid.cost_rate,
                                           capacity=capacity), copies)
        shard_plan = plan_shards(costs, n_shards)
    elif n_shards > 1 and shard_plan.n_shards != n_shards:
        # also on the simulated path: a mismatch fails as on a real mesh
        raise ValueError(f"shard_plan has {shard_plan.n_shards} shards but "
                         f"devices/mesh asked for {n_shards}")
    if shard_plan.n_rows != n_rows:
        raise ValueError(f"shard_plan covers {shard_plan.n_rows} rows, "
                         f"batch has {n_rows} (greeks bumps included)")
    return mesh, shard_plan


def _run_rows(rows_fn, static: dict, inputs, mesh, plan: Optional[ShardPlan]):
    """Run the flat-batch row function; laid out by ``plan`` if present.

    Returns ``(outputs as numpy, positions)``: ``positions`` (None on the
    single path) maps original row ``i`` to its slot in the laid-out
    outputs.  With a plan but no mesh the identical layout runs on the
    one device (the *simulated* mesh).
    """
    if plan is None:
        out = rows_fn(*inputs, **static)
        return tuple(o.cpu().numpy() for o in out), None
    gather, positions = shard_layout(plan)
    g = torch.as_tensor(gather)
    laid_out = tuple(a[g.to(a.device)] for a in inputs)
    if mesh is None:
        out = rows_fn(*laid_out, **static)
    else:
        out = sharded_rows(partial(rows_fn, **static), mesh)(*laid_out)
    return tuple(o.cpu().numpy()[positions] for o in out), positions


def _shard_exec_info(plan: ShardPlan, mesh, grid: ScenarioGrid, copies: int,
                     pieces_rows: Optional[np.ndarray]) -> ShardExecInfo:
    """Measured per-shard stats for a rebalancer (see
    :class:`ShardExecInfo`)."""
    cr = np.tile(np.atleast_1d(np.asarray(grid.cost_rate)), copies)
    if pieces_rows is None:
        pieces_rows = np.zeros(plan.n_rows)
    costs = scenario_costs(grid.n_steps, cr,
                           pieces=np.maximum(pieces_rows, 1.0))
    per_pieces, measured = [], []
    for rows in plan.shards:
        idx = list(rows)
        per_pieces.append(int(np.max(pieces_rows[idx])) if idx else 0)
        measured.append(float(np.sum(costs[idx])) if idx else 0.0)
    return ShardExecInfo(plan=plan, mesh_shape=(plan.n_shards,),
                         simulated=mesh is None,
                         per_shard_pieces=tuple(per_pieces),
                         per_shard_rows=plan.sizes,
                         measured_work=tuple(measured))


# --------------------------------------------------------------------- #
# Roux–Zastawniak grid engine (transaction costs; exact at lambda = 0)
# --------------------------------------------------------------------- #
def _rz_rows(s0, sigma, rate, maturity, k, alpha, zeta, w1, w2, k1, k2, *,
             n_steps: int, capacity: int):
    """Flat-batch RZ rows, the plain level walk: ``(ask, bid, pieces)``."""
    return rz_backward(s0, sigma, rate, maturity, k,
                       (alpha, zeta, w1, w2, k1, k2), n_steps=n_steps,
                       capacity=capacity)


def _rz_rows_kernel(s0, sigma, rate, maturity, k, alpha, zeta, w1, w2, k1, k2,
                    *, n_steps: int, capacity: int, levels, block):
    """Flat-batch RZ rows through ``rz_round``: ``(ask, bid, pieces)``."""
    return rz_backward_kernel(s0, sigma, rate, maturity, k,
                              (alpha, zeta, w1, w2, k1, k2), n_steps=n_steps,
                              capacity=capacity, levels=levels, block=block)


def price_grid_rz(grid: ScenarioGrid, *, capacity: int = 48,
                  greeks: bool = False, backend: str = "kernel",
                  levels: Optional[int] = None, block: Optional[int] = None,
                  device="cuda", mesh=None, devices: Optional[int] = None,
                  shard_plan: Optional[ShardPlan] = None) -> GridResult:
    """Price every scenario of ``grid`` under transaction costs.

    ``backend="kernel"`` walks the ``core/partition.py`` round plan
    through ``kernels/rz_step.py::rz_round`` (``levels``/``block`` tune
    it); ``backend="torch"`` is the plain level walk.  Raises
    ``OverflowError`` if any scenario needs more than ``capacity`` knots.
    ``mesh``/``devices``/``shard_plan`` shard the batch (module
    docstring); results, ``max_pieces`` and the overflow check are those
    of the single-device call.
    """
    _require_lattice(grid, "rz")
    dev = resolve_device(device)
    inputs, copies = _with_bumps(_grid_inputs(grid, dev), greeks)
    if backend == "kernel":
        rows_fn = _rz_rows_kernel
        static = dict(n_steps=grid.n_steps, capacity=capacity, levels=levels,
                      block=block)
    elif backend == "torch":
        rows_fn = _rz_rows
        static = dict(n_steps=grid.n_steps, capacity=capacity)
    else:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{RZ_BACKENDS}")
    mesh, plan = _resolve_shard(grid, inputs[0].shape[0], copies,
                                capacity=capacity, mesh=mesh,
                                devices=devices, kind=dev.type,
                                shard_plan=shard_plan)
    (ask, bid, pieces), _ = _run_rows(rows_fn, static, inputs, mesh, plan)
    shard_info = (None if plan is None else
                  _shard_exec_info(plan, mesh, grid, copies, pieces))
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
                      shard_info=shard_info, row_pieces=row_pieces,
                      engine="rz")


# --------------------------------------------------------------------- #
# friction-free grid engine
# --------------------------------------------------------------------- #
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


def _notc_rows_torch(*cols, n_steps: int):
    """Flat-batch friction-free rows as a 1-tuple: the plain level walk."""
    return (notc_rows(*cols, n_steps=n_steps),)


def _notc_rows_round(*cols, n_steps: int, levels: int, block: int):
    """Flat-batch friction-free rows as a 1-tuple: through
    ``lattice_round_param``."""
    return (_notc_rows_kernel(*cols, n_steps=n_steps, levels=levels,
                              block=block),)


def price_grid_notc(grid: ScenarioGrid, *, backend: str = "kernel",
                    greeks: bool = False, levels: int = 64, block: int = 256,
                    device="cuda", mesh=None, devices: Optional[int] = None,
                    shard_plan: Optional[ShardPlan] = None) -> GridResult:
    """Friction-free binomial prices for every scenario of ``grid``.

    ``backend="kernel"`` runs the host round loop around
    ``kernels/binomial_step.py::lattice_round_param``; ``backend="torch"``
    the fixed-buffer level walk.  ``grid.cost_rate`` is ignored.
    ``mesh``/``devices``/``shard_plan`` shard the batch as in
    :func:`price_grid_rz` (friction-free rows all cost the same, so the
    default plan is the even split).
    """
    _require_lattice(grid, "notc")
    dev = resolve_device(device)
    inputs, copies = _with_bumps(_grid_inputs(grid, dev), greeks)
    # drop the cost-rate column (index 4): this engine is friction-free
    args = inputs[:4] + inputs[5:]
    if backend == "kernel":
        if levels is None or block is None:
            raise ValueError("backend='kernel' needs levels and block; got "
                             f"levels={levels!r}, block={block!r}")
        rows_fn = _notc_rows_round
        static = dict(n_steps=grid.n_steps, levels=levels, block=block)
    elif backend == "torch":
        rows_fn = _notc_rows_torch
        static = dict(n_steps=grid.n_steps)
    else:
        raise ValueError(f"unknown backend {backend!r}; use 'kernel' or "
                         "'torch'")
    mesh, plan = _resolve_shard(grid, args[0].shape[0], copies, capacity=1,
                                mesh=mesh, devices=devices, kind=dev.type,
                                shard_plan=shard_plan)
    (vals,), _ = _run_rows(rows_fn, static, args, mesh, plan)
    shard_info = (None if plan is None else
                  _shard_exec_info(plan, mesh, grid, copies, None))
    n = grid.n_scenarios
    p, dp, vp = _split_bumps(vals, n, copies, grid.s0, grid.shape)
    cp = lambda a: None if a is None else a.copy()
    return GridResult(grid=grid, ask=p, bid=p.copy(), max_pieces=0,
                      delta_ask=dp, delta_bid=cp(dp), vega_ask=vp,
                      vega_bid=cp(vp), shard_info=shard_info,
                      row_pieces=np.zeros(grid.shape, dtype=int),
                      engine="notc")


# --------------------------------------------------------------------- #
# least-squares Monte Carlo grid engine (baskets, Bermudan schedules)
# --------------------------------------------------------------------- #
def price_grid_lsmc(grid: ScenarioGrid, *, n_paths: int = 4096,
                    seed: int = 0, basis: str = "poly", degree: int = 3,
                    antithetic: bool = True, greeks: bool = False,
                    device="cuda", mesh=None, devices: Optional[int] = None,
                    shard_plan: Optional[ShardPlan] = None) -> GridResult:
    """Longstaff–Schwartz Monte Carlo prices for every scenario of ``grid``.

    The engine for ``grid.n_assets > 1`` (an arithmetic basket a row) and
    Bermudan ``grid.exercise_steps``; it also prices the plain 1-D
    American grid, which is how the tests hold it to the lattice.

    Deterministic for a given ``seed``: row ``i`` draws JAX's normals
    under the key ``path_keys(seed, n)[i]`` (``core/lsmc.py``), so the
    prices are JAX's for the same seed (within 1e-9: ``torch.erfinv``
    against XLA's) and independent of padding and of the
    ``mesh``/``devices``/``shard_plan`` layout.  ``GridResult.stderr``
    carries each scenario's standard error.  ``greeks`` uses the fused
    central-difference bumps with **common random numbers**: the key
    column is tiled over the bumped copies, as JAX tiles it, so a copy
    shares its row's key.
    """
    if basis not in LSMC_BASES:
        raise ValueError(f"unknown basis {basis!r}; use one of {LSMC_BASES}")
    steps = exercise_schedule(grid.n_steps, grid.exercise_steps)
    dev = resolve_device(device)
    inputs, copies = _with_bumps(_grid_inputs(grid, dev), greeks)
    n = grid.n_scenarios
    inputs = inputs + (path_keys(seed, n).to(dev).repeat(copies, 1),)
    static = dict(n_steps=grid.n_steps, steps=steps, n_paths=int(n_paths),
                  n_assets=grid.n_assets, degree=int(degree), basis=basis,
                  antithetic=bool(antithetic))
    costs = np.tile(scenario_costs(grid.n_steps, grid.cost_rate,
                                   engine="lsmc", n_paths=n_paths,
                                   n_exercise=len(steps),
                                   n_assets=grid.n_assets), copies)
    mesh, plan = _resolve_shard(grid, inputs[0].shape[0], copies, capacity=1,
                                mesh=mesh, devices=devices, kind=dev.type,
                                shard_plan=shard_plan, costs=costs)
    (ask, bid, se), _ = _run_rows(lsmc_rows, static, inputs, mesh, plan)
    shard_info = (None if plan is None else
                  _shard_exec_info(plan, mesh, grid, copies, None))
    a, da, va = _split_bumps(ask, n, copies, grid.s0, grid.shape)
    b, db, vb = _split_bumps(bid, n, copies, grid.s0, grid.shape)
    return GridResult(grid=grid, ask=a, bid=b, max_pieces=0,
                      delta_ask=da, delta_bid=db, vega_ask=va, vega_bid=vb,
                      shard_info=shard_info,
                      row_pieces=np.zeros(grid.shape, dtype=int),
                      stderr=se[:n].reshape(grid.shape), engine="lsmc")
