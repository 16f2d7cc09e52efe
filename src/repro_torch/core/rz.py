"""Roux–Zastawniak ask/bid pricing under proportional transaction costs.

The port of the JAX package's ``core/rz.py``.  A tree level is a batch of
fixed-capacity PWL records (``core/pwl.py``) and every level update is
the paper's per-node recursion, data-parallel over nodes:

    w = max(z[i+1], z[i]);  v = cone(w / r);  z = max/min(u, v)

The seller (max, +expense) and buyer (min, -expense) sides walk fused as
one ``(..., 2, P)`` state with per-side flags, and a batch of contracts
is a leading row dimension ``R`` (JAX vmapped over contracts).  Both
walks follow the re-balanced round plan of ``core/partition.py``:

* :func:`rz_backward` — the plain level walk (``backend="torch"``);
* :func:`rz_backward_kernel` — one ``kernels/rz_step.py::rz_round`` per
  round (``backend="kernel"``: the CUDA kernel on a card, its plain
  version on the CPU).

Both walks take ``dtype`` (float64 by default, or float32), as JAX's
``rz_backward`` and ``rz_backward_pallas`` do.  In float32 the PWL
algebra's relative 1e-9 tolerance is below the float's resolution:
float noise reads as kinks and the knot counts grow by several a level
(a put at N=25 needs 73 knots in JAX's float32 walk, 4 in float64), so
float32 overflows a capacity that float64 fits.  :func:`rz_level_step` is
the single-step form, :func:`price_rz_batch` the batch of contracts
(JAX's vmapped ``price_rz``).

Overflow is detected, never silent: the walks return each row's peak
raw knot count and the callers raise ``OverflowError`` when it exceeds
the capacity.
"""
from __future__ import annotations

import dataclasses

import torch

from . import pwl as P
from .device import DEFAULT_DTYPE, resolve_device
from .lattice import LatticeModel
from .partition import kernel_round_plan
from .payoff import PayoffProcess, family_xi_zeta, kernel_params

__all__ = ["RZResult", "RZ_BACKENDS", "rz_params", "rz_level_step_lanes",
           "rz_level_step", "leaf_level", "rz_backward",
           "rz_backward_kernel", "price_rz", "price_rz_batch"]

RZ_BACKENDS = ("torch", "kernel")


@dataclasses.dataclass
class RZResult:
    ask: float
    bid: float
    max_pieces: int


def rz_params(s0, sigma, rate, maturity, k, *, n_steps: int) -> dict:
    """Per-row engine scalars from ``(R,)`` tensors: s0, k, sig_sqrt_dt, r."""
    dt = maturity / n_steps
    return dict(s0=s0, k=k, sig_sqrt_dt=sigma * torch.sqrt(dt),
                r=torch.exp(rate * dt))


def _select(mask, new: P.PWL, old: P.PWL) -> P.PWL:
    pick = lambda a, b: torch.where(mask[..., None] if a.dim() > mask.dim()
                                    else mask, a, b)
    return P.PWL(pick(new.xs, old.xs), pick(new.ys, old.ys),
                 pick(new.sl, old.sl), pick(new.sr, old.sr),
                 pick(new.m, old.m))


def _shift_up(z: P.PWL) -> P.PWL:
    """Lane i <- lane i+1 along the node axis (the last batch axis),
    wrapping like the TPU kernels' ``roll``."""
    axis = z.sl.dim() - 1
    return P.PWL(torch.roll(z.xs, -1, axis), torch.roll(z.ys, -1, axis),
                 torch.roll(z.sl, -1, axis), torch.roll(z.sr, -1, axis),
                 torch.roll(z.m, -1, axis))


def _xi_zeta(pay, s):
    """(xi, zeta) at spots ``s``: ``pay`` is the six family parameters
    (broadcasting against ``s``) or a closure-only :class:`PayoffProcess`,
    whose callables take the spots."""
    if isinstance(pay, PayoffProcess):
        return pay.xi_zeta(s)
    return family_xi_zeta(pay, s)


def rz_level_step_lanes(z: P.PWL, lvl, params: dict, pay, *, capacity: int,
                        seller, idx_offset=0):
    """One backward level update -> (z_new, per-lane pieces).

    ``z``'s last batch axis is the node axis (P lanes); ``lvl``,
    ``params`` values, the payoff parameters ``pay = (alpha, zeta, w1,
    w2, k1, k2)`` and ``idx_offset`` (global column of lane 0) broadcast
    against the batch dims.  ``pay`` may instead be a closure-only
    :class:`PayoffProcess`: its ``xi``/``zeta`` are called on the spots.  ``seller`` is a bool or a bool tensor (e.g.
    ``[[True], [False]]`` for a fused ``(2, P)`` state).  Pieces are 0 on
    lanes beyond the level.
    """
    Pn = z.sl.shape[-1]
    dtype, dev = z.xs.dtype, z.xs.device
    lvl = torch.as_tensor(lvl, dtype=dtype, device=dev)
    idx = idx_offset + torch.arange(Pn, dtype=dtype, device=dev)
    live = idx <= lvl
    s = params["s0"] * torch.exp((2.0 * idx - lvl) * params["sig_sqrt_dt"])
    no_tc = lvl == 0
    a = torch.where(no_tc, s, (1.0 + params["k"]) * s)
    b = torch.where(no_tc, s, (1.0 - params["k"]) * s)

    w, m1 = P.envelope2(_shift_up(z), z, capacity, take_max=True)
    w = P.scale(w, 1.0 / params["r"])
    v, m2 = P.cone_infconv(w, a, b, capacity)
    if isinstance(seller, bool):
        sign = 1.0 if seller else -1.0
    else:
        one = torch.ones((), dtype=dtype, device=dev)
        sign = torch.where(seller, one, -one)
    shape = z.sl.shape
    xi, zeta = _xi_zeta(pay, s)
    xi = (sign * xi).expand(shape)
    zeta = (sign * zeta).expand(shape)
    u = P.expense(xi, zeta, a.expand(shape), b.expand(shape), capacity)
    z_new, m3 = P.envelope2(u, v, capacity, take_max=seller)
    live = live.expand(shape)
    pieces = torch.where(live, torch.maximum(torch.maximum(m1, m2), m3), 0)
    return _select(live, z_new, z), pieces


def rz_level_step(z: P.PWL, lvl, params: dict, pay, *, capacity: int,
                  seller, idx_offset=0):
    """One backward level update -> (z_new, max pieces over the batch):
    :func:`rz_level_step_lanes` with its per-lane counts reduced, as the
    JAX package's ``rz_level_step``."""
    z_new, pieces = rz_level_step_lanes(z, lvl, params, pay,
                                        capacity=capacity, seller=seller,
                                        idx_offset=idx_offset)
    return z_new, pieces.amax()


def _cast(dtype, *cols):
    """Each market column (and each payoff tensor) in ``dtype``."""
    return tuple(c.to(dtype) if isinstance(c, torch.Tensor) else c
                 for c in cols)


def leaf_level(n_steps: int, params: dict, capacity: int,
               lanes: int | None = None, lane0: int = 0) -> P.PWL:
    """z at the extra instant t = N+1 (payoff (0, 0)): ``(R, lanes)``,
    lane 0 at tree column ``lane0``."""
    s0 = params["s0"]
    Pn = n_steps + 2 if lanes is None else lanes
    idx = lane0 + torch.arange(Pn, dtype=s0.dtype, device=s0.device)
    s = s0[:, None] * torch.exp((2.0 * idx - (n_steps + 1))
                                * params["sig_sqrt_dt"][:, None])
    a = (1.0 + params["k"][:, None]) * s
    b = (1.0 - params["k"][:, None]) * s
    zero = torch.zeros_like(s)
    return P.expense(zero, zero, a, b, capacity)


def _sides(dev) -> torch.Tensor:
    return torch.tensor([[True], [False]], device=dev)     # seller, buyer


def _fused_leaf(n_steps, params, capacity, lanes, lane0=0) -> P.PWL:
    leaf = leaf_level(n_steps, params, capacity, lanes, lane0)
    return leaf.map(lambda a: a[:, None].expand(
        (a.shape[0], 2) + a.shape[1:]).contiguous())


def _root_quote(z: P.PWL):
    root = lambda side: z.map(lambda a: a[:, side, 0])
    zero = torch.zeros((), dtype=z.xs.dtype, device=z.xs.device)
    return P.eval_at(root(0), zero), -P.eval_at(root(1), zero)


def rz_backward(s0, sigma, rate, maturity, k, pay, *, n_steps: int,
                capacity: int, dtype=torch.float64):
    """Plain level walk over rows -> (ask (R,), bid (R,), pieces (R,)).

    Every market argument is an ``(R,)`` tensor, cast to ``dtype``; ``pay``
    the six payoff parameters as ``(R,)`` tensors, or one closure-only
    :class:`PayoffProcess` for every row.
    """
    s0, sigma, rate, maturity, k = _cast(dtype, s0, sigma, rate, maturity, k)
    if not isinstance(pay, PayoffProcess):
        pay = _cast(dtype, *pay)
    params = rz_params(s0, sigma, rate, maturity, k, n_steps=n_steps)
    col = {n: v[:, None, None] for n, v in params.items()}
    payc = (pay if isinstance(pay, PayoffProcess)
            else tuple(p[:, None, None] for p in pay))
    plan = kernel_round_plan(n_steps)
    z = _fused_leaf(n_steps, params, capacity, plan[0].lanes)
    sides = _sides(s0.device)
    pieces = torch.zeros(s0.shape, dtype=torch.int32, device=s0.device)
    for rnd in plan:
        z = z.map(lambda a, n=rnd.lanes: a[:, :, :n])
        for j in range(rnd.depth):
            lvl = float(rnd.lvl0 - (j + 1))
            z, pc = rz_level_step_lanes(z, lvl, col, payc, capacity=capacity,
                                        seller=sides)
            pieces = torch.maximum(pieces, pc.amax(dim=(1, 2)))
    ask, bid = _root_quote(z)
    return ask, bid, pieces


def rz_backward_kernel(s0, sigma, rate, maturity, k, pay, *, n_steps: int,
                       capacity: int, levels: int | None = None,
                       block: int | None = None, dtype=torch.float64):
    """The level walk through ``rz_round``, one call per round of
    ``kernel_round_plan`` with the lanes shrunk to the live tree, in
    ``dtype`` (the kernel's float64 or float32 instance).

    ``block=None`` runs one block per round (no halo); an explicit
    ``block`` gives multi-block halo rounds.
    """
    from ..kernels.rz_step import rz_round
    s0, sigma, rate, maturity, k, *pay = _cast(dtype, s0, sigma, rate,
                                               maturity, k, *pay)
    params = rz_params(s0, sigma, rate, maturity, k, n_steps=n_steps)
    plan = kernel_round_plan(n_steps, levels=levels, block=block)
    z = _fused_leaf(n_steps, params, capacity, plan[0].lanes)
    pieces = torch.zeros(s0.shape, dtype=torch.int32, device=s0.device)
    scalars = torch.stack([torch.zeros_like(s0), params["s0"],
                           params["sig_sqrt_dt"], params["r"], params["k"],
                           *pay], dim=1)
    for rnd in plan:
        z = z.map(lambda a, n=rnd.lanes: a[:, :, :n].contiguous())
        scalars[:, 0] = float(rnd.lvl0)
        z, p = rz_round(z, scalars, levels=rnd.depth, block=rnd.block)
        pieces = torch.maximum(pieces, p)
    ask, bid = _root_quote(z)
    return ask, bid, pieces


def price_rz(model: LatticeModel, payoff: PayoffProcess, capacity: int = 48,
             *, backend: str = "kernel", levels: int | None = None,
             block: int | None = None, device="cuda") -> RZResult:
    """Ask/bid of one contract under transaction costs.

    A closure-only payoff (``payoff.params is None``) runs on
    ``backend="torch"`` only; the kernel takes the payoff as scalars and
    raises ``ValueError`` for it.
    """
    dev = resolve_device(device)
    t = lambda x: torch.tensor([float(x)], dtype=DEFAULT_DTYPE, device=dev)
    args = tuple(t(x) for x in (model.s0, model.sigma, model.rate,
                                model.maturity, model.cost_rate))
    if backend == "kernel":
        pay = tuple(t(x) for x in kernel_params(payoff))
        ask, bid, pc = rz_backward_kernel(*args, pay, n_steps=model.n_steps,
                                          capacity=capacity, levels=levels,
                                          block=block)
    elif backend == "torch":
        pay = (payoff if payoff.params is None
               else tuple(t(x) for x in payoff.params))
        ask, bid, pc = rz_backward(*args, pay, n_steps=model.n_steps,
                                   capacity=capacity)
    else:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{RZ_BACKENDS}")
    res = RZResult(ask=float(ask[0]), bid=float(bid[0]),
                   max_pieces=int(pc[0]))
    if res.max_pieces > capacity:
        raise OverflowError(
            f"PWL capacity overflow: needed {res.max_pieces} > K={capacity}; "
            "re-run with a larger capacity")
    return res


def price_rz_batch(s0, sigma, rate, maturity, k, *, n_steps: int,
                   capacity: int, payoff: PayoffProcess, device="cuda"):
    """Ask, bid and knot count of a batch of contracts, one payoff: the
    JAX package's ``price_rz_batch`` (a vmapped ``price_rz`` on its
    ``jnp`` walk), here the plain walk (:func:`rz_backward`) over rows in
    float64.  The inputs are scalars or 1-D and broadcast together;
    returns ``(ask, bid, max_pieces)`` tensors of the batch's length on
    ``device``.  Overflow is not raised: each row's ``max_pieces`` says
    whether it fits ``capacity``."""
    dev = resolve_device(device)
    cols = torch.broadcast_tensors(*(torch.atleast_1d(torch.as_tensor(
        v, dtype=DEFAULT_DTYPE, device=dev)) for v in (s0, sigma, rate,
                                                         maturity, k)))
    pay = (payoff if payoff.params is None else
           tuple(torch.full_like(cols[0], x) for x in payoff.params))
    return rz_backward(*cols, pay, n_steps=n_steps, capacity=capacity)
