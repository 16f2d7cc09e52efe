"""Sequential reference implementation of the Roux–Zastawniak algorithms.

Computes the ask price (Algorithm 3.1) and bid price (Algorithm 3.5) of an
American option under proportional transaction costs by exact backward
induction on the recombining binomial tree, carrying one piecewise-linear
expense function per node (see :mod:`repro_torch.core.pwl_ref`).

The port's own copy of the JAX package's ``core/rz_ref.py``, on the
port's :class:`LatticeModel` and :class:`PayoffProcess` (a payoff of the
4-parameter family gives its xi and zeta from its parameters, in numpy; a
closure-only one through its callables).  It is the correctness oracle
for the port's engines (:mod:`repro_torch.core.rz`,
:mod:`repro_torch.core.distributed`) and mirrors the paper's §3 exactly:

  level N+1:  z = u with payoff (0, 0)              (extra time instant)
  level n<=N: w = max(z_up, z_down)                 (worst case over moves)
              v = cone_infconv(w / r, S^a_n, S^b_n) (rebalancing)
              z = max(u_n, v)   [seller]  /  min(u_n, v)   [buyer]
  ask = z_0(0),  bid = -z'_0(0)

No transaction costs apply at t = 0 (S^a_0 = S_0 = S^b_0), following the
paper §4.1.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .lattice import LatticeModel
from .payoff import PayoffProcess
from .pwl_ref import PWLRef, cone_infconv, expense_function, pwl_max, pwl_min

__all__ = ["price_ref", "PriceResult"]


@dataclasses.dataclass
class PriceResult:
    ask: float
    bid: float
    max_pieces: int           # max knot count seen (sizes the fixed-K engine)
    z_seller_root: PWLRef
    z_buyer_root: PWLRef


def _xi_zeta(payoff: PayoffProcess, s: np.ndarray):
    """(xi(s), zeta(s)) in float64 numpy at the spots ``s``."""
    if payoff.params is None:
        xi, zeta = payoff.xi_zeta(torch.from_numpy(s))
        return xi.numpy(), zeta.numpy()
    alpha, zeta, w1, w2, k1, k2 = payoff.params
    xi = (alpha * k1 + w1 * np.maximum(s - k1, 0.0)
          + w2 * np.maximum(s - k2, 0.0))
    return xi, np.full_like(s, zeta)


def _leaf_functions(model: LatticeModel, n_level: int) -> tuple[list, list]:
    """z at the extra time instant t = N+1: payoff (0,0) for both parties."""
    s = model.s0 * np.exp(
        (2.0 * np.arange(n_level + 1, dtype=np.float64) - n_level)
        * model.sigma * np.sqrt(model.maturity / model.n_steps))
    k = model.cost_rate
    seller = [expense_function(0.0, 0.0, (1 + k) * si, (1 - k) * si) for si in s]
    buyer = [expense_function(0.0, 0.0, (1 + k) * si, (1 - k) * si) for si in s]
    return seller, buyer


def price_ref(model: LatticeModel, payoff: PayoffProcess,
              max_level: Optional[int] = None) -> PriceResult:
    """Exact sequential ask/bid prices (float64).

    ``max_level`` (testing hook) stops the recursion early and returns the
    functions at that level's first node instead of the root.
    """
    n = model.n_steps
    r = model.r
    k = model.cost_rate

    zs, zb = _leaf_functions(model, n + 1)
    max_pieces = 2

    for lvl in range(n, -1, -1):
        s_vec = model.stock_level(lvl)
        s_ask, s_bid = model.ask_bid_level(lvl)
        xi, zeta = _xi_zeta(payoff, s_vec)
        new_s: list[PWLRef] = []
        new_b: list[PWLRef] = []
        for i in range(lvl + 1):
            a_i = float(s_ask[i])
            b_i = float(s_bid[i])
            # seller -------------------------------------------------------
            w = pwl_max(zs[i + 1], zs[i]).scale(1.0 / r)
            v = cone_infconv(w, a_i, b_i)
            u = expense_function(float(xi[i]), float(zeta[i]), a_i, b_i)
            z = pwl_max(u, v)
            new_s.append(z)
            # buyer --------------------------------------------------------
            wb = pwl_max(zb[i + 1], zb[i]).scale(1.0 / r)
            vb = cone_infconv(wb, a_i, b_i)
            ub = expense_function(-float(xi[i]), -float(zeta[i]), a_i, b_i)
            # the buyer *chooses* between exercising and waiting
            zbuy = pwl_min(ub, vb)
            new_b.append(zbuy)
            max_pieces = max(max_pieces, z.m, zbuy.m, w.m, wb.m, v.m, vb.m)
        zs, zb = new_s, new_b
        if max_level is not None and lvl == max_level:
            break

    return PriceResult(
        ask=float(zs[0](0.0)),
        bid=float(-zb[0](0.0)),
        max_pieces=max_pieces,
        z_seller_root=zs[0],
        z_buyer_root=zb[0],
    )
