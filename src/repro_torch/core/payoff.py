"""American payoff processes (xi_t, zeta_t).

On exercise the seller delivers xi units of cash and zeta units of
stock.  A payoff comes in one of two forms:

* data: the 4-parameter family

      xi(s)   = alpha*k1 + w1*(s - k1)^+ + w2*(s - k2)^+
      zeta(s) = zeta                                  (constant)

  carried as ``params = (alpha, zeta, w1, w2, k1, k2)`` so the kernels
  can take it as scalars (every family constructor below);
* closure-only: ``xi``/``zeta`` callables on a torch tensor of spots,
  ``params=None`` (:func:`cash_settled` with an arbitrary ``g``).  The
  plain ``backend="torch"`` walks price it; the kernels refuse it
  (:func:`kernel_params`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["PayoffProcess", "param_payoff", "american_put", "american_call",
           "bull_spread", "cash_settled", "family_xi_zeta", "kernel_params",
           "payoff_params", "PAYOFF_FAMILIES"]

PAYOFF_FAMILIES = ("put", "call", "bull_spread")


@dataclasses.dataclass(frozen=True)
class PayoffProcess:
    """A named payoff: the 4-parameter family's ``params``, or the
    ``xi``/``zeta`` callables of a closure-only payoff."""
    name: str
    params: Optional[tuple] = None  # (alpha, zeta, w1, w2, k1, k2)
    xi: Optional[Callable] = None
    zeta: Optional[Callable] = None

    def __post_init__(self):
        if self.params is None and (self.xi is None or self.zeta is None):
            raise ValueError(f"payoff {self.name!r} needs params or both "
                             "xi and zeta")

    def xi_zeta(self, s: torch.Tensor):
        """``(xi(s), zeta(s))`` at a tensor of spots, each of ``s``'s
        shape: the callables of a closure-only payoff, else the family."""
        if self.params is None:
            return self.xi(s), self.zeta(s)
        return family_xi_zeta(self.params, s)

    def intrinsic(self, s):
        """Intrinsic value xi(S) + zeta(S) * S at stock prices ``s``: a
        numpy array (float64) in and out, or a tensor in and out."""
        if isinstance(s, torch.Tensor):
            xi, zeta = self.xi_zeta(s)
            return xi + zeta * s
        s = np.asarray(s, np.float64)
        if self.params is None:
            return self.intrinsic(torch.from_numpy(s)).numpy()
        alpha, zeta, w1, w2, k1, k2 = self.params
        return (alpha * k1 + w1 * np.maximum(s - k1, 0.0)
                + w2 * np.maximum(s - k2, 0.0) + zeta * s)


def family_xi_zeta(params, s: torch.Tensor):
    """``(xi(s), zeta(s))`` of the 4-parameter family; the six
    ``params`` are floats or tensors that broadcast against ``s``."""
    alpha, zeta, w1, w2, k1, k2 = params
    return (alpha * k1 + w1 * torch.clamp_min(s - k1, 0.0)
            + w2 * torch.clamp_min(s - k2, 0.0), zeta * torch.ones_like(s))


def kernel_params(payoff: PayoffProcess) -> tuple:
    """The six family parameters the kernels take as scalars; raises
    ``ValueError`` for a closure-only payoff."""
    if payoff.params is None:
        raise ValueError(
            f"backend='kernel' needs a 4-parameter-family payoff "
            f"(payoff.params set); {payoff.name!r} is closure-only. "
            "Use core.payoff.param_payoff / american_put / american_call / "
            "bull_spread, or backend='torch'.")
    return payoff.params


def param_payoff(alpha, zeta, w1, w2, k1, k2,
                 name: str = "param") -> PayoffProcess:
    """The 4-parameter family with its parameters as data."""
    return PayoffProcess(name, tuple(float(v) for v in
                                     (alpha, zeta, w1, w2, k1, k2)))


def american_put(strike: float) -> PayoffProcess:
    """Physically settled put: deliver (K, -1)."""
    k = float(strike)
    return PayoffProcess(f"put(K={k:g})", (1.0, -1.0, 0.0, 0.0, k, k))


def american_call(strike: float) -> PayoffProcess:
    """Physically settled call: deliver (-K, +1)."""
    k = float(strike)
    return PayoffProcess(f"call(K={k:g})", (-1.0, 1.0, 0.0, 0.0, k, k))


def bull_spread(k_long: float = 95.0, k_short: float = 105.0) -> PayoffProcess:
    """Paper §5: cash-settled (S-95)^+ - (S-105)^+ bull spread."""
    kl, ks = float(k_long), float(k_short)
    return PayoffProcess(f"bull_spread({kl:g},{ks:g})",
                         (0.0, 0.0, 1.0, -1.0, kl, ks))


def cash_settled(name: str, g: Callable,
                 params: Optional[tuple] = None) -> PayoffProcess:
    """Cash-settled payoff: deliver (g(S), 0).  ``g`` maps a tensor of
    spots to a tensor of cash amounts; pass ``params`` as well where
    ``g`` is a member of the family, so the kernels can price it."""
    return PayoffProcess(name, params, xi=g, zeta=torch.zeros_like)


def payoff_params(kind: str):
    """(alpha, zeta, w1, w2) of a payoff family; strikes come separately."""
    if kind == "put":
        return (1.0, -1.0, 0.0, 0.0)
    if kind == "call":
        return (-1.0, 1.0, 0.0, 0.0)
    if kind == "bull_spread":
        return (0.0, 0.0, 1.0, -1.0)
    raise ValueError(f"unknown payoff family {kind!r}; "
                     f"supported: {PAYOFF_FAMILIES}")
