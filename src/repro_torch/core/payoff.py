"""American payoff processes (xi_t, zeta_t) as data.

On exercise the seller delivers xi units of cash and zeta units of
stock.  Every contract the port prices is an instance of the
4-parameter family

    xi(s)   = alpha*k1 + w1*(s - k1)^+ + w2*(s - k2)^+
    zeta(s) = zeta                                  (constant)

carried as ``params = (alpha, zeta, w1, w2, k1, k2)`` so the kernels
can take it as scalars.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PayoffProcess", "param_payoff", "american_put", "american_call",
           "bull_spread", "payoff_params", "PAYOFF_FAMILIES"]

PAYOFF_FAMILIES = ("put", "call", "bull_spread")


@dataclasses.dataclass(frozen=True)
class PayoffProcess:
    """A payoff of the 4-parameter family, named."""
    name: str
    params: tuple     # (alpha, zeta, w1, w2, k1, k2)

    def intrinsic(self, s) -> np.ndarray:
        """Intrinsic value xi(S) + zeta * S at stock prices ``s`` (numpy)."""
        alpha, zeta, w1, w2, k1, k2 = self.params
        s = np.asarray(s, np.float64)
        return (alpha * k1 + w1 * np.maximum(s - k1, 0.0)
                + w2 * np.maximum(s - k2, 0.0) + zeta * s)


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
