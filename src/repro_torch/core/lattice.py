"""Binomial lattice model parameters (Cox–Ross–Rubinstein, paper §4.1).

    u = exp(sigma * sqrt(T/N)),  d = 1/u,  r = exp(R T / N),
    p* = (r - d) / (u - d),      S(n, i) = S0 * u^(2i - n).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["LatticeModel"]


@dataclasses.dataclass(frozen=True)
class LatticeModel:
    """Market/model parameters for one pricing problem."""
    s0: float
    sigma: float
    rate: float
    maturity: float
    n_steps: int
    cost_rate: float = 0.0   # proportional transaction cost rate k in [0, 1)

    def __post_init__(self):
        if not (0.0 <= self.cost_rate < 1.0):
            raise ValueError("cost rate k must be in [0, 1)")
        if self.n_steps < 1:
            raise ValueError("need at least one time step")

    @property
    def dt(self) -> float:
        return self.maturity / self.n_steps

    @property
    def u(self) -> float:
        return math.exp(self.sigma * math.sqrt(self.dt))

    @property
    def d(self) -> float:
        return 1.0 / self.u

    @property
    def r(self) -> float:
        return math.exp(self.rate * self.dt)

    @property
    def p(self) -> float:
        """Risk-neutral up-move probability (friction-free model)."""
        return (self.r - self.d) / (self.u - self.d)

    def stock_level(self, n: int) -> np.ndarray:
        """Stock prices of all n+1 nodes at level n (float64)."""
        i = np.arange(n + 1, dtype=np.float64)
        return self.s0 * np.exp((2.0 * i - n) * self.sigma
                                * math.sqrt(self.maturity / self.n_steps))

    def ask_bid_level(self, n: int) -> tuple:
        """(S^a, S^b) for all nodes at level n; no costs at n == 0."""
        s = self.stock_level(n)
        if n == 0:
            return s, s.copy()
        return (1.0 + self.cost_rate) * s, (1.0 - self.cost_rate) * s
