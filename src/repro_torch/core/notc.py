"""Friction-free binomial American pricing (the paper's appendix).

    pi_N = intrinsic(S_N)
    pi_n(i) = max(intrinsic(S_n(i)), (p pi_{n+1}(i+1) + (1-p) pi_{n+1}(i)) / r)

* :func:`price_notc_np` — the port's own numpy oracle (O(N^2) loop).
* :func:`notc_rows` — the fixed-buffer backward induction over a batch of
  contracts ``(R, N+1)``, payoff as data (``_notc_kernel`` /
  ``_notc_one_jnp`` of the JAX package, with the row dimension written
  out where JAX used ``vmap``);
* :func:`notc_payoff_rows` — the same walk for one payoff given by its
  callables (a closure-only payoff has no data form);
* :func:`price_notc_torch` — one vanilla put or call through that walk,
  the twin of the JAX package's ``price_notc_jax``.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import DEFAULT_DTYPE, resolve_device
from .lattice import LatticeModel
from .payoff import PayoffProcess, family_xi_zeta

__all__ = ["price_notc_np", "intrinsic_grid", "notc_rows",
           "notc_payoff_rows", "price_notc_torch"]


def intrinsic_grid(model: LatticeModel, payoff: PayoffProcess,
                   level: int) -> np.ndarray:
    return np.maximum(payoff.intrinsic(model.stock_level(level)), 0.0)


def price_notc_np(model: LatticeModel, payoff: PayoffProcess) -> float:
    """Numpy oracle, vectorised per level."""
    n, r, p = model.n_steps, model.r, model.p
    v = intrinsic_grid(model, payoff, n)
    for lvl in range(n - 1, -1, -1):
        cont = (p * v[1:lvl + 2] + (1.0 - p) * v[:lvl + 1]) / r
        v = np.maximum(intrinsic_grid(model, payoff, lvl), cont)
    return float(v[0])


def _notc_walk(s0, sigma, rate, maturity, intrinsic, *,
               n_steps: int) -> torch.Tensor:
    """The fixed-buffer backward induction over ``(R, 1)`` columns;
    ``intrinsic(s)`` gives xi + zeta * s at a ``(R, N+1)`` tensor of
    spots.  Returns the ``(R,)`` prices."""
    dt = maturity / n_steps
    u = torch.exp(sigma * torch.sqrt(dt))
    r = torch.exp(rate * dt)
    p = (r - 1.0 / u) / (u - 1.0 / u)
    idx = torch.arange(n_steps + 1, dtype=s0.dtype, device=s0.device)

    def exercise(lvl: float):
        s = s0 * torch.exp((2.0 * idx - lvl) * sigma * torch.sqrt(dt))
        return torch.where(idx <= lvl, torch.clamp_min(intrinsic(s), 0.0),
                           0.0)

    v = exercise(float(n_steps))
    for lvl in range(n_steps - 1, -1, -1):
        cont = (p * torch.roll(v, -1, dims=1) + (1.0 - p) * v) / r
        v = torch.maximum(exercise(float(lvl)), cont)
    return v[:, 0]


def notc_rows(s0, sigma, rate, maturity, alpha, zeta, w1, w2, k1, k2, *,
              n_steps: int) -> torch.Tensor:
    """Plain level walk over rows: every argument a ``(R,)`` float64
    tensor on one device; returns the ``(R,)`` prices."""
    col = lambda a: a[:, None]
    params = tuple(map(col, (alpha, zeta, w1, w2, k1, k2)))

    def intrinsic(s):
        xi, z = family_xi_zeta(params, s)
        return xi + z * s

    return _notc_walk(col(s0), col(sigma), col(rate), col(maturity),
                      intrinsic, n_steps=n_steps)


def notc_payoff_rows(s0, sigma, rate, maturity, payoff: PayoffProcess, *,
                     n_steps: int) -> torch.Tensor:
    """:func:`notc_rows` for one payoff of any form, closure-only too:
    its ``intrinsic`` is called on the spots of every level."""
    col = lambda a: a[:, None]
    return _notc_walk(col(s0), col(sigma), col(rate), col(maturity),
                      payoff.intrinsic, n_steps=n_steps)


def price_notc_torch(model: LatticeModel, payoff: PayoffProcess, *,
                     device="cuda") -> float:
    """The twin of the JAX package's ``core/notc.py::price_notc_jax``: a
    vanilla put or call (``payoff.name`` starting with "put" or "call",
    else ``ValueError`` as JAX's) priced by the fixed-buffer level walk in
    float64 (plain PyTorch on ``device``; no kernel)."""
    if not payoff.name.startswith(("put", "call")):
        raise ValueError(f"price_notc_torch supports vanilla put/call, "
                         f"got {payoff.name}")
    dev = resolve_device(device)
    t = lambda x: torch.tensor([float(x)], dtype=DEFAULT_DTYPE, device=dev)
    return float(notc_payoff_rows(t(model.s0), t(model.sigma), t(model.rate),
                                  t(model.maturity), payoff,
                                  n_steps=model.n_steps)[0])
