"""Plain full-array oracle of the lattice kernels.

The port's copy of the JAX package's ``kernels/binomial_ref.py``:
:func:`lattice_levels_ref` advances every node of one row ``levels``
levels on the whole array, with a wrapping shift, as the JAX reference
does.  It is not the kernels' plain version: ``binomial_step.py::
lattice_round_plain`` repeats the kernels' block and halo structure and
gives this function's values on the lanes a round owns.  Also re-exports
the numpy oracle.
"""
from __future__ import annotations

import torch

from ..core.notc import price_notc_np  # noqa: F401  (re-export)

__all__ = ["lattice_levels_ref", "price_notc_np"]


def lattice_levels_ref(v, scalars, *, levels: int, kind: str = "put"):
    """Advance all nodes of ``v (P,)`` ``levels`` levels with ``scalars``
    ``[lvl0, p_up, inv_r, strike, s0, sig_sqrt_dt]`` in ``v``'s dtype."""
    lvl0, p_up, inv_r, strike, s0, sig = (scalars[i] for i in range(6))
    idx = torch.arange(v.shape[0], dtype=v.dtype, device=v.device)

    def payoff(lvl):
        s = s0 * torch.exp((2.0 * idx - lvl) * sig)
        pay = strike - s if kind == "put" else s - strike
        return torch.clamp_min(pay, 0.0)

    for j in range(levels):
        lvl = lvl0 - (j + 1)
        cont = (p_up * torch.roll(v, -1) + (1.0 - p_up) * v) * inv_r
        new = torch.maximum(payoff(lvl), cont)
        v = torch.where(lvl >= 0, new, v)
    return v
