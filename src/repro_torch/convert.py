"""Carry state between the JAX package and the port, as numpy arrays.

The port has no weights; its state is the PWL records the engines carry
and the scenario grids they price.  These converters take and give
plain numpy arrays, so neither package imports the other:

* a PWL as ``(xs, ys, sl, sr, m)`` arrays <-> :class:`core.pwl.PWL`;
* a scenario grid's numpy columns -> :class:`scenarios.ScenarioGrid`.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.pwl import PWL
from .scenarios import ScenarioGrid

__all__ = ["pwl_from_numpy", "pwl_to_numpy", "grid_from_columns"]


def pwl_from_numpy(xs, ys, sl, sr, m, *, device="cpu") -> PWL:
    """A port PWL from numpy arrays (any PWL NamedTuple of arrays works:
    ``pwl_from_numpy(*jax_pwl)``)."""
    f64 = lambda a: torch.tensor(np.asarray(a, np.float64), device=device)
    return PWL(f64(xs), f64(ys), f64(sl), f64(sr),
               torch.tensor(np.asarray(m, np.int32), device=device))


def pwl_to_numpy(f: PWL) -> tuple:
    """``(xs, ys, sl, sr, m)`` as numpy arrays (m int32)."""
    return tuple(a.detach().cpu().numpy() for a in f)


_GRID_FIELDS = ("s0", "sigma", "rate", "maturity", "cost_rate", "strike",
                "strike2", "payoff", "n_steps", "shape", "axes", "n_assets",
                "exercise_steps")


def grid_from_columns(grid) -> ScenarioGrid:
    """A port ``ScenarioGrid`` from any object with the JAX grid's fields
    (numpy columns, payoff names, ``n_steps``, ``shape`` ...)."""
    kw = {name: getattr(grid, name) for name in _GRID_FIELDS
          if hasattr(grid, name)}
    for name in ("s0", "sigma", "rate", "maturity", "cost_rate", "strike",
                 "strike2"):
        kw[name] = np.array(kw[name], dtype=np.float64)
    kw["payoff"] = tuple(kw["payoff"])
    kw["shape"] = tuple(kw["shape"])
    return ScenarioGrid(**kw)
