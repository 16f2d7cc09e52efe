"""Carry state between the JAX package and the port, as numpy arrays.

These converters take and give plain numpy arrays, so neither package
imports the other:

* a PWL as ``(xs, ys, sl, sr, m)`` arrays <-> :class:`core.pwl.PWL`;
* a scenario grid's numpy columns -> :class:`scenarios.ScenarioGrid`;
* the numpy leaves of the JAX ``init_lm`` tree -> the port's
  :class:`models.transformer.LM` (``lm_params_from_jax``: decoder,
  encoder, MoE and cross-attention leaves), and any tree grouped as the
  JAX stack groups its layers (params or a decode cache, the decoder's
  stack or the encoder's) -> one dict a layer (``layer_trees``).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.pwl import PWL
from .models.transformer import LM
from .scenarios import ScenarioGrid

__all__ = ["pwl_from_numpy", "pwl_to_numpy", "grid_from_columns",
           "layer_trees", "lm_params_from_jax"]


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


def layer_trees(tree, cfg, prefix: str = "", n_layers=None) -> list:
    """One nested dict a layer, in layer order, from a tree grouped as the
    JAX stack groups its layers: ``tree[prefix + "scan"]["b{j}"]`` holds
    pattern position ``j`` of every repetition (its leaves with a
    leading ``reps`` axis when there are several), ``tree[prefix +
    "rem{r}"]`` the remainder.  ``prefix`` is ``""`` for the decoder
    (params or a decode cache) and ``"enc_"`` for the encoder;
    ``n_layers`` defaults to the stack's count in ``cfg``."""
    pat = cfg.block_pattern
    if n_layers is None:
        n_layers = cfg.n_encoder_layers if prefix == "enc_" else cfg.n_layers
    reps, rem = divmod(n_layers, len(pat))

    def pick(node, r):
        if isinstance(node, dict):
            return {key: pick(val, r) for key, val in node.items()}
        return np.asarray(node) if r is None else np.asarray(node)[r]
    out = [pick(tree[prefix + "scan"][f"b{j}"], r if reps > 1 else None)
           for r in range(reps) for j in range(len(pat))]
    return out + [pick(tree[f"{prefix}rem{r}"], None) for r in range(rem)]


def _copy_tree(module, tree, where: str) -> None:
    names = {name for name, _ in module.named_children()} | {
        name for name, _ in module.named_parameters(recurse=False)}
    if set(tree) != names:
        raise KeyError(f"{where}: JAX leaves {sorted(tree)} do not match the "
                       f"port's {sorted(names)}")
    for name, node in tree.items():
        if isinstance(node, dict):
            _copy_tree(getattr(module, name), node, f"{where}.{name}")
        else:
            leaf = getattr(module, name)
            src = torch.tensor(np.asarray(node, np.float32))
            if src.shape != leaf.shape:
                raise ValueError(f"{where}.{name}: shape {tuple(src.shape)} "
                                 f"!= {tuple(leaf.shape)}")
            leaf.data.copy_(src)


def lm_params_from_jax(params_np, cfg, *, device="cpu") -> LM:
    """The port's model holding the weights of a JAX ``init_lm`` tree
    (its leaves as numpy arrays): the decoder's stack (``scan``,
    ``rem{r}``) and the encoder's (``enc_scan``), every block's ``moe``
    (with ``shared``), ``norm_x`` and ``cross`` leaves, ``enc_norm`` and
    the embeddings.  Every leaf is copied, and a leaf that is missing or
    left over raises."""
    model = LM(cfg, device=device)
    tree, stacks = dict(params_np), {"blocks": ("", cfg.n_layers)}
    if cfg.n_encoder_layers:
        stacks["enc_blocks"] = ("enc_", cfg.n_encoder_layers)
    for name, (prefix, n) in stacks.items():
        reps, rem = divmod(n, len(cfg.block_pattern))
        for key in [f"{prefix}rem{r}" for r in range(rem)] + (
                [prefix + "scan"] if reps else []):
            tree.pop(key, None)
        tree[name] = {str(i): t for i, t in
                      enumerate(layer_trees(params_np, cfg, prefix, n))}
    _copy_tree(model, tree, "model")
    return model
