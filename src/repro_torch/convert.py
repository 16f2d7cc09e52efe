"""Carry state between the JAX package and the port, as numpy arrays.

These converters take and give plain numpy arrays, so neither package
imports the other:

* a PWL as ``(xs, ys, sl, sr, m)`` arrays <-> :class:`core.pwl.PWL`;
* a scenario grid's numpy columns -> :class:`scenarios.ScenarioGrid`;
* the numpy leaves of the JAX ``init_lm`` tree -> the port's
  :class:`models.transformer.LM` (``lm_params_from_jax``: decoder,
  encoder, MoE and cross-attention leaves), and any tree grouped as the
  JAX stack groups its layers (params or a decode cache, the decoder's
  stack or the encoder's) -> one dict a layer (``layer_trees``);
* back: the port's weights -> the numpy tree of JAX's ``init_lm``, each
  pattern position's leaves stacked over the repetitions as JAX's
  ``scan`` group holds them (``lm_params_to_jax``), and any dict keyed
  by the port's parameter names (gradients, AdamW moments) both ways
  (``lm_named_to_jax``, ``lm_named_from_jax``);
* a training state -> JAX's ``TrainState(params, AdamWState(step, m, v,
  master))`` of numpy trees and back (``train_state_to_jax``,
  ``train_state_from_jax``): what the checkpoints hold, under JAX's
  paths.

Every leaf keeps its dtype both ways.  numpy has no bfloat16 of its own
(JAX's arrays carry ``ml_dtypes``' type, which the port does not import),
so a bfloat16 leaf comes across through a 16-bit integer view of its
bits: a JAX array whose dtype is named ``bfloat16`` becomes a
``torch.bfloat16`` tensor of the same bits, and a ``torch.bfloat16``
leaf goes back as a host ``torch.bfloat16`` tensor (its bits
``t.view(torch.int16).numpy()``), which ``checkpoint.ckpt`` writes as
the ``bfloat16`` leaf JAX writes.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.pwl import PWL
from .models.transformer import LM
from .scenarios import ScenarioGrid

__all__ = ["to_torch", "pwl_from_numpy", "pwl_to_numpy", "grid_from_columns",
           "layer_trees", "lm_params_from_jax", "load_lm_params",
           "lm_params_to_jax", "lm_named_from_jax", "lm_named_to_jax",
           "is_expert_leaf",
           "train_state_to_jax", "train_state_from_jax"]


def to_torch(a) -> torch.Tensor:
    """A leaf as a tensor of its own dtype: a tensor as it is; a numpy
    array (a JAX leaf) with its dtype, a bfloat16 one through a view of
    its bits (no ``ml_dtypes`` needed), a read-only one copied."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy() if not bits.flags.writeable
                                else bits).view(torch.bfloat16)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _stack(arrs):
    return torch.stack(arrs) if isinstance(arrs[0], torch.Tensor) else \
        np.stack(arrs)


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
        if not isinstance(node, torch.Tensor):
            node = np.asarray(node)
        return node if r is None else node[r]
    out = [pick(tree[prefix + "scan"][f"b{j}"], r if reps > 1 else None)
           for r in range(reps) for j in range(len(pat))]
    return out + [pick(tree[f"{prefix}rem{r}"], None) for r in range(rem)]


def is_expert_leaf(name: str) -> bool:
    """Whether a parameter name is an MoE's experts' leaf (``wi``, ``wg``,
    ``wo``), which a rank of an expert-parallel mesh holds a slice of."""
    return name.rsplit(".", 2)[-2:-1] == ["moe"] and \
        name.rsplit(".", 1)[-1] in ("wi", "wg", "wo")


def _copy_tree(module, tree, where: str) -> None:
    names = {name for name, _ in module.named_children()} | {
        name for name, _ in module.named_parameters(recurse=False)}
    experts = getattr(module, "experts", None)
    if set(tree) != names:
        raise KeyError(f"{where}: JAX leaves {sorted(tree)} do not match the "
                       f"port's {sorted(names)}")
    for name, node in tree.items():
        if isinstance(node, dict):
            _copy_tree(getattr(module, name), node, f"{where}.{name}")
        else:
            leaf = getattr(module, name)
            src = to_torch(node)
            if experts is not None and name in ("wi", "wg", "wo"):
                src = src[experts]           # this rank's experts
            if src.shape != leaf.shape:
                raise ValueError(f"{where}.{name}: shape {tuple(src.shape)} "
                                 f"!= {tuple(leaf.shape)}")
            if src.dtype == leaf.dtype:
                leaf.data.copy_(src)
            else:                        # the JAX leaf's dtype is kept
                leaf.data = src.to(leaf.device, copy=True)


def _stacks(cfg) -> dict:
    """The port's layer lists and the JAX prefix and depth of each."""
    stacks = {"blocks": ("", cfg.n_layers)}
    if cfg.n_encoder_layers:
        stacks["enc_blocks"] = ("enc_", cfg.n_encoder_layers)
    return stacks


def _port_tree(params_np, cfg) -> dict:
    """A JAX ``init_lm``-shaped tree regrouped as the port's modules: the
    stack groups replaced by ``blocks`` / ``enc_blocks``, one dict a
    layer under its index."""
    tree = dict(params_np)
    for name, (prefix, n) in _stacks(cfg).items():
        reps, rem = divmod(n, len(cfg.block_pattern))
        for key in [f"{prefix}rem{r}" for r in range(rem)] + (
                [prefix + "scan"] if reps else []):
            tree.pop(key, None)
        tree[name] = {str(i): t for i, t in
                      enumerate(layer_trees(params_np, cfg, prefix, n))}
    return tree


def load_lm_params(model: LM, params_np, cfg) -> LM:
    """Copy the weights of a JAX ``init_lm`` tree (numpy leaves) into
    ``model``: the decoder's stack (``scan``, ``rem{r}``) and the
    encoder's (``enc_scan``), every block's ``moe`` (with ``shared``),
    ``norm_x`` and ``cross`` leaves, ``enc_norm`` and the embeddings.
    Every leaf is copied with its dtype (a bfloat16 tree gives a bfloat16
    model), and a leaf that is missing or left over raises.  A model
    holding a slice of each MoE's experts (``LM(experts=)``) takes that
    slice of JAX's leaves."""
    _copy_tree(model, _port_tree(params_np, cfg), "model")
    return model


def lm_params_from_jax(params_np, cfg, *, device="cpu",
                       experts=None) -> LM:
    """The port's model holding the weights of a JAX ``init_lm`` tree (see
    :func:`load_lm_params`), of each MoE's experts the slice ``experts``
    (all if None)."""
    return load_lm_params(LM(cfg, device=device, experts=experts),
                          params_np, cfg)


def _flat(node, prefix: str = "") -> dict:
    out = {}
    for key, val in node.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


def lm_named_from_jax(tree, cfg) -> dict:
    """A tree shaped as JAX's ``init_lm`` params (gradients, moments) as a
    dict keyed by the port's parameter names (``model.named_parameters()``:
    ``embed``, ``blocks.3.rglru.w_in``, ``final_norm.scale`` ...)."""
    return _flat(_port_tree(tree, cfg))


def lm_named_to_jax(named: dict, cfg, stack=_stack) -> dict:
    """The inverse of :func:`lm_named_from_jax`: arrays keyed by the port's
    parameter names -> the tree of JAX's ``init_lm``, layer ``r *
    len(pattern) + j`` under ``scan/b{j}`` (stacked over the ``reps``
    repetitions on a new leading axis when there are several, by
    ``stack`` of the repetitions' leaves), the rest under ``rem{r}``;
    the encoder's under ``enc_scan``."""
    pat = len(cfg.block_pattern)
    stacks = {name: (prefix, divmod(n, pat))
              for name, (prefix, n) in _stacks(cfg).items()}
    tree, stacked = {}, {}
    for name, arr in named.items():
        parts = name.split(".")
        if parts[0] in stacks:
            prefix, (reps, _) = stacks[parts[0]]
            i = int(parts[1])
            if i < reps * pat:
                r, j = divmod(i, pat)
                path = (prefix + "scan", f"b{j}", *parts[2:])
                if reps > 1:
                    stacked.setdefault(path, [None] * reps)[r] = arr
                    continue
            else:
                path = (f"{prefix}rem{i - reps * pat}", *parts[2:])
        else:
            path = tuple(parts)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    for path, arrs in stacked.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = stack(arrs)
    return tree


def _host(t: torch.Tensor):
    """A host copy of ``t`` that later in-place updates leave alone: a
    numpy array, or for a bfloat16 tensor (numpy has no such type) a host
    ``torch.bfloat16`` tensor."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.to("cpu", copy=True)
    return t.cpu().numpy().copy() if t.device.type == "cpu" else \
        t.cpu().numpy()


def lm_params_to_jax(model: LM, cfg) -> dict:
    """The port's weights as the numpy tree of JAX's ``init_lm`` (host
    copies): ``lm_params_from_jax`` of it gives the same model back."""
    return lm_named_to_jax({k: _host(p) for k, p in model.named_parameters()},
                           cfg)


def train_state_to_jax(state, cfg, gather=None):
    """A port ``TrainState(model, AdamWState)`` as JAX's ``TrainState``
    of numpy trees (host copies): ``params`` and the moments in JAX's
    ``init_lm`` layout, ``step`` an int32 scalar, ``master`` where the
    optimizer keeps one.  ``checkpoint.ckpt.save`` writes it under JAX's
    paths.  ``gather(t)``, where given, makes each experts' leaf whole
    (a rank mesh's slices gathered: checkpoints hold logical arrays)."""
    from .optim.adamw import AdamWState
    from .train.step import TrainState
    opt = state.opt
    whole = lambda k, t: gather(t) if gather and is_expert_leaf(k) else t
    tree = lambda d: lm_named_to_jax({k: _host(whole(k, t))
                                      for k, t in d.items()}, cfg)
    return TrainState(
        params=tree(dict(state.params.named_parameters())),
        opt=AdamWState(step=np.asarray(int(opt.step), np.int32),
                       m=tree(opt.m), v=tree(opt.v),
                       master=None if opt.master is None else
                       tree(opt.master)))


def _copy_named(dst: dict, tree, cfg, what: str, experts) -> None:
    src = lm_named_from_jax(tree, cfg)
    if set(src) != set(dst):
        raise KeyError(f"{what}: the leaves {sorted(set(src) ^ set(dst))} "
                       f"are in one tree only")
    with torch.no_grad():
        for name, t in dst.items():
            a = to_torch(src[name])
            if experts is not None and is_expert_leaf(name):
                a = a[experts]
            if a.shape != t.shape:
                raise ValueError(f"{what}.{name}: shape {tuple(a.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(a)


def train_state_from_jax(tree, cfg, state, experts=None):
    """Copy a JAX-layout ``TrainState`` of numpy trees (a restored
    checkpoint of either package) into the port's ``state``, in place
    (of each experts' leaf the slice ``experts``, where the state holds
    a rank's); returns the state with the restored step."""
    opt = state.opt
    _copy_named(dict(state.params.named_parameters()), tree.params, cfg,
                "params", experts)
    _copy_named(opt.m, tree.opt.m, cfg, "m", experts)
    _copy_named(opt.v, tree.opt.v, cfg, "v", experts)
    if (opt.master is None) != (tree.opt.master is None):
        raise ValueError("the checkpoint and the state disagree on a "
                         "float32 master copy")
    if opt.master is not None:
        _copy_named(opt.master, tree.opt.master, cfg, "master", experts)
    step = torch.tensor(int(tree.opt.step), dtype=torch.int32)
    return type(state)(state.params, opt._replace(step=step))
