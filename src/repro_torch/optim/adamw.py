"""AdamW with float32 state, decoupled weight decay and global-norm
clipping.

The port of the JAX package's ``optim/adamw.py``, with its rule operation
for operation: gradients cast to float32, the global norm taken before
clipping, bias corrections computed in float32 from the float32 step,
``eps`` outside the square root, weight decay only on leaves with
``ndim >= decay_min_ndim``, and the ``master_fp32`` branch.

Parameters, gradients and the moments are dicts of tensors keyed alike
(a model's ``named_parameters()``), and ``adamw_update`` updates them in
place under ``torch.no_grad()`` (JAX returns new trees): at
recurrentgemma-2b's 13.26 GB of float32 weights a second copy of the
parameters or moments would not fit beside them on one card.  A leaf's
update holds two temporaries of its size.  The step, the schedule's rate
and the bias corrections stay host scalars, so an update makes no host
sync.  ``torch.optim`` is not used: its rule differs (``eps``, decay).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import torch

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    # params with ndim <= 1 (norm scales, biases) skip weight decay
    decay_min_ndim: int = 2
    # keep a float32 master copy when params are stored in a narrower type
    master_fp32: bool = False


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 0-d, on the host
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    master: Optional[Dict[str, torch.Tensor]] = None   # master_fp32 only


def adamw_init(params: Dict[str, torch.Tensor],
               cfg: Optional[AdamWConfig] = None) -> AdamWState:
    """Zero moments (float32, on each parameter's device), step 0 and, with
    ``cfg.master_fp32``, a float32 copy of the parameters."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    master = None
    if cfg is not None and cfg.master_fp32:
        master = {k: p.detach().to(torch.float32, copy=True)
                  for k, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      m={k: zeros(p) for k, p in params.items()},
                      v={k: zeros(p) for k, p in params.items()},
                      master=master)


@torch.no_grad()
def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The square root of the sum over leaves of each leaf's float32 sum
    of squares (a 0-d tensor on the leaves' device)."""
    total = None
    for g in tree.values():
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(tree: Dict[str, torch.Tensor], max_norm: float):
    """Scale every leaf in place by ``min(1, max_norm / max(norm,
    1e-12))``; returns ``(tree, norm)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    for g in tree.values():
        g.mul_(scale)
    return tree, norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Dict[str, torch.Tensor],
                 state: AdamWState, params: Dict[str, torch.Tensor], *,
                 gnorm: Optional[torch.Tensor] = None):
    """One AdamW step.  Returns ``(params, state, metrics)`` as JAX does;
    ``params``, the moments (and the master) are the same tensors, updated
    in place, and ``grads`` are clipped in place where they are already
    float32 (a narrower leaf's gradient is cast to float32 when its turn
    comes, so no float32 copy of every gradient is held at once).
    ``metrics``: ``grad_norm`` (before clipping, a device tensor) and
    ``lr``.  With ``master_fp32`` the float32 master is updated and each
    parameter is written back as its cast (JAX's ``pnew.astype``).
    ``gnorm``: the global norm where ``grads`` are a rank's part of the
    gradient (``train/step.py``); ``global_norm(grads)`` if None."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                            max=1.0)
    step = state.step + 1
    lr = (cfg.lr(step) if callable(cfg.lr)
          else torch.tensor(cfg.lr, dtype=torch.float32))
    stepf = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf

    base = state.master if cfg.master_fp32 else params
    for name, p in params.items():
        p32, g = base[name], grads[name].to(torch.float32)
        if scale is not None:
            g.mul_(scale)
        m, v = state.m[name], state.v[name]
        m.mul_(cfg.b1).add_(g * (1.0 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g).mul_(1.0 - cfg.b2))
        delta = m / b1c
        den = (v / b2c).sqrt_().add_(cfg.eps)
        delta.div_(den)
        del den
        if p32.dim() >= cfg.decay_min_ndim and cfg.weight_decay:
            delta.add_(p32.to(torch.float32) * cfg.weight_decay)
        delta.mul_(lr)
        if cfg.master_fp32:
            p32.sub_(delta)
            p.copy_(p32)
        else:
            p.sub_(delta)
        del delta
    new_state = AdamWState(step, state.m, state.v, state.master)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
