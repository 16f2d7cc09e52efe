"""Train-step factory: microbatch gradient accumulation, clipping, AdamW.

The port of the JAX package's ``train/step.py``.  ``make_train_step``
returns ``step(state, batch) -> (state, metrics)``:

  * microbatched gradient accumulation over the batch's leading
    ``n_micro`` axis (``batch`` arrives as ``(n_micro, B / n_micro,
    S)``): the microbatches' gradients are summed in float32 (JAX: a
    float32 sum from zeros; float32 parameters add into their ``.grad``,
    narrower ones into float32 sums of their gradients), then the sum is
    divided by ``n_micro``, and the metric ``loss`` is the mean of the
    microbatches' ``loss + 0.01 * aux``, as JAX's;
  * the loss in float32, compute in ``run.dtype``, the parameters in
    their storage type (``init_train_state(param_dtype=)``: bfloat16
    beside AdamW's float32 master);
  * ``adamw_update`` in place: ``state`` comes back holding the same
    tensors (JAX donates the state's buffers to the same effect).  After
    a step each float32 parameter's ``.grad`` holds the clipped gradient
    that AdamW read.

``TrainState`` is a NamedTuple ``(params, opt)`` as JAX's, its
``params`` the model (an ``LM`` whose parameters require grad) and
``opt`` an ``AdamWState`` keyed by the model's parameter names;
``convert.train_state_to_jax`` gives JAX's tree of it.  ``lm_specs``
gives JAX's logical spec tree of the model (JAX's ``init_lm(...)[1]``)
and ``state_specs`` the state's, as JAX's.

With mesh ``rules`` (``models/sharding.py``) the step is a rank's share
of JAX's: the rank takes its ``dp`` slice of the (whole) batch; each
microbatch's loss is weighed by the rank's share of its tokens, so
that the gradients summed over ``dp`` are the global batch's, as JAX's
``lm_loss`` of the whole batch gives them; the MoE's ``aux`` is the
global batch's already.  Replicated parameters then get the same
update on every rank; a rank's experts (``moe_dispatch``) their own,
with the global norm taken over every rank's experts.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..configs.base import ModelConfig
from ..models.transformer import LM, RunCfg, init_lm, lm_loss
from ..optim.adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                           global_norm)

__all__ = ["TrainState", "train_state", "init_train_state", "lm_specs",
           "state_specs", "make_train_step", "sharded_norm"]


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def train_state(model: LM, opt_cfg: Optional[AdamWConfig] = None
                ) -> TrainState:
    """A train state around ``model``: its parameters made trainable,
    zero moments."""
    model.requires_grad_(True)
    return TrainState(model, adamw_init(dict(model.named_parameters()),
                                        opt_cfg))


def init_train_state(cfg: ModelConfig, generator: torch.Generator, *,
                     device="cuda", param_dtype=None,
                     opt_cfg: Optional[AdamWConfig] = None,
                     experts: Optional[slice] = None) -> TrainState:
    """Random weights (``models.transformer.init_lm``; of each MoE's
    experts the slice ``experts``, a rank's) and zero moments.
    ``param_dtype`` (JAX's): the weights stored in that type, drawn in
    float32 and rounded (JAX's ``init_lm`` then ``astype``), with a
    float32 master copy in the optimizer state, which it requires
    (``opt_cfg.master_fp32``).  JAX's ``specs``: :func:`lm_specs`."""
    if param_dtype not in (None, torch.float32) and not (
            opt_cfg is not None and opt_cfg.master_fp32):
        raise ValueError(f"param_dtype={param_dtype} keeps a float32 "
                         "master copy: pass AdamWConfig(master_fp32=True)")
    return train_state(init_lm(cfg, generator, device=device,
                               dtype=param_dtype or torch.float32,
                               experts=experts), opt_cfg)


def lm_specs(cfg: ModelConfig) -> dict:
    """JAX's logical spec tree of the model (``init_lm(key, cfg)[1]``):
    each leaf's logical axes (the containers' ``SPECS``), under JAX's
    leaf names and grouping, a stacked group's with a leading None."""
    from ..convert import lm_named_to_jax
    model = LM(cfg, device="meta")
    owner = dict(model.named_modules())
    named = {}
    for name, _ in model.named_parameters():
        mod, _, leaf = name.rpartition(".")
        named[name] = type(owner[mod]).SPECS[leaf]
    return lm_named_to_jax(named, cfg, stack=lambda s: (None,) + s[0])


def state_specs(specs, master_fp32: bool = False) -> TrainState:
    """Optimizer state shards exactly like params; step is replicated."""
    return TrainState(
        params=specs,
        opt=AdamWState(step=(), m=specs, v=specs,
                       master=specs if master_fp32 else None))


def sharded_norm(grads: dict, rules, sharded) -> torch.Tensor:
    """The global norm of a gradient of which each rank holds ``grads``:
    the leaves named in ``sharded`` are the rank's slices along ``tp``
    (its experts), whose sums of squares add over ``tp``; the rest are
    whole on every rank.  Without sharded leaves it is
    ``global_norm(grads)``."""
    if not sharded:
        return global_norm(grads)
    from ..models.sharding import psum_
    sq = lambda names: sum(torch.sum(torch.square(
        grads[n].to(torch.float32))) for n in names)
    whole = [n for n in grads if n not in sharded]
    part = psum_(sq(sharded).reshape(()), rules.mesh, rules.tp)
    return torch.sqrt(sq(whole) + part)


def make_train_step(cfg: ModelConfig, run: RunCfg, opt_cfg: AdamWConfig,
                    rules=None):
    """``batch``: a dict of tensors with leading ``(n_micro, batch)``
    axes, on the model's device: the whole batch, of which each rank of
    a mesh (``rules``) takes its ``dp`` slice."""
    from ..convert import is_expert_leaf
    from ..models.sharding import psum_
    dp = None if rules is None else rules.dp

    def step(state: TrainState, batch):
        model = state.params
        params = dict(model.named_parameters())
        if rules is not None:
            rows = rules.dp_slice(next(iter(batch.values())).shape[1])
            batch = {k: v[:, rows] for k, v in batch.items()}
        n_micro = next(iter(batch.values())).shape[0]
        # narrower parameters' gradients are summed in float32 apart
        narrow = n_micro > 1 and any(p.dtype != torch.float32
                                     for p in params.values())
        for p in params.values():
            p.grad = None
        lsum, gsum = None, {}
        for i in range(n_micro):
            loss, m = lm_loss(model, {k: v[i] for k, v in batch.items()},
                              cfg, run, rules)
            if rules is not None:
                # the rank's share of the microbatch's mean: its tokens
                # over the global count; aux is already the global one
                w = m["tokens"] / psum_(m["tokens"].clone(), rules.mesh, dp)
                local = m["loss"] * w
                (local + 0.01 * m["aux_loss"]).backward()
                loss = (psum_(local.detach(), rules.mesh, dp)
                        + 0.01 * m["aux_loss"].detach())
            else:
                loss.backward()
                loss = loss.detach()
            lsum = loss if lsum is None else lsum + loss
            if narrow:
                for name, p in params.items():
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                    gsum[name] = (g.float() if i == 0
                                  else gsum[name].add_(g))
                    p.grad = None
        grads = {}
        for name, p in params.items():
            if narrow:
                g = gsum[name]
            else:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[name] = g.div_(n_micro) if n_micro > 1 else g
            if rules is not None:
                psum_(grads[name], rules.mesh, dp)
        sharded = ([n for n in grads if is_expert_leaf(n)
                    and params[n].shape[0] != cfg.moe.num_experts]
                   if rules is not None and cfg.moe is not None else [])
        _, opt, om = adamw_update(opt_cfg, grads, state.opt, params,
                                  gnorm=sharded_norm(grads, rules, sharded))
        metrics = {"loss": lsum / n_micro, **om, "step": opt.step}
        return TrainState(model, opt), metrics

    return step
