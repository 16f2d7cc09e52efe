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
``convert.train_state_to_jax`` gives JAX's tree of it.  ``state_specs``
and ``batch_specs`` (the shardings) wait for the mesh slice.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..configs.base import ModelConfig
from ..models.transformer import LM, RunCfg, init_lm, lm_loss
from ..optim.adamw import AdamWConfig, AdamWState, adamw_init, adamw_update

__all__ = ["TrainState", "train_state", "init_train_state",
           "make_train_step"]


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
                     opt_cfg: Optional[AdamWConfig] = None) -> TrainState:
    """Random weights (``models.transformer.init_lm``) and zero moments.
    ``param_dtype`` (JAX's): the weights stored in that type, drawn in
    float32 and rounded (JAX's ``init_lm`` then ``astype``), with a
    float32 master copy in the optimizer state, which it requires
    (``opt_cfg.master_fp32``).  JAX's ``specs`` wait for the mesh
    slice."""
    if param_dtype not in (None, torch.float32) and not (
            opt_cfg is not None and opt_cfg.master_fp32):
        raise ValueError(f"param_dtype={param_dtype} keeps a float32 "
                         "master copy: pass AdamWConfig(master_fp32=True)")
    return train_state(init_lm(cfg, generator, device=device,
                               dtype=param_dtype or torch.float32), opt_cfg)


def make_train_step(cfg: ModelConfig, run: RunCfg, opt_cfg: AdamWConfig):
    """``batch``: a dict of tensors with leading ``(n_micro, local_batch)``
    axes, on the model's device."""

    def step(state: TrainState, batch):
        model = state.params
        params = dict(model.named_parameters())
        n_micro = next(iter(batch.values())).shape[0]
        # narrower parameters' gradients are summed in float32 apart
        narrow = n_micro > 1 and any(p.dtype != torch.float32
                                     for p in params.values())
        for p in params.values():
            p.grad = None
        lsum, gsum = None, {}
        for i in range(n_micro):
            loss, _ = lm_loss(model, {k: v[i] for k, v in batch.items()},
                              cfg, run)
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
        _, opt, om = adamw_update(opt_cfg, grads, state.opt, params)
        metrics = {"loss": lsum / n_micro, **om, "step": opt.step}
        return TrainState(model, opt), metrics

    return step
