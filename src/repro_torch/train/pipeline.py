"""Pipeline parallelism: a GPipe schedule over a rank mesh's pipe axis.

The port of the JAX package's ``train/pipeline.py``.  The layer stack
splits into ``stages`` equal groups of whole pattern repetitions, one a
coordinate of the mesh's ``pipe_axis`` (the production multi-pod mesh's
``pod`` axis, where the slow links between pods carry only activations);
the mesh's other axes keep their roles inside a stage: the microbatch
rows split over the data axes (``MeshRules`` without the pipe axis).

Schedule (GPipe): ``n_micro + stages - 1`` ticks; at tick ``t`` stage
``s`` runs microbatch ``t - s``, receiving its input from stage ``s - 1``
and sending its output to ``s + 1`` (stage 0 embeds the tokens, the last
stage takes the head and the loss).  JAX gets the backward pipeline from
``jax.grad`` (a ``ppermute``'s transpose is the reverse permute).
Point-to-point sends carry no autograd in PyTorch, so the port runs the
reverse schedule by hand: after every forward tick, the ticks again in
reverse, the last stage starting each microbatch's backward from its
loss, every other stage from the gradient its successor sends back,
each sending its input's gradient to its predecessor.  The stashed
activations are GPipe's (each microbatch's stage input and graph until
its backward); ``RunCfg.remat`` recomputes inside a stage (JAX always
rematerialises the stage body).

The loss is JAX's: the mean over microbatches of the mean cross entropy
(no mask, no MoE ``aux``: JAX's pipelined loss drops it).  The
embedding, final norm and head are replicated over the stages (their
gradients summed over the pipe axis, so a tied embedding adds its two
uses); a stage's blocks get gradients from its own ranks only.  Every
rank holds the whole ``LM`` and steps only its stage's blocks.

Limitations (JAX's): homogeneous decoder stacks only (the pattern
repetitions split evenly); no interleaved virtual stages; no
encoder-decoder.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
from torch import nn

from ..configs.base import ModelConfig
from ..models import layers as L
from ..models.sharding import MeshRules, mesh_sizes, psum_
from ..models.transformer import LM, RunCfg, _block_fn, _logits, embed_tokens
from ..optim.adamw import AdamWConfig, adamw_update
from .step import TrainState

__all__ = ["split_stages", "make_pp_loss", "make_pp_train_step"]


def split_stages(model: LM, cfg: ModelConfig, stages: int) -> List[nn.ModuleList]:
    """The decoder's blocks as ``stages`` equal groups of pattern
    repetitions (JAX's ``(stages, reps / stages, ...)`` restack): group
    ``s`` holds layers ``[s * n / stages, (s + 1) * n / stages)``."""
    pat = len(cfg.block_pattern)
    reps = cfg.n_layers // pat
    if cfg.n_layers % pat or reps % stages:
        raise ValueError(
            f"{cfg.n_layers} layers (pattern {pat}) do not split into "
            f"{stages} equal pipeline stages")
    if cfg.n_encoder_layers:
        raise ValueError("enc-dec models are not supported by the pipeline")
    per = reps // stages * pat
    return [nn.ModuleList(model.blocks[s * per:(s + 1) * per])
            for s in range(stages)]


def _head_loss(model: LM, h, targets, cfg: ModelConfig, run: RunCfg):
    """JAX's pipelined ``head_loss``: the final norm, the head, the mean
    cross entropy over every token."""
    h = L.rmsnorm(model.final_norm, h, cfg.norm_eps)
    logits = _logits(model, h, run.dtype)
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - true_logit)


class _Pipe:
    """One rank's place in the pipeline: its stage, its neighbours' global
    ranks and the rules of the mesh inside a stage."""

    def __init__(self, cfg: ModelConfig, run: RunCfg, mesh, stages: int,
                 pipe_axis: str):
        sizes = mesh_sizes(mesh)
        if sizes[pipe_axis] != stages:
            raise ValueError(f"{stages} stages on a {pipe_axis!r} axis of "
                             f"{sizes[pipe_axis]} ranks")
        axes = [a for a in sizes if a != pipe_axis]
        self.rules = MeshRules(mesh=mesh,
                               fsdp=tuple(a for a in axes if a != "model"),
                               tp=("model",) if "model" in axes else ())
        self.cfg, self.run, self.mesh = cfg, run, mesh
        self.stages, self.pipe_axis = stages, pipe_axis
        self.stage = mesh.get_local_rank(pipe_axis)
        self.ranks = dist.get_process_group_ranks(mesh.get_group(pipe_axis))
        self.block = _block_fn(run)

    def owned(self, model: LM) -> dict:
        """The parameters this rank steps: its stage's blocks and the
        replicated embedding, final norm and head."""
        blocks = split_stages(model, self.cfg, self.stages)[self.stage]
        mine = {id(p) for p in blocks.parameters()}
        return {n: p for n, p in model.named_parameters()
                if id(p) in mine or not n.startswith("blocks.")}

    def run_batch(self, model: LM, batch, backward: bool):
        """The GPipe forward (and, with ``backward``, the reverse
        schedule): returns JAX's loss, the same on every rank; the
        gradients land in the parameters' ``.grad``."""
        cfg, run, s = self.cfg, self.run, self.stage
        last = s == self.stages - 1
        rows = self.rules.dp_slice(batch["tokens"].shape[1])
        tokens, targets = batch["tokens"][:, rows], batch["targets"][:, rows]
        n_micro, mb, S = tokens.shape
        # each microbatch's mean over this rank's rows: its share of the
        # mean over all rows
        w = 1.0 / self.rules.axis_size(self.rules.dp)
        blocks = split_stages(model, cfg, self.stages)[s]
        inputs, outputs = {}, {}
        loss_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for t in range(n_micro + self.stages - 1):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            with torch.set_grad_enabled(backward):
                if s == 0:
                    h = embed_tokens(model, tokens[m], run.dtype)
                else:
                    h = torch.empty((mb, S, cfg.d_model), dtype=run.dtype,
                                    device=tokens.device)
                    dist.recv(h, self.ranks[s - 1])
                    h.requires_grad_(backward)
                inputs[m] = h
                for blk in blocks:
                    h, _ = self.block(blk, h, cfg, run, True, None,
                                      self.rules)
                if last:
                    lm = _head_loss(model, h, targets[m], cfg, run)
                    loss_acc += lm.detach() * w
                    outputs[m] = lm * (w / n_micro)
                else:
                    dist.send(h.detach().contiguous(), self.ranks[s + 1])
                    outputs[m] = h
        if backward:
            for t in reversed(range(n_micro + self.stages - 1)):
                m = t - s
                if not 0 <= m < n_micro:
                    continue
                if last:
                    outputs[m].backward()
                else:
                    g = torch.empty_like(outputs[m])
                    dist.recv(g, self.ranks[s + 1])
                    outputs[m].backward(g)
                if s > 0:
                    dist.send(inputs[m].grad.contiguous(), self.ranks[s - 1])
                del inputs[m], outputs[m]
        # only the last stage accumulated the loss; share it with every stage
        psum_(loss_acc, self.mesh, (self.pipe_axis,) + self.rules.dp)
        return loss_acc / n_micro


def make_pp_loss(cfg: ModelConfig, run: RunCfg, mesh, *, stages: int,
                 pipe_axis: str = "pod"):
    """Returns ``loss(model, batch)`` with ``batch["tokens"]``,
    ``batch["targets"]`` of shape ``(n_micro, mb, S)`` (the whole batch,
    on every rank): the pipelined forward, JAX's loss."""
    pipe = _Pipe(cfg, run, mesh, stages, pipe_axis)

    def loss_fn(model: LM, batch):
        with torch.no_grad():
            return pipe.run_batch(model, batch, backward=False)

    return loss_fn


def make_pp_train_step(cfg: ModelConfig, run: RunCfg, opt_cfg: AdamWConfig,
                       mesh, *, stages: int, pipe_axis: str = "pod"):
    """The pipelined train step: the GPipe forward and reverse schedule,
    the gradients summed over the data axes (and the replicated leaves'
    over the pipe axis), the global norm over every stage's gradients,
    then AdamW on this rank's parameters (JAX's optimizer outside the
    ``shard_map``, seeing all stages).  ``step(state, batch) -> (state,
    metrics)``, ``state`` a ``TrainState`` whose model requires grad."""
    pipe = _Pipe(cfg, run, mesh, stages, pipe_axis)
    dp = pipe.rules.dp

    def step(state: TrainState, batch):
        model = state.params
        params = pipe.owned(model)
        for p in model.parameters():
            p.grad = None
        loss = pipe.run_batch(model, batch, backward=True)
        grads, staged, whole = {}, 0.0, 0.0
        for name, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if name.startswith("blocks."):
                psum_(g, mesh, dp)
                staged = staged + torch.sum(torch.square(g.float()))
            else:
                psum_(g, mesh, (pipe_axis,) + dp)
                whole = whole + torch.sum(torch.square(g.float()))
            grads[name] = g
        staged = psum_(torch.as_tensor(staged, device=loss.device), mesh,
                       pipe_axis)
        gnorm = torch.sqrt(staged + whole)
        _, opt, om = adamw_update(opt_cfg, grads, state.opt, params,
                                  gnorm=gnorm)
        return TrainState(model, opt), {"loss": loss, **om, "step": opt.step}

    return step
