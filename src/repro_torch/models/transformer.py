"""Model assembly: decoder-only LMs, hybrid stacks and encoder-decoder
backbones; init, prefill and decode.

The port of the JAX package's ``models/transformer.py``.  Every block is
pre-norm with a residual: a mixer (``attn``, ``local``, ``rglru`` or
``mamba``); in the decoder of an encoder-decoder model, cross attention
to the encoder's output behind its own norm (``norm_x``, ``cross``); and
every kind but ``mamba`` a gated MLP, or the mixture of experts where
the config has one, behind a second norm (JAX: ``if kind != "mamba"``).

The JAX package groups the layers into a scanned stack of pattern
repetitions plus remainder layers; the port holds one flat list,
``LM.blocks``, in layer order (repetition ``r``, sub-block ``j`` is
layer ``r * len(pattern) + j``; remainder ``r`` follows them), and the
encoder's layers as ``LM.enc_blocks`` with ``LM.enc_norm`` after them.
Its cache is one dict a decoder layer: ``{"k", "v"}`` of shape ``(B,
max_len, KVH, hd)`` for attention, ``{"conv", "h"}`` for RG-LRU and
mamba (a recurrent state whose size does not grow with ``max_len``),
and in an encoder-decoder model ``{"xk", "xv"}`` of shape ``(B, S_enc,
KVH, hd)``: the cross K/V, filled once at prefill from the encoder's
output.  ``decode_step`` updates the cache in place (JAX returns a new
one): that saves a copy of every KV cache per token.

The MoE runs JAX's ``moe_dense`` (every expert on every token), and
with ``RunCfg(moe_impl="dispatch")`` and mesh ``rules`` JAX's
``moe_dispatch`` (experts split over the ``tp`` ranks, each at a
capacity; ``models/sharding.py``); without rules dispatch runs dense,
as JAX's ``_apply_block`` does.  Under ``rules`` every function here is
a rank's share of JAX's (``models/sharding.py``): the batch is this
rank's ``dp`` slice and the model holds this rank's experts
(``LM(experts=)``, :func:`local_experts`).

Training: ``lm_loss`` is JAX's causal-LM (or encoder-decoder) cross
entropy plus ``0.01`` times the MoE's load-balancing term, differentiable
in the model's parameters once they require grad (``LM`` makes them
with ``requires_grad=False``, which serving keeps; ``train/step.py``
turns it on).  ``RunCfg.remat`` recomputes each block in the backward
pass: ``"full"`` keeps only the block's input, ``"dots"`` also the
outputs of the plain weight products (JAX's
``checkpoint_dots_with_no_batch_dims``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from ..configs.base import ModelConfig
from ..core.device import resolve_device
from . import layers as L
from .sharding import logical

__all__ = ["RunCfg", "local_experts", "Block", "LM", "init_lm",
           "embed_tokens", "encode", "prefill", "init_cache", "decode_step",
           "lm_loss"]

_KINDS = ("attn", "local", "rglru", "mamba")
# the recurrent kinds: the block function of each, whose state is
# ``(conv, h)``
_RECURRENT = {"rglru": L.rglru_block, "mamba": L.mamba_block}


_REMATS = ("none", "full", "dots")


@dataclasses.dataclass(frozen=True)
class RunCfg:
    """How the model runs.  ``dtype`` is the compute type, JAX's
    ``RunCfg.dtype``: bfloat16 by default, as JAX's; the weights are
    cast to it where they are used, the activations, K/V caches and
    convolution states are held in it, and JAX's float32 islands stay
    float32 (``models/layers.py``).  A caller that means float32 says
    so, as JAX's launchers and trainer do.  The port defaults to
    ``impl="flash"`` so that prefill goes through the attention kernel
    (the JAX package defaults to ``"naive"``).  ``"flash"`` trains too:
    with ``T > 1`` in grad mode ``flash_attention`` runs as an autograd
    Function whose backward is a kernel (JAX differentiates
    ``_attn_flash``); JAX's trainer and launcher, and the port's, keep
    ``"naive"``, and ``train(..., run=RunCfg(impl="flash"))`` takes the
    flash path.
    ``remat``, ``moe_impl`` and ``moe_psum_bf16`` are JAX's:
    ``"dispatch"`` runs ``moe_dispatch`` where mesh rules are given (dense
    without them), its combine in bfloat16 under ``moe_psum_bf16``."""
    impl: str = "flash"            # attention: flash | naive
    dtype: torch.dtype = L.DEFAULT_DTYPE
    remat: str = "none"            # backward recompute: none | full | dots
    moe_impl: str = "dense"        # dense | dispatch
    moe_psum_bf16: bool = False    # bfloat16 cross-rank MoE combine


def local_experts(cfg: ModelConfig, run: RunCfg, rules) -> Optional[slice]:
    """The experts a rank holds: its ``rules.expert_slice`` where
    ``moe_dispatch`` runs (an MoE config, ``moe_impl="dispatch"``,
    rules), else None (every expert: ``moe_dense`` needs them all)."""
    if rules is None or cfg.moe is None or run.moe_impl != "dispatch":
        return None
    return rules.expert_slice(cfg.moe.num_experts)


class Block(nn.Module):
    """One pre-norm block: a mixer (attention, RG-LRU or mamba), with
    ``cross`` a cross attention sub-layer, and, but for mamba, a gated
    MLP or the mixture of experts (JAX's ``_init_block``)."""

    def __init__(self, cfg: ModelConfig, kind: str, *, cross: bool = False,
                 device, dtype=torch.float32,
                 experts: Optional[slice] = None):
        super().__init__()
        if kind not in _KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
        self.kind = kind
        kw = dict(device=device, dtype=dtype)
        self.norm1 = L.RMSNorm(cfg.d_model, **kw)
        if kind == "rglru":
            self.rglru = L.RGLRU(cfg, **kw)
        elif kind == "mamba":
            self.mamba = L.Mamba(cfg, **kw)
        else:
            self.attn = L.Attention(cfg, **kw)
        if cross:
            self.norm_x = L.RMSNorm(cfg.d_model, **kw)
            self.cross = L.Attention(cfg, **kw)
        if kind != "mamba":
            self.norm2 = L.RMSNorm(cfg.d_model, **kw)
            if cfg.moe is not None:
                self.moe = L.MoE(cfg, experts=experts, **kw)
            elif cfg.d_ff:
                self.mlp = L.MLP(cfg.d_model, cfg.d_ff, **kw)


class LM(nn.Module):
    """The weights of an LM (uninitialised until ``init_lm`` or
    ``convert.lm_params_from_jax`` fills them), every leaf stored in
    ``dtype``: the decoder's blocks and, for an encoder-decoder config,
    the encoder's (``enc_blocks``, ``enc_norm``; JAX's ``init_lm``).
    ``experts``: the slice of each MoE's experts this rank holds (all if
    None; :func:`local_experts`)."""
    SPECS = {"embed": ("tp", "fsdp"), "lm_head": ("fsdp", "tp")}

    def __init__(self, cfg: ModelConfig, *, device="cpu",
                 dtype=torch.float32, experts: Optional[slice] = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        cross = cfg.n_encoder_layers > 0
        kw = dict(device=device, dtype=dtype)
        self.embed = nn.Parameter(torch.empty(cfg.vocab, d, **kw),
                                  requires_grad=False)
        self.blocks = nn.ModuleList(
            Block(cfg, cfg.block_kind(i), cross=cross, experts=experts, **kw)
            for i in range(cfg.n_layers))
        if cross:
            self.enc_blocks = nn.ModuleList(
                Block(cfg, cfg.block_kind(i), experts=experts, **kw)
                for i in range(cfg.n_encoder_layers))
            self.enc_norm = L.RMSNorm(d, **kw)
        self.final_norm = L.RMSNorm(d, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(d, cfg.vocab, **kw),
                                        requires_grad=False)

    @property
    def head(self):
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def init_lm(cfg: ModelConfig, generator: torch.Generator, *,
            device="cuda", dtype=torch.float32,
            experts: Optional[slice] = None) -> LM:
    """Random weights from ``generator`` (on ``device``), distributed as the
    JAX package's ``init_lm`` draws them, stored in ``dtype``.  Each leaf
    is drawn in float32 and stored rounded, one at a time (JAX's
    ``init_lm`` and then ``astype``, as ``train/step.py`` does for
    ``param_dtype``): the same generator gives the same weights, rounded,
    in any ``dtype``, and the device holds the model plus one float32
    leaf.  The two packages' generators give different numbers: parity
    tests copy JAX's weights instead.  With ``experts`` (a rank's slice)
    every expert is drawn and the slice kept, so the ranks of a mesh hold
    the slices of the one unsliced model."""
    model = LM(cfg, device=resolve_device(device), dtype=dtype,
               experts=experts)
    L.dense_init_(model.embed, generator)
    for module in model.modules():
        if hasattr(module, "init_"):
            module.init_(generator)
    if not cfg.tie_embeddings:
        L.dense_init_(model.lm_head, generator)
    return model


def embed_tokens(model: LM, tokens, dtype=L.DEFAULT_DTYPE):
    """JAX's ``embed.astype(dtype)[tokens]``: the rows gathered, then
    cast (the same values, without a cast copy of the whole table)."""
    return model.embed[tokens].to(dtype)


def _logits(model: LM, x, dtype):
    """JAX's ``(x @ head.astype(dtype)).astype(float32)``."""
    return (x @ model.head.to(dtype)).float()


def _apply_block(blk: Block, x, cfg: ModelConfig, run: RunCfg, *,
                 causal: bool = True, enc_out=None, rules=None):
    """Pre-norm block over a whole sequence from position 0 (causal, or
    bidirectional in the encoder), with cross attention to ``enc_out``
    where it is given.  Returns ``(x, cache entry, aux)``: the entry's
    ``k``, ``v`` (attention) or ``conv``, ``h`` (recurrent), and ``xk``,
    ``xv``; ``aux`` the MoE's load-balancing loss (None without one)."""
    h = L.rmsnorm(blk.norm1, x, cfg.norm_eps)
    if blk.kind in _RECURRENT:
        out, (conv, hh) = _RECURRENT[blk.kind](getattr(blk, blk.kind), h, cfg,
                                               dtype=run.dtype)
        entry = {"conv": conv, "h": hh}
    else:
        window = cfg.local_window if blk.kind == "local" else None
        out, (k, v) = L.attention(blk.attn, h, cfg, causal=causal,
                                  window=window, impl=run.impl,
                                  dtype=run.dtype)
        entry = {"k": k, "v": v}
    x = x + out
    if enc_out is not None:
        hx = L.rmsnorm(blk.norm_x, x, cfg.norm_eps)
        out, (entry["xk"], entry["xv"]) = L.attention(
            blk.cross, hx, cfg, x_kv=enc_out, causal=False, impl=run.impl,
            dtype=run.dtype)
        x = x + out
    x, aux = _ffn(blk, x, cfg, run, rules)
    return x, entry, aux


def _ffn(blk: Block, x, cfg: ModelConfig, run: RunCfg, rules):
    """The block's MLP or MoE sub-layer with its residual (none for
    mamba), then JAX's ``logical(x, rules, "dp", None, None)``.  Returns
    ``(x, aux)``, ``aux`` the MoE's load-balancing loss (None without
    one): a training term, which JAX's prefill and decode drop, as the
    port's do.  The MoE dispatches where ``run.moe_impl == "dispatch"``
    and ``rules`` are given (JAX's ``_apply_block``)."""
    aux, dtype = None, run.dtype
    if hasattr(blk, "moe"):
        h = L.rmsnorm(blk.norm2, x, cfg.norm_eps)
        if run.moe_impl == "dispatch" and rules is not None:
            out, aux = L.moe_dispatch(blk.moe, h, cfg, rules, dtype,
                                      psum_bf16=run.moe_psum_bf16)
        else:
            out, aux = L.moe_dense(blk.moe, h, cfg, dtype, rules=rules)
        x = x + out
    elif hasattr(blk, "mlp"):
        x = x + L.mlp(blk.mlp, L.rmsnorm(blk.norm2, x, cfg.norm_eps),
                      cfg.mlp_kind, dtype)
    if rules is not None:
        x = logical(x, rules, "dp", None, None)
    return x, aux


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               dtype=L.DEFAULT_DTYPE, *, cross_len: int = 0,
               device="cuda") -> List[Dict[str, torch.Tensor]]:
    """One zeroed cache entry a decoder layer, in ``dtype`` but for the
    recurrent states ``h`` (float32; JAX's ``init_cache``): K and V of
    ``max_len`` positions for attention, a recurrent state for RG-LRU
    (``conv (B, d_conv-1, W)``, ``h (B, W)``) and mamba (``conv (B,
    d_conv-1, di)``, ``h (B, di, ds)``); with ``cross_len``, also the
    cross K/V ``xk``, ``xv`` of ``cross_len`` encoder positions."""
    dev = resolve_device(device)
    hd, kvh, w = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.lru_width
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    f32 = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    cache = []
    for i in range(cfg.n_layers):
        kind = cfg.block_kind(i)
        if kind == "rglru":
            c = {"conv": zeros(B, cfg.recurrent.d_conv - 1, w),
                 "h": f32(B, w)}
        elif kind == "mamba":
            di = cfg.ssm.expand * cfg.d_model
            c = {"conv": zeros(B, cfg.ssm.d_conv - 1, di),
                 "h": f32(B, di, cfg.ssm.d_state)}
        else:
            c = {"k": zeros(B, max_len, kvh, hd),
                 "v": zeros(B, max_len, kvh, hd)}
        if cross_len:
            c["xk"] = zeros(B, cross_len, kvh, hd)
            c["xv"] = zeros(B, cross_len, kvh, hd)
        cache.append(c)
    return cache


def _encoder_input(model: LM, batch, cfg: ModelConfig, run: RunCfg):
    """The encoder's input in ``run.dtype`` (JAX's
    ``enc_embeds.astype(run.dtype)``, or the embedded ``enc_tokens``)."""
    if cfg.frontend == "audio_stub":
        return batch["enc_embeds"].to(run.dtype)
    return embed_tokens(model, batch["enc_tokens"], run.dtype)


@torch.inference_mode()
def encode(model: LM, batch, cfg: ModelConfig, run: RunCfg, rules=None):
    """The encoder of an encoder-decoder model: ``batch["enc_embeds"]``
    (B, S_enc, D) (the ``audio_stub`` frontend's frame embeddings) or the
    embedded ``batch["enc_tokens"]``, through the encoder's blocks
    bidirectionally at rotary positions ``0..S_enc-1``, then
    ``enc_norm``."""
    xe = _encoder_input(model, batch, cfg, run)
    for blk in model.enc_blocks:
        xe, _, _ = _apply_block(blk, xe, cfg, run, causal=False, rules=rules)
    return L.rmsnorm(model.enc_norm, xe, cfg.norm_eps)


@torch.inference_mode()
def prefill(model: LM, batch, cfg: ModelConfig, run: RunCfg,
            max_len: Optional[int] = None, rules=None):
    """Serve-side prefill.  ``batch["tokens"]``: (B, S) int64, and for an
    encoder-decoder model ``batch["enc_embeds"]`` or
    ``batch["enc_tokens"]`` (:func:`encode`).

    Returns ``(last_logits (B, V), cache)`` with the KV caches filled for
    positions ``[0, S)`` (cache length ``max_len`` or ``S``) and each
    decoder layer's cross K/V from the encoder's output.
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_len = max_len or S
    enc_out = (encode(model, batch, cfg, run, rules) if cfg.n_encoder_layers
               else None)
    x = embed_tokens(model, tokens, run.dtype)
    cache = init_cache(cfg, B, max_len, run.dtype, device=x.device,
                       cross_len=0 if enc_out is None else enc_out.shape[1])
    for blk, c in zip(model.blocks, cache):
        x, entry, _ = _apply_block(blk, x, cfg, run, enc_out=enc_out,
                                   rules=rules)
        for name, val in entry.items():
            if name in ("k", "v"):
                c[name][:, :S] = val
            elif name in ("xk", "xv"):
                c[name].copy_(val)
            else:
                c[name] = val
        del entry
    x = L.rmsnorm(model.final_norm, x[:, -1], cfg.norm_eps)
    return _logits(model, x, run.dtype), cache


def _decode_block(blk: Block, c, x, cfg: ModelConfig, pos: int,
                  run: RunCfg, rules):
    """One block, T = 1, against its cache entry (updated in place)."""
    dtype = run.dtype
    h = L.rmsnorm(blk.norm1, x, cfg.norm_eps)
    B = x.shape[0]
    if blk.kind in _RECURRENT:
        out, (conv, hh) = _RECURRENT[blk.kind](getattr(blk, blk.kind), h, cfg,
                                               state=(c["conv"], c["h"]),
                                               dtype=dtype)
        c["conv"], c["h"] = conv, hh
    else:
        hd, kvh = cfg.resolved_head_dim, cfg.n_kv_heads
        g = cfg.n_heads // kvh
        q, k, v = L._project_qkv(blk.attn, h, cfg, dtype)
        positions = torch.full((1,), pos, device=x.device)
        q = L.apply_rope(q.reshape(B, 1, kvh * g, hd), positions,
                         cfg.rope_theta).reshape(B, 1, kvh, g, hd)
        c["k"][:, pos] = L.apply_rope(k, positions, cfg.rope_theta)[:, 0]
        c["v"][:, pos] = v[:, 0]
        window = cfg.local_window if blk.kind == "local" else None
        bias = L._mask_bias(positions, torch.arange(c["k"].shape[1],
                                                    device=x.device),
                            causal=True, window=window, neg=-float("inf"))
        out = L._attn_naive(q, c["k"], c["v"], bias)
        out = out.reshape(B, 1, cfg.n_heads * hd) @ blk.attn.wo.to(dtype)
    x = x + out
    if hasattr(blk, "cross"):
        # the cached cross K/V, bidirectional, no rotary embedding
        hx = L.rmsnorm(blk.norm_x, x, cfg.norm_eps)
        out, _ = L.attention(blk.cross, hx, cfg, kv=(c["xk"], c["xv"]),
                             positions=torch.full((1,), pos, device=x.device),
                             causal=False, impl="naive", dtype=dtype,
                             use_rope=False)
        x = x + out
    return _ffn(blk, x, cfg, run, rules)[0]


@torch.inference_mode()
def decode_step(model: LM, cache, tokens, pos: int, cfg: ModelConfig,
                run: RunCfg, rules=None):
    """One decoding step.  ``tokens``: (B, 1); ``pos``: the position of
    ``tokens``.  Returns ``(logits (B, 1, V), cache)``, the cache updated
    in place."""
    x = embed_tokens(model, tokens, run.dtype)
    for blk, c in zip(model.blocks, cache):
        x = _decode_block(blk, c, x, cfg, pos, run, rules)
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    logits = _logits(model, x, run.dtype)
    if rules is not None:
        logits = logical(logits, rules, "dp", None, "tp")
    return logits, cache


# --------------------------------------------------------------------- #
# training loss
# --------------------------------------------------------------------- #
_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the plain weight products' outputs (2-D
    ``mm``/``addmm``: JAX's dots with no batch dimensions), recompute the
    rest, batched attention products included."""
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _MM
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _train_block(blk: Block, x, cfg: ModelConfig, run: RunCfg, causal: bool,
                 enc_out, rules=None):
    x, _, aux = _apply_block(blk, x, cfg, run, causal=causal, enc_out=enc_out,
                             rules=rules)
    return x, aux


def _block_fn(run: RunCfg):
    """``_train_block`` under ``run.remat``: as it is, or recomputed in the
    backward pass (``torch.utils.checkpoint``, non-reentrant) keeping
    only its inputs (``full``) or also its weight products (``dots``)."""
    if run.remat not in _REMATS:
        raise ValueError(f"remat must be one of {_REMATS}, got {run.remat!r}")
    if run.remat == "none":
        return _train_block
    kw = {} if run.remat == "full" else {"context_fn": functools.partial(
        _ckpt.create_selective_checkpoint_contexts, _save_dots)}
    return lambda *args: _ckpt.checkpoint(_train_block, *args,
                                          use_reentrant=False, **kw)


def lm_loss(model: LM, batch, cfg: ModelConfig, run: RunCfg, rules=None):
    """Causal-LM (or encoder-decoder) cross entropy, JAX's ``lm_loss``:
    ``batch["tokens"]``, ``batch["targets"]`` (B, S), an optional
    float ``batch["mask"]`` and the encoder's input (``enc_embeds`` or
    ``enc_tokens``).  The model computes in ``run.dtype``; its logits
    are rounded to it and the loss is taken in float32 (JAX's).  Returns ``(loss + 0.01 * aux,
    {"loss", "aux_loss", "tokens"})``, ``aux`` the decoder's summed MoE
    load-balancing loss (the encoder's is dropped, as in JAX).

    The target's logit is gathered: the same value as JAX's one-hot
    contraction, without a ``(B, S, V)`` one-hot (2.1 GB at batch 2 x
    1024 and vocab 256000).  With ``rules`` the batch is this rank's
    ``dp`` slice and the loss its slice's (``train/step.py`` weighs the
    ranks' losses by their tokens); the MoE's ``aux`` is the global
    batch's."""
    block = _block_fn(run)
    enc_out = None
    if cfg.n_encoder_layers:
        xe = _encoder_input(model, batch, cfg, run)
        for blk in model.enc_blocks:
            xe, _ = block(blk, xe, cfg, run, False, None, rules)
        enc_out = L.rmsnorm(model.enc_norm, xe, cfg.norm_eps)
    x = embed_tokens(model, batch["tokens"], run.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in model.blocks:
        x, a = block(blk, x, cfg, run, True, enc_out, rules)
        if a is not None:
            aux = aux + a
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    logits = _logits(model, x, run.dtype)
    if rules is not None:
        logits = logical(logits, rules, "dp", None, "tp")
    targets = batch["targets"].long()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    nll = (lse - true_logit) * mask
    tokens = mask.sum()
    loss = nll.sum() / torch.clamp_min(tokens, 1.0)
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux,
                               "tokens": tokens}
