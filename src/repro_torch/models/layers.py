"""Model layers: norms, rotary, GQA attention, gated MLP, MoE, RG-LRU,
mamba.

The port of the JAX package's ``models/layers.py``.  The weights live
in ``nn.Module`` containers in the JAX layout (``(in, out)`` matrices,
used as ``x @ w``), under the JAX leaf names, so that converting a JAX
tree is a copy; the apply functions take a container and read its
leaves, as the JAX functions read a params dict.

Compute follows JAX's dtype policy: the leaves are stored in float32
or in a narrower type, and every apply function casts each weight to
its ``dtype`` (JAX's ``cast = lambda w: w.astype(dtype)``; default
``DEFAULT_DTYPE``, bfloat16, as JAX's) where it uses it.  JAX's float32
islands stay float32: ``rmsnorm`` and ``_qk_head_norm`` (normalised in
float32, rounded back to the input's type), rotary embedding (float32
angles, rounded back), the attention scores, softmax and PV sums (JAX's
``preferred_element_type=float32``: the products of bfloat16 values are
exact in float32, so the port upcasts the operands and multiplies in
float32, rounding ``w`` to ``v``'s type before PV and the output after
it, where JAX does), the RG-LRU coefficients and recurrence, mamba's
``delta``, ``bx``, state and ``y``, the router's softmax.  Two calls go
to the kernels where the JAX model calls their references:

* ``attention(impl="flash")`` with ``T > 1`` and no cached K/V calls
  ``ops.flash_attention`` (JAX: ``_attn_flash``): causal self attention
  of a prefill, the bidirectional encoder and cross attention to an
  encoder's output (``x_kv``, ``S != T``), positions from 0;
* ``rglru_block`` and ``mamba_block`` with ``T > 1`` call
  ``ops.lru_scan`` (JAX: ``_linear_scan_chunked``); mamba's state
  ``(B, di, ds)`` is one scan width of ``di * ds`` channels.

The mixture of experts is JAX's ``moe_dense`` (every expert on every
token, then the top-k gate mix) or, on a rank mesh, ``moe_dispatch``
(each rank's experts on the tokens routed to them, at a capacity).
Their products are matrix products, as JAX computes them outside any
Pallas kernel.  The short
convolutions stay sums of shifted products, as in the JAX package, and
do not go through ``conv1d`` (cuDNN would run them in TF32 by default).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels.flash_attention import mask_bias as _mask_bias

__all__ = ["DEFAULT_DTYPE", "RMSNorm", "Attention", "MLP", "MoE", "RGLRU",
           "Mamba", "dense_init_", "rmsnorm", "apply_rope", "attention", "mlp",
           "moe_route", "moe_dense", "moe_dispatch", "router_aux",
           "rglru_block", "mamba_block"]

_RGLRU_C = 8.0
# JAX's DEFAULT_DTYPE: the compute type of every apply function
DEFAULT_DTYPE = torch.bfloat16


def _leaf(*shape, device, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dense_init_(w: torch.Tensor, generator: torch.Generator,
                scale: float = 1.0, in_axis: int = 0) -> None:
    """Fill ``w`` as the JAX package's ``_dense_init``: a normal truncated
    to [-2, 2], times ``scale / sqrt(fan_in)`` with ``fan_in =
    w.shape[in_axis]`` (the inverse normal CDF of a uniform draw, as
    ``trunc_normal_`` does).  A leaf of a narrower type is drawn in a
    float32 buffer of its shape and stored rounded (JAX: ``init_lm``,
    then ``astype``), so it holds the float32 draw's values rounded."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    std = scale / math.sqrt(w.shape[in_axis])
    buf = w if w.dtype == torch.float32 else torch.empty(
        w.shape, dtype=torch.float32, device=w.device)
    buf.uniform_(2.0 * lo - 1.0, 1.0 - 2.0 * lo, generator=generator)
    buf.erfinv_().mul_(math.sqrt(2.0) * std)
    buf.clamp_(-2.0 * std, 2.0 * std)
    if buf is not w:
        w.copy_(buf)


# --------------------------------------------------------------------- #
# weight containers
# --------------------------------------------------------------------- #
# Each container's ``SPECS``: its leaves' logical axes, JAX's ``init_*``
# specs (``models/sharding.py`` maps them onto a mesh).
class RMSNorm(nn.Module):
    SPECS = {"scale": (None,)}

    def __init__(self, d: int, *, device,
                 dtype=torch.float32):
        super().__init__()
        self.scale = _leaf(d, device=device, dtype=dtype)

    def init_(self, generator) -> None:
        self.scale.fill_(1.0)


class Attention(nn.Module):
    SPECS = {"wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"),
             "wv": ("fsdp", "tp"), "wo": ("tp", "fsdp"), "bq": ("tp",),
             "bk": ("tp",), "bv": ("tp",), "q_norm": (None,),
             "k_norm": (None,)}

    def __init__(self, cfg: ModelConfig, *, device,
                 dtype=torch.float32):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        h, kvh = cfg.n_heads, cfg.n_kv_heads
        self.wq = _leaf(d, h * hd, device=device, dtype=dtype)
        self.wk = _leaf(d, kvh * hd, device=device, dtype=dtype)
        self.wv = _leaf(d, kvh * hd, device=device, dtype=dtype)
        self.wo = _leaf(h * hd, d, device=device, dtype=dtype)
        if cfg.qkv_bias:
            self.bq = _leaf(h * hd, device=device, dtype=dtype)
            self.bk = _leaf(kvh * hd, device=device, dtype=dtype)
            self.bv = _leaf(kvh * hd, device=device, dtype=dtype)
        if cfg.qk_norm:
            self.q_norm = _leaf(hd, device=device, dtype=dtype)
            self.k_norm = _leaf(hd, device=device, dtype=dtype)

    def init_(self, generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)
        for name, fill in (("bq", 0.0), ("bk", 0.0), ("bv", 0.0),
                           ("q_norm", 1.0), ("k_norm", 1.0)):
            if hasattr(self, name):
                getattr(self, name).fill_(fill)


class MLP(nn.Module):
    """Gated feed-forward (``swiglu`` or gated ``gelu``)."""
    SPECS = {"wi": ("fsdp", "tp"), "wg": ("fsdp", "tp"), "wo": ("tp", "fsdp")}

    def __init__(self, d: int, f: int, *, device,
                 dtype=torch.float32):
        super().__init__()
        self.wi = _leaf(d, f, device=device, dtype=dtype)
        self.wg = _leaf(d, f, device=device, dtype=dtype)
        self.wo = _leaf(f, d, device=device, dtype=dtype)

    def init_(self, generator) -> None:
        for w in (self.wi, self.wg, self.wo):
            dense_init_(w, generator)


class MoE(nn.Module):
    """JAX's ``init_moe`` leaves: ``router (d, E)``, the experts' ``wi``,
    ``wg (E, d, f)`` and ``wo (E, f, d)``, and where the config has one,
    a ``shared`` gated MLP of ``cfg.d_ff``.  ``experts``: the slice of
    the ``E`` experts this module holds (a rank's under expert
    parallelism, ``MeshRules.expert_slice``); all of them if None."""
    SPECS = {"router": ("fsdp", None), "wi": ("tp", "fsdp", None),
             "wg": ("tp", "fsdp", None), "wo": ("tp", None, "fsdp")}

    def __init__(self, cfg: ModelConfig, *, device,
                 dtype=torch.float32, experts: Optional[slice] = None):
        super().__init__()
        d, e = cfg.d_model, cfg.moe
        self.experts = experts or slice(0, e.num_experts)
        n = len(range(e.num_experts)[self.experts])
        self.router = _leaf(d, e.num_experts, device=device, dtype=dtype)
        kw = dict(device=device, dtype=dtype)
        self.wi = _leaf(n, d, e.d_ff_expert, **kw)
        self.wg = _leaf(n, d, e.d_ff_expert, **kw)
        self.wo = _leaf(n, e.d_ff_expert, d, **kw)
        if e.shared_expert:
            self.shared = MLP(d, cfg.d_ff, device=device, dtype=dtype)

    def init_(self, generator) -> None:
        dense_init_(self.router, generator)
        n_exp = self.router.shape[1]
        for w in (self.wi, self.wg, self.wo):
            if w.shape[0] == n_exp:
                dense_init_(w, generator, in_axis=1)
                continue
            # every expert drawn, this module's kept: the weights of an
            # unsliced model from the same generator
            full = torch.empty((n_exp,) + w.shape[1:], dtype=w.dtype,
                               device=w.device)
            dense_init_(full, generator, in_axis=1)
            w.copy_(full[self.experts])
            del full


class RGLRU(nn.Module):
    SPECS = {"w_in": ("fsdp", "tp"), "w_gate": ("fsdp", "tp"),
             "conv": (None, "tp"), "lam": ("tp",), "w_ig": ("tp",),
             "w_rg": ("tp",), "w_out": ("tp", "fsdp")}

    def __init__(self, cfg: ModelConfig, *, device,
                 dtype=torch.float32):
        super().__init__()
        d, w, dc = cfg.d_model, cfg.lru_width, cfg.recurrent.d_conv
        self.w_in = _leaf(d, w, device=device, dtype=dtype)
        self.w_gate = _leaf(d, w, device=device, dtype=dtype)
        self.conv = _leaf(dc, w, device=device, dtype=dtype)
        self.lam = _leaf(w, device=device, dtype=dtype)
        self.w_ig = _leaf(w, device=device, dtype=dtype)
        self.w_rg = _leaf(w, device=device, dtype=dtype)
        self.w_out = _leaf(w, d, device=device, dtype=dtype)

    def init_(self, generator) -> None:
        dense_init_(self.w_in, generator)
        dense_init_(self.w_gate, generator)
        dense_init_(self.conv, generator, scale=0.1)
        self.lam.fill_(4.0)          # sigmoid(4) = 0.982: slow decay
        self.w_ig.fill_(0.5)
        self.w_rg.fill_(0.5)
        dense_init_(self.w_out, generator)


class Mamba(nn.Module):
    """Mamba-1 selective SSM weights (falcon-mamba), JAX's ``init_mamba``
    leaves: ``di = expand * d``, ``ds = d_state``, ``dtr = dt_rank``
    (default ``ceil(d / 16)``)."""
    SPECS = {"in_proj": ("fsdp", "tp"), "conv": (None, "tp"),
             "x_proj": ("tp", None), "dt_proj": (None, "tp"),
             "dt_bias": ("tp",), "A_log": ("tp", None), "D": ("tp",),
             "out_proj": ("tp", "fsdp")}

    def __init__(self, cfg: ModelConfig, *, device,
                 dtype=torch.float32):
        super().__init__()
        d, s = cfg.d_model, cfg.ssm
        di, ds = s.expand * d, s.d_state
        dtr = s.dt_rank or -(-d // 16)
        self.in_proj = _leaf(d, 2 * di, device=device, dtype=dtype)
        self.conv = _leaf(s.d_conv, di, device=device, dtype=dtype)
        self.x_proj = _leaf(di, dtr + 2 * ds, device=device, dtype=dtype)
        self.dt_proj = _leaf(dtr, di, device=device, dtype=dtype)
        self.dt_bias = _leaf(di, device=device, dtype=dtype)
        self.A_log = _leaf(di, ds, device=device, dtype=dtype)
        self.D = _leaf(di, device=device, dtype=dtype)
        self.out_proj = _leaf(di, d, device=device, dtype=dtype)

    def init_(self, generator) -> None:
        dense_init_(self.in_proj, generator)
        dense_init_(self.conv, generator, scale=0.1)
        dense_init_(self.x_proj, generator)
        dense_init_(self.dt_proj, generator)
        self.dt_bias.fill_(math.log(math.e - 1.0))    # softplus^-1(1)
        ds = self.A_log.shape[1]
        self.A_log.copy_(torch.log(torch.arange(
            1, ds + 1, dtype=torch.float32, device=self.A_log.device)))
        self.D.fill_(1.0)
        dense_init_(self.out_proj, generator)


# --------------------------------------------------------------------- #
# norms and rotary position embedding
# --------------------------------------------------------------------- #
def rmsnorm(p: RMSNorm, x, eps: float = 1e-6):
    """Normalised in float32, rounded back to ``x``'s type (JAX's)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p.scale).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (B, T, H, hd), positions: (B, T) or (T,).  Float32 angles; the
    rotation is formed in float32 and rounded back to ``x``'s type."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freq
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #
def _qk_head_norm(x, scale, eps: float):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _attn_naive(q, k, v, bias):
    """q: (B,T,KVH,G,hd)  k,v: (B,S,KVH,hd)  bias: (T,S) additive.  JAX's:
    float32 scores and PV sums (``preferred_element_type``: the operands
    are upcast, their products exact), the weights rounded to ``v``'s
    type before PV, the output after it."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("btkgh,bskh->bkgts", q.float(), k.float()) * scale
    w = torch.softmax(scores + bias, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", w.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _project_q(p: Attention, x, cfg: ModelConfig, dtype=DEFAULT_DTYPE):
    """Q of ``x (B, T, D)`` as ``(B, T, KVH, G, hd)``, with bias and
    qk-norm as the config has them."""
    B, T, _ = x.shape
    kvh = cfg.n_kv_heads
    q = x @ p.wq.to(dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(dtype)
    q = q.reshape(B, T, kvh, cfg.n_heads // kvh, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = _qk_head_norm(q, p.q_norm, cfg.norm_eps)
    return q


def _project_kv(p: Attention, src, cfg: ModelConfig, dtype=DEFAULT_DTYPE):
    """K and V of ``src (B, S, D)`` as ``(B, S, KVH, hd)`` each."""
    B, S, _ = src.shape
    k, v = src @ p.wk.to(dtype), src @ p.wv.to(dtype)
    if cfg.qkv_bias:
        k, v = k + p.bk.to(dtype), v + p.bv.to(dtype)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.qk_norm:
        k = _qk_head_norm(k, p.k_norm, cfg.norm_eps)
    return k, v


def _project_qkv(p: Attention, x, cfg: ModelConfig, dtype=DEFAULT_DTYPE):
    return (_project_q(p, x, cfg, dtype),) + _project_kv(p, x, cfg, dtype)


def attention(p: Attention, x, cfg: ModelConfig, *, kv=None, x_kv=None,
              positions=None, causal: bool = True,
              window: Optional[int] = None, impl: str = "flash",
              dtype=DEFAULT_DTYPE, use_rope: Optional[bool] = None):
    """Self or cross attention of ``x (B, T, D)``, JAX's ``attention``.

    ``x_kv`` (B, S, D): K and V are projected from it (cross attention
    to an encoder's output, keys at positions ``0..S-1``); ``kv``: a
    cached ``(k, v)`` pair to attend to (decode), the queries at
    ``positions``.  ``positions`` defaults to ``0..T-1``.  Rotary
    embedding applies to self attention only (``use_rope`` overrides:
    ``kv`` alone cannot tell a cached cross K/V from a self one, so
    cross attention against its cache passes False), and never to a
    cached K.  Returns ``(out, (k, v))`` so callers can build caches.
    ``impl="flash"`` with ``T > 1`` and no ``kv`` runs the flash kernel
    over positions from 0, in grad mode too (its backward is a kernel);
    ``"naive"`` materialises the scores.  The weights and a cached K/V
    are cast to ``dtype``."""
    if impl not in ("flash", "naive"):
        raise ValueError(f"impl must be 'flash' or 'naive', got {impl!r}")
    B, T, _ = x.shape
    hd, kvh = cfg.resolved_head_dim, cfg.n_kv_heads
    g = cfg.n_heads // kvh
    q = _project_q(p, x, cfg, dtype)
    # a cached K/V is attended to as it is; JAX projects x and drops it
    k, v = (tuple(t.to(dtype) for t in kv) if kv is not None else
            _project_kv(p, x if x_kv is None else x_kv, cfg, dtype))
    if positions is None:
        positions = torch.arange(T, device=x.device)
    if use_rope is None:
        use_rope = x_kv is None
    if use_rope:
        q = apply_rope(q.reshape(B, T, kvh * g, hd), positions,
                       cfg.rope_theta).reshape(B, T, kvh, g, hd)
        if kv is None:
            k = apply_rope(k, positions, cfg.rope_theta)
    if kv is not None:
        bias = _mask_bias(positions.reshape(-1),
                          torch.arange(k.shape[1], device=x.device),
                          causal=causal, window=window)
        out = _attn_naive(q, k, v, bias)
    elif impl == "flash" and T > 1:
        out = ops.flash_attention(q.reshape(B, T, kvh * g, hd), k, v,
                                  causal=causal, window=window)
    else:
        pos_k = (torch.arange(k.shape[1], device=x.device)
                 if x_kv is not None else positions)
        bias = _mask_bias(positions, pos_k, causal=causal, window=window)
        out = _attn_naive(q, k, v, bias)
    return out.reshape(B, T, cfg.n_heads * hd) @ p.wo.to(dtype), (k, v)


# --------------------------------------------------------------------- #
# feed-forward
# --------------------------------------------------------------------- #
def silu(x):
    """``jax.nn.silu``.  In float32 ``F.silu``; in a narrower type the
    primitives JAX's compiled graph rounds after, each in ``x``'s type:
    ``x * (1 / (1 + exp(-x)))`` (XLA's logistic).  ``F.silu`` rounds
    once, and a third of bfloat16 values would land a rounding away: the
    layers would no longer be held bit for bit to JAX's.  The extra
    passes cost 8% of qwen3-4b's bfloat16 prefill and 26% of
    recurrentgemma-2b's on an H100 (``tools/bf16_activation_cost.py``;
    PERF.md)."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x):
    """``jax.nn.gelu`` (the tanh form), as :func:`silu`: ``F.gelu`` in
    float32, JAX's primitives in a narrower type, its constants rounded
    to that type as JAX's weakly typed constants are."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    inner = c(math.sqrt(2.0 / math.pi)) * (x + c(0.044715) * x ** 3)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def mlp(p: MLP, x, kind: str, dtype=DEFAULT_DTYPE):
    gate = x @ p.wg.to(dtype)
    act = silu(gate) if kind == "swiglu" else gelu(gate)
    return (act * (x @ p.wi.to(dtype))) @ p.wo.to(dtype)


def moe_route(p: MoE, x, cfg: ModelConfig, dtype=DEFAULT_DTYPE):
    """The router: float32 softmax over ``x @ router`` and its top-k.
    Returns ``(probs (..., E), top_v, top_i (..., k))``."""
    probs = torch.softmax((x @ p.router.to(dtype)).float(), dim=-1)
    top_v, top_i = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, top_v, top_i


def moe_dense(p: MoE, x, cfg: ModelConfig, dtype=DEFAULT_DTYPE,
              rules=None):
    """JAX's ``moe_dense``: every expert on every token of ``x (B, S,
    D)``, mixed by the top-k gates normalised by ``max(sum, 1e-9)`` (in
    float32, rounded to ``dtype`` for the mix), plus the shared expert.
    Returns ``(out, aux)``, ``aux`` the router's load-balancing loss
    (over the global batch with ``rules``: :func:`router_aux`).

    The expert products are batched matrix products over the experts
    with the tokens broadcast, so each expert's weights are read where
    they lie (``einsum("bsd,edf->ebsf")`` would copy every expert's
    ``wi`` and ``wg`` into another layout on each call).  Holds two
    ``(E, B * S, f)`` tensors at a time: the gate's activation is formed
    in place."""
    e = cfg.moe
    if p.wi.shape[0] != e.num_experts:
        raise ValueError(f"moe_dense runs all {e.num_experts} experts; this "
                         f"module holds {p.wi.shape[0]}")
    B, S, d = x.shape
    probs, top_v, top_i = moe_route(p, x, cfg, dtype)
    gates = torch.zeros_like(probs).scatter_(-1, top_i, top_v)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    xs = x.reshape(1, B * S, d)
    up = torch.matmul(xs, p.wi.to(dtype))               # (E, B * S, f)
    act = torch.matmul(xs, p.wg.to(dtype))
    if act.dtype == torch.float32 and cfg.mlp_kind == "swiglu":
        F.silu(act, inplace=True)
    else:
        act = silu(act) if cfg.mlp_kind == "swiglu" else gelu(act)
    act.mul_(up)
    del up
    y = torch.matmul(act, p.wo.to(dtype))               # (E, B * S, d)
    del act
    out = torch.einsum("end,ne->nd", y, gates.reshape(B * S, e.num_experts)
                       .to(dtype)).reshape(B, S, d)
    if e.shared_expert:
        out = out + mlp(p.shared, x, cfg.mlp_kind, dtype)
    return out.to(x.dtype), router_aux(probs, top_i, e.num_experts, rules)


def router_aux(probs, top_i, n_exp: int, rules=None):
    """Switch-style load-balancing loss (JAX's ``_router_aux``): ``E`` times
    the sum over experts of (share of tokens whose first choice it is) x
    (mean router probability), over the global batch: with ``rules``
    each rank's means (over its ``dp`` slice; the slices are equal) are
    averaged over ``dp``, the probabilities' with a gradient that stays
    each rank's own share (``sharding.sum_forward``)."""
    onehot = F.one_hot(top_i[..., 0], n_exp).float()
    frac = onehot.reshape(-1, n_exp).mean(0)
    mean_probs = probs.reshape(-1, n_exp).mean(0)
    if rules is not None:
        from .sharding import psum_, sum_forward
        n = rules.axis_size(rules.dp)
        frac = psum_(frac, rules.mesh, rules.dp) / n
        mean_probs = sum_forward(mean_probs, rules.mesh, rules.dp) / n
    return n_exp * torch.sum(frac * mean_probs)


def moe_dispatch(p: MoE, x, cfg: ModelConfig, rules, dtype=DEFAULT_DTYPE,
                 psum_bf16: bool = False):
    """Expert-parallel MoE (JAX's ``moe_dispatch``), a rank's share.  The
    experts are split over the ``tp`` ranks (``p`` holds this rank's
    ``E / tp``, ``p.experts``); ``x (b_local, S, D)`` is this rank's
    ``dp`` slice of the batch, replicated over ``tp``, so each rank
    gathers the tokens routed to *its* experts from its own copy (no
    all-to-all), computes them at capacity ``C = min(ceil(cf * tokens *
    k / E), tokens)`` of its local tokens, scatters them back weighted by
    their gates, and one ``all_reduce`` over ``tp`` combines the ranks'
    sums (float32, or bfloat16 under ``psum_bf16``).  Each expert takes
    the tokens that chose it in token order (a ``cumsum`` rank); those
    past ``C`` are dropped.  ``E % tp != 0`` falls back to
    :func:`moe_dense` (JAX's).

    Gradients: the combine's is the identity, and ``x`` and the gates
    enter with their gradients summed over ``tp`` (``sum_forward`` /
    ``sum_backward``), so each rank's experts get their own gradient and
    every rank the whole gradient of ``x`` (Megatron's tensor-parallel
    region)."""
    from .sharding import sum_backward, sum_forward
    e = cfg.moe
    tp = rules.tp
    if len(tp) != 1:
        raise ValueError("expert parallelism expects a single tp axis")
    tp_size = rules.axis_size(tp)
    if e.num_experts % tp_size != 0:
        return moe_dense(p, x, cfg, dtype, rules=rules)
    e_per = e.num_experts // tp_size
    first = rules.index(tp) * e_per
    if (p.experts.start, p.wi.shape[0]) != (first, e_per):
        raise ValueError(
            f"this rank runs experts [{first}, {first + e_per}) of "
            f"{e.num_experts} but holds {p.wi.shape[0]} from "
            f"{p.experts.start} (build the model with "
            f"experts=rules.expert_slice(E))")
    B, S, D = x.shape
    tokens = B * S
    C = min(int(math.ceil(e.capacity_factor * tokens * e.top_k
                          / e.num_experts)), tokens)
    probs, top_v, top_i = moe_route(p, x, cfg, dtype)
    top_v = top_v / torch.clamp_min(top_v.sum(-1, keepdim=True), 1e-9)
    aux = router_aux(probs, top_i, e.num_experts, rules)

    xt = sum_backward(x.reshape(tokens, D), rules.mesh, tp).to(dtype)
    tv = sum_backward(top_v.reshape(tokens, e.top_k), rules.mesh, tp)
    ti = top_i.reshape(tokens, e.top_k)
    zero_row = xt.new_zeros(1, D)
    out = torch.zeros(tokens + 1, D, dtype=torch.float32, device=x.device)
    for le in range(e_per):
        hit = ti == first + le
        sel = hit.any(-1)
        gate = torch.where(hit, tv, 0.0).sum(-1)
        rank = torch.cumsum(sel, 0) - 1
        keep = sel & (rank < C)
        # slot -> token (``tokens`` where a slot stays empty, a zero row);
        # the dropped tokens all land in slot C, which is cut off
        slot = torch.where(keep, rank, C)
        src = torch.full((C + 1,), tokens, dtype=torch.long,
                         device=x.device).scatter_(
            0, slot, torch.arange(tokens, device=x.device))[:C]
        xe = torch.cat([xt, zero_row])[src]                   # (C, D)
        up = xe @ p.wi[le].to(dtype)
        act = xe @ p.wg[le].to(dtype)
        act = silu(act) if cfg.mlp_kind == "swiglu" else gelu(act)
        ye = (act * up) @ p.wo[le].to(dtype)                  # (C, D)
        g = torch.cat([gate, gate.new_zeros(1)])[src]
        out.index_add_(0, src, ye.float() * g[:, None])
    out = out[:tokens]
    if psum_bf16:
        # the local sums stay float32; only the combine is bfloat16 (each
        # token adds <= top_k terms: one rounding an expert term)
        out = sum_forward(out.to(torch.bfloat16), rules.mesh, tp)
    else:
        out = sum_forward(out, rules.mesh, tp)
    y = out.reshape(B, S, D).to(x.dtype)
    if e.shared_expert:
        y = y + mlp(p.shared, x, cfg.mlp_kind, dtype)
    return y, aux


# --------------------------------------------------------------------- #
# RG-LRU recurrent block (recurrentgemma / Griffin)
# --------------------------------------------------------------------- #
def _rglru_coeffs(p: RGLRU, xc):
    """a_t, b_t of h_t = a_t h + b_t from the conv output xc (B, T, W), in
    float32."""
    xf = xc.float()
    r = torch.sigmoid(xf * p.w_rg)
    i = torch.sigmoid(xf * p.w_ig)
    log_a = -_RGLRU_C * F.softplus(p.lam) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (i * xf)
    return a, b


def rglru_block(p: RGLRU, x, cfg: ModelConfig, *, state=None,
                dtype=DEFAULT_DTYPE):
    """Returns ``(out, (conv_state, h_last))``; ``state`` is
    ``(conv_state (B, d_conv-1, W), h (B, W))`` for decode (``conv`` in
    ``dtype``, ``h`` float32, as JAX's cache)."""
    B, T, _ = x.shape
    w, dc = cfg.lru_width, cfg.recurrent.d_conv
    xb = x @ p.w_in.to(dtype)
    gate = x @ p.w_gate.to(dtype)
    conv_w = p.conv.to(dtype)
    if state is None:
        conv_state = torch.zeros(B, dc - 1, w, dtype=dtype, device=x.device)
        h0 = torch.zeros(B, w, dtype=torch.float32, device=x.device)
    else:
        conv_state, h0 = state
    xpad = torch.cat([conv_state, xb], dim=1)
    xc = sum(xpad[:, i:i + T, :] * conv_w[i] for i in range(dc))
    # a copy: a view would keep the whole (B, T + dc - 1, W) buffer alive
    new_conv_state = xpad[:, -(dc - 1):, :].clone() if dc > 1 else conv_state
    a, b = _rglru_coeffs(p, xc)
    if T == 1:
        h_last = a[:, 0] * h0 + b[:, 0]
        h_seq = h_last[:, None, :]
    else:
        h_seq, h_last = ops.lru_scan(a, b, h0)
    out = (h_seq.to(dtype) * gelu(gate)) @ p.w_out.to(dtype)
    return out, (new_conv_state, h_last)


# --------------------------------------------------------------------- #
# Mamba-1 selective SSM block (falcon-mamba)
# --------------------------------------------------------------------- #
def mamba_block(p: Mamba, x, cfg: ModelConfig, *, state=None,
                dtype=DEFAULT_DTYPE):
    """Returns ``(out, (conv_state, h_last))``; ``state`` is
    ``(conv_state (B, d_conv-1, di), h (B, di, ds))`` for decode
    (``conv`` in ``dtype``, ``h`` float32).

    A prefill holds a few ``(B, T, di, ds)`` float32 tensors at once
    (``a``, ``bx``, ``h_seq``); each is dropped as soon as the next step
    no longer reads it, so a layer's peak is about three of them."""
    B, T, _ = x.shape
    s = cfg.ssm
    di, ds = s.expand * cfg.d_model, s.d_state
    xb, z = (x @ p.in_proj.to(dtype)).chunk(2, dim=-1)   # (B, T, di) each
    conv_w = p.conv.to(dtype)
    if state is None:
        conv_state = torch.zeros(B, s.d_conv - 1, di, dtype=dtype,
                                 device=x.device)
        h0 = torch.zeros(B, di, ds, dtype=torch.float32, device=x.device)
    else:
        conv_state, h0 = state
    xpad = torch.cat([conv_state, xb], dim=1)
    xc = sum(xpad[:, i:i + T, :] * conv_w[i] for i in range(s.d_conv))
    new_conv_state = xpad[:, -(s.d_conv - 1):, :].clone()
    del xpad, xb
    xc = silu(xc)

    proj = xc @ p.x_proj.to(dtype)                      # (B, T, dtr + 2 ds)
    dtr = p.dt_proj.shape[0]
    dt, Bc, Cc = proj.split([dtr, ds, ds], dim=-1)
    delta = F.softplus((dt @ p.dt_proj.to(dtype)).float() + p.dt_bias)
    A = -torch.exp(p.A_log)                             # (di, ds)
    a = torch.exp_(delta[..., None] * A)                # (B, T, di, ds)
    xf, Bc, Cc = xc.float(), Bc.float(), Cc.float()
    bx = (delta * xf)[..., None] * Bc[:, :, None, :]    # (B, T, di, ds)
    del delta
    if T == 1:
        h = a[:, 0] * h0 + bx[:, 0]
        y = torch.einsum("bds,bs->bd", h, Cc[:, 0])[:, None]
        h_last = h
    else:
        h_seq, h_last = ops.lru_scan(a.view(B, T, di * ds),
                                     bx.view(B, T, di * ds),
                                     h0.reshape(B, di * ds))
        del a, bx
        # the contraction over ds as a batched product: no copy of h_seq
        y = torch.matmul(h_seq.view(B, T, di, ds), Cc[..., None])[..., 0]
        del h_seq
        h_last = h_last.view(B, di, ds)
    y = y + xf * p.D
    out = (y.to(dtype) * silu(z)) @ p.out_proj.to(dtype)
    return out, (new_conv_state, h_last)
