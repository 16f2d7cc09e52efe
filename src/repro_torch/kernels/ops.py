"""Entry points through the kernels, the port of the JAX package's
``kernels/ops.py``.

``price_notc_kernel`` prices the appendix American put or call with a
host loop over rounds, one ``lattice_round`` (``levels`` steps, one HBM
round trip per block) per round.  ``flash_attention`` and ``lru_scan``
are the language model's two kernels: the model layers call them here,
where the JAX model calls their references (``_attn_flash``,
``_linear_scan_chunked``).
"""
from __future__ import annotations

import math

import torch

from ..core import platform as plat
from ..core.device import resolve_device
from ..core.lattice import LatticeModel
from . import flash_attention as _fa
from . import lru_scan as _ls
from .binomial_step import DEFAULT_BLOCK, lattice_round

__all__ = ["price_notc_kernel", "flash_attention", "lru_scan"]


def price_notc_kernel(model: LatticeModel, strike: float, *,
                      kind: str = "put", levels: int = 64,
                      block: int = DEFAULT_BLOCK, device="cuda",
                      dtype=None) -> float:
    """Price through the blocked lattice kernel (plain version on CPU).

    ``dtype=None`` resolves from the platform policy of the device
    (``core/platform.py``), as the JAX package's ``price_notc_kernel``
    resolves it from its platform: float32 on ``cuda``, float64 on
    ``cpu``.  ``u``, ``r``, ``p_up``, the leaves and the scalars are
    computed in that dtype, as JAX's ``_price_notc_impl`` computes them.
    In float32 the spots overflow where ``sigma sqrt(dt) N`` passes 88.7
    (``PAPER_NOTC``: 103.9): a put stays finite there, a call is inf in
    both packages."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = plat.default_dtype("gpu" if dev.type == "cuda" else "cpu")
    t = lambda x: torch.tensor(float(x), dtype=dtype, device=dev)
    n = model.n_steps
    s0, sigma, rate, mat, k = (t(x) for x in (model.s0, model.sigma,
                                              model.rate, model.maturity,
                                              strike))
    dt = mat / n
    u = torch.exp(sigma * torch.sqrt(dt))
    r = torch.exp(rate * dt)
    p_up = (r - 1.0 / u) / (u - 1.0 / u)
    sig = sigma * torch.sqrt(dt)
    P = -(-(n + 1) // block) * block
    idx = torch.arange(P, dtype=dtype, device=dev)
    s_leaf = s0 * torch.exp((2.0 * idx - n) * sig)
    pay = k - s_leaf if kind == "put" else s_leaf - k
    v = torch.clamp_min(pay, 0.0)[None]
    scalars = torch.stack([t(n), p_up, 1.0 / r, k, s0, sig])[None]
    for rr in range(math.ceil(n / levels)):
        scalars[0, 0] = float(n - rr * levels)
        v = lattice_round(v, scalars, levels=levels, block=block, kind=kind)
    return float(v[0, 0])


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Causal/windowed GQA flash attention over positions from 0.

    q: (B, T, H, hd);  k, v: (B, S, KVH, hd), float32 or bfloat16 (the
    kernel's instance of that type);  returns (B, T, H, hd) in their type.
    """
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def lru_scan(a, b, h0):
    """Linear recurrence h_t = a_t h_{t-1} + b_t along T.

    a, b: (B, T, W); h0: (B, W); returns (h_seq (B, T, W), h_last (B, W)).
    """
    return _ls.lru_scan(a, b, h0)
