"""Int8 gradient quantisation with error feedback.

The port of the JAX package's ``optim/compression.py``: ``EFState``,
``ef_init``, ``quantize_int8``, ``dequantize_int8`` and
``compressed_psum``, the int8 all-reduce over a data axis of a rank
mesh (``models/sharding.py``), JAX's explicit data-parallel mode:

    g_local -> quantize(int8, one scale a leaf shared by the ranks) -> psum
            -> dequantize -> mean

with error feedback: each rank's quantisation residual is added into its
next gradient (Karimireddy et al., 2019).  The reduction carries the
quantised values (integers up to 127 in magnitude); the data axis moves
4x fewer bytes once they travel as int8.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

__all__ = ["EFState", "ef_init", "quantize_int8", "dequantize_int8",
           "compressed_psum"]


class EFState(NamedTuple):
    residual: Any          # same structure as the gradients, float32


def ef_init(grads_like) -> EFState:
    """Zero residuals shaped as ``grads_like`` (a dict of tensors)."""
    return EFState({k: torch.zeros(g.shape, dtype=torch.float32,
                                   device=g.device)
                    for k, g in grads_like.items()})


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation.  Returns ``(q, scale)``."""
    amax = x.abs().max()
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(grads, ef: Optional[EFState], mesh, axis_name):
    """int8 + error-feedback mean over the ranks of ``axis_name`` (a name
    or a tuple of names) of ``mesh``, a rank's share of JAX's
    ``compressed_psum`` inside ``shard_map``.  ``grads``: a dict of
    tensors.  Returns ``(reduced float32 grads, new EFState)``.  For each
    leaf, in JAX's order: ``g + residual`` in float32; the ranks' largest
    ``|g|`` (``pmax``), whose ``/ 127`` is the scale every rank shares;
    ``q = clip(round(g / scale))``; the sum of the ranks' ``q`` times the
    scale, divided by the number of ranks (itself a ``psum`` of ones, as
    JAX counts it); the residual ``g - q * scale`` stays local."""
    from ..models.sharding import pmax_, psum_
    if ef is None:
        ef = ef_init(grads)
    red, res = {}, {}
    for name, g in grads.items():
        g = g.to(torch.float32) + ef.residual[name]
        amax = pmax_(g.abs().max(), mesh, axis_name)
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127)
        res[name] = g - q * scale
        n = psum_(torch.ones((), dtype=torch.float32, device=g.device), mesh,
                  axis_name)
        red[name] = psum_(q, mesh, axis_name) * scale / n
    return red, EFState(res)
