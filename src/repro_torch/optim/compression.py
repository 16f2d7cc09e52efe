"""Int8 gradient quantisation with error feedback.

The port of the JAX package's ``optim/compression.py`` up to its
data-parallel reduction: ``EFState``, ``ef_init``, ``quantize_int8``
and ``dequantize_int8``.  ``compressed_psum`` (the int8 all-reduce over
the data axis, with the quantisation residual fed back into the next
step) needs data-parallel training over several cards and waits for the
mesh slice (ROADMAP Queue A).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

__all__ = ["EFState", "ef_init", "quantize_int8", "dequantize_int8"]


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
