"""Learning-rate schedules (warmup + cosine / linear / constant).

The port of the JAX package's ``optim/schedule.py``: each schedule maps
a step (an int or an integer tensor) to the rate as a float32 0-d
tensor, computed in float32 with the JAX expressions' order.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["warmup_cosine", "constant", "warmup_linear"]


def _f32(step):
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float) -> Callable:
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable:
    def fn(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps,
                                                    1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) *
                         0.5 * (1.0 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos).to(torch.float32)
    return fn


def warmup_linear(peak_lr: float, warmup_steps: int,
                  total_steps: int) -> Callable:
    def fn(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps,
                                                    1), 0.0, 1.0)
        return torch.where(step < warmup_steps, warm,
                           peak_lr * (1.0 - t)).to(torch.float32)
    return fn
