"""Device and dtype policy of the port.

``cuda`` runs the hand-written kernels, ``cpu`` runs their plain
PyTorch versions (the path the CPU tests take).  The engines that the
JAX package holds at float64 (the scenario grids, ``price_flat``, the
service) compute in ``DEFAULT_DTYPE``; where JAX takes its dtype from
its platform policy, the port does too (``core/platform.py``).  Asking
for ``cuda`` where no card is present raises: there is no quiet CPU
fallback.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DTYPE", "resolve_device"]

DEFAULT_DTYPE = torch.float64


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it is unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' for the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev

