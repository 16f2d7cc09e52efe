"""Linear recurrence ``h_t = a_t * h_{t-1} + b_t`` on the card.

Port of the JAX package's ``kernels/lru_scan.py`` (Pallas kernel
``_lru_kernel``): the state update of recurrentgemma's RG-LRU blocks,
run once per RG-LRU layer in prefill.  ``a, b (B, T, W)`` and
``h0 (B, W)``, all float32, give ``(h_seq (B, T, W), h_last (B, W))``.

On a CUDA tensor the wrapper launches ``csrc/lru_scan.cu`` (one lane
per channel walks the sequence in order, its a and b streamed through a
shared-memory ring of cp.async copies); on a CPU tensor it runs the plain
version below, the sequential recurrence, which is also the
brute-force definition.  The kernel rounds as the plain version does
(no fused multiply-add), so the two agree bit for bit.  The JAX
reference (``_linear_scan_chunked``) is an associative scan and rounds
differently, within the float32 contract's 2e-6.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["lru_scan", "lru_scan_plain", "LAUNCHES"]

# kernel launches (never bumped by the plain version)
LAUNCHES = {"lru_scan": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"lru_scan_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P]}


def lru_scan_plain(a, b, h0):
    """Plain PyTorch version: the sequential recurrence over ``T``."""
    h = h0
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, h


def _check(a, b, h0):
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"need a, b of one shape (B, T, W), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"h0 must have shape {(a.shape[0], a.shape[2])}, "
                         f"got {tuple(h0.shape)}")
    if any(x.dtype != torch.float32 for x in (a, b, h0)):
        raise TypeError("lru_scan takes float32 tensors")
    if not (a.device == b.device == h0.device):
        raise ValueError("a, b and h0 must be on one device")


def _launch(a, b, h0):
    if not all(x.is_contiguous() for x in (a, b, h0)):
        raise ValueError("the lru_scan kernel takes contiguous tensors")
    lib = _build.load("lru_scan", _SIGNATURES)
    B, T, W = a.shape
    h_seq = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.lru_scan_launch(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                              h_seq.data_ptr(), h_last.data_ptr(), B, T, W,
                              stream)
    _build.check(err, "lru_scan_launch")
    return h_seq, h_last


def lru_scan(a, b, h0):
    """``(h_seq, h_last)`` of ``h_t = a_t * h_{t-1} + b_t``: the kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    _check(a, b, h0)
    if a.device.type == "cuda":
        out = _launch(a, b, h0)
        LAUNCHES["lru_scan"] += 1
        return out
    if a.device.type == "cpu":
        return lru_scan_plain(a, b, h0)
    raise ValueError(f"unsupported device {a.device}")
