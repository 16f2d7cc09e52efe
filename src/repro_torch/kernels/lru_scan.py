"""Linear recurrence ``h_t = a_t * h_{t-1} + b_t`` on the card, and its
gradient.

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

``lru_scan`` is a ``torch.autograd.Function``: its backward is the
reverse recurrence (``lru_scan_backward``), the kernel
``lru_scan_backward_launch`` of the same source on a CUDA tensor and
``lru_scan_backward_plain`` on a CPU tensor, again bit for bit alike.
JAX has no backward kernel: it differentiates ``_linear_scan_chunked``.
The forward saves ``a``, ``h0`` and ``h_seq``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["lru_scan", "lru_scan_plain", "lru_scan_backward",
           "lru_scan_backward_plain", "LAUNCHES"]

# kernel launches, forward and backward apart (never bumped by the plain
# versions)
LAUNCHES = {"lru_scan": 0, "lru_scan_backward": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"lru_scan_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
               "lru_scan_backward_launch": [_P] * 8 + [_I, _I, _I, _P]}


def lru_scan_plain(a, b, h0):
    """Plain PyTorch version: the sequential recurrence over ``T``."""
    h = h0
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, h


def lru_scan_backward_plain(a, h0, h_seq, dh_seq, dh_last):
    """Plain PyTorch version of the gradient: with ``g_t = dL/dh_t``,
    ``g_t = dh_seq_t + a_{t+1} g_{t+1}`` (``dh_last`` in place of the
    carry at ``t = T-1``), ``db_t = g_t``, ``da_t = g_t h_{t-1}`` (``h0``
    at ``t = 0``), ``dh0 = a_0 g_0``.  Returns ``(da, db, dh0)``."""
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    c = dh_last
    for t in range(a.shape[1] - 1, -1, -1):
        g = dh_seq[:, t] + c
        db[:, t] = g
        da[:, t] = g * (h_seq[:, t - 1] if t > 0 else h0)
        c = a[:, t] * g
    return da, db, c


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


def _launch_backward(a, h0, h_seq, dh_seq, dh_last):
    if not all(x.is_contiguous() for x in (a, h0, h_seq, dh_seq, dh_last)):
        raise ValueError("the lru_scan backward kernel takes contiguous "
                         "tensors")
    lib = _build.load("lru_scan", _SIGNATURES)
    B, T, W = a.shape
    da, db, dh0 = torch.empty_like(a), torch.empty_like(a), \
        torch.empty_like(h0)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.lru_scan_backward_launch(
        a.data_ptr(), h0.data_ptr(), h_seq.data_ptr(), dh_seq.data_ptr(),
        dh_last.data_ptr(), da.data_ptr(), db.data_ptr(), dh0.data_ptr(), B,
        T, W, stream)
    _build.check(err, "lru_scan_backward_launch")
    return da, db, dh0


def _forward(a, b, h0):
    if a.device.type == "cuda":
        out = _launch(a, b, h0)
        LAUNCHES["lru_scan"] += 1
        return out
    if a.device.type == "cpu":
        return lru_scan_plain(a, b, h0)
    raise ValueError(f"unsupported device {a.device}")


def lru_scan_backward(a, h0, h_seq, dh_seq, dh_last):
    """``(da, db, dh0)`` of the scan that gave ``h_seq`` from ``a`` and
    ``h0``, for the output gradients ``dh_seq (B, T, W)`` and ``dh_last
    (B, W)``: the kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    _check(a, h_seq, h0)
    if dh_seq.shape != a.shape or dh_last.shape != h0.shape:
        raise ValueError(f"dh_seq {tuple(dh_seq.shape)} and dh_last "
                         f"{tuple(dh_last.shape)} do not fit a "
                         f"{tuple(a.shape)}")
    if a.device.type == "cuda":
        out = _launch_backward(a, h0, h_seq, dh_seq, dh_last)
        LAUNCHES["lru_scan_backward"] += 1
        return out
    if a.device.type == "cpu":
        return lru_scan_backward_plain(a, h0, h_seq, dh_seq, dh_last)
    raise ValueError(f"unsupported device {a.device}")


class _LRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        h_seq, h_last = _forward(a, b, h0)
        ctx.save_for_backward(a, h0, h_seq)
        return h_seq, h_last

    @staticmethod
    def backward(ctx, dh_seq, dh_last):
        a, h0, h_seq = ctx.saved_tensors
        # autograd hands None for an output that took no part in the loss,
        # and may hand expanded or strided gradients: the kernel wants
        # dense ones
        dh_seq = (torch.zeros_like(h_seq) if dh_seq is None
                  else dh_seq.contiguous())
        dh_last = (torch.zeros_like(h0) if dh_last is None
                   else dh_last.contiguous())
        da, db, dh0 = lru_scan_backward(a, h0, h_seq, dh_seq, dh_last)
        return da, db, dh0 if ctx.needs_input_grad[2] else None


def lru_scan(a, b, h0):
    """``(h_seq, h_last)`` of ``h_t = a_t * h_{t-1} + b_t``: the kernel on
    a CUDA tensor, the plain version on a CPU tensor; differentiable in
    ``a``, ``b`` and ``h0`` through ``lru_scan_backward``."""
    _check(a, b, h0)
    return _LRUScan.apply(a, b, h0)
