"""GQA flash attention (causal or not, optionally sliding-window) on the card.

Port of the JAX package's ``kernels/flash_attention.py`` (Pallas kernel
``_fa_kernel``): ``q (B, T, H, hd)``, ``k, v (B, S, KVH, hd)``, float32,
give ``(B, T, H, hd)``; query head ``h`` reads KV head ``h // (H / KVH)``.
Positions start at 0 for queries and keys alike (a prefill); a key is
live for a query if ``pos_q >= pos_k`` (``causal``) and
``pos_q - pos_k < window`` (``window`` not None).

On a CUDA tensor the wrapper launches ``csrc/flash_attention.cu``: split
TF32 products on the tensor cores, K and V streamed through a cp.async
ring, head_dim 64, 128 or 256, causal or not; it raises for anything
else.  The kernel's tiles (``KERNEL_TILES``) and the KV tiles it walks
for a q tile (:func:`kv_tile_range`) are written out here as well, so
that the CPU tests can hold its schedule.  On a CPU tensor the wrapper
runs the plain version below: the online-softmax loop of the JAX
package's ``models/layers.py::_attn_flash`` written out in PyTorch
(float32 ``m``, ``l``, ``acc``, masks built per chunk).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_plain", "mask_bias",
           "kv_tile_range", "LAUNCHES", "KERNEL_HEAD_DIMS", "KERNEL_TILES"]

# kernel launches (never bumped by the plain version)
LAUNCHES = {"flash_attention": 0}
# (q rows, keys) of a tile of the kernel, per head_dim
KERNEL_TILES = {64: (64, 64), 128: (64, 32), 256: (64, 32)}
KERNEL_HEAD_DIMS = tuple(KERNEL_TILES)
_MASK_NEG = -1e30  # finite: keeps the online softmax NaN-free

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                          _I, _I, _I, ctypes.c_float, _P]}


def kv_tile_range(q0: int, T: int, S: int, hd: int, *, causal: bool,
                  window) -> range:
    """The KV tiles that the kernel walks at head_dim ``hd`` for the q
    tile of rows ``q0..`` (cut at ``T``): all but those that the causal
    triangle, the window or the end of ``S`` leave without a live key
    for any of its rows."""
    bq, bkv = KERNEL_TILES[hd]
    q_last = min(q0 + bq, T) - 1
    lo = (q0 - window + 1) // bkv if window and q0 - window + 1 > 0 else 0
    hi = -(-S // bkv) - 1
    if causal:
        hi = min(hi, q_last // bkv)
    return range(lo, hi + 1)


def mask_bias(pos_q, pos_k, *, causal: bool, window, neg: float = _MASK_NEG):
    """(Tq, Tk) additive mask in float32 (0 / ``neg``)."""
    live = torch.ones(pos_q.shape[0], pos_k.shape[0], dtype=torch.bool,
                      device=pos_q.device)
    if causal:
        live &= pos_q[:, None] >= pos_k[None, :]
    if window is not None:
        live &= pos_q[:, None] - pos_k[None, :] < window
    return torch.where(live, 0.0, neg).to(torch.float32)


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None,
                          q_chunk: int = 1024, kv_chunk: int = 1024):
    """Plain PyTorch version: ``_attn_flash``'s online softmax over KV
    chunks, one q chunk at a time (a ragged last chunk is allowed)."""
    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, T, KVH, G, hd)
    pos_q = torch.arange(T, device=q.device)
    pos_k = torch.arange(S, device=q.device)
    out = torch.empty_like(qg)
    for q0 in range(0, T, q_chunk):
        qi = qg[:, q0:q0 + q_chunk]
        cq = qi.shape[1]
        m = torch.full((B, KVH, G, cq), -math.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KVH, G, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, cq, KVH, G, hd), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, S, kv_chunk):
            kj, vj = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            bias = mask_bias(pos_q[q0:q0 + cq], pos_k[k0:k0 + kv_chunk],
                             causal=causal, window=window)
            s = torch.einsum("bqkgh,bskh->bkgqs", qi, kj) * scale + bias
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskh->bqkgh", p, vj)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        out[:, q0:q0 + cq] = acc / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, T, H, hd)


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, T, H, hd) and k, v (B, S, KVH, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2] != 0:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if any(x.dtype != torch.float32 for x in (q, k, v)):
        raise TypeError("flash_attention takes float32 tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def _launch(q, k, v, causal: bool, window):
    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    if S == 0 or (window is not None and T - window >= S):
        raise ValueError(f"the flash_attention kernel needs a live key for "
                         f"every query row (T={T}, S={S}, window={window})")
    for x in (q, k, v):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("the flash_attention kernel takes contiguous, "
                             "16-byte aligned tensors")
    lib = _build.load("flash_attention", _SIGNATURES)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, S, H,
        KVH, hd, int(bool(causal)), 0 if window is None else int(window),
        1.0 / math.sqrt(hd), stream)
    _build.check(err, "flash_attention_launch")
    return out


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Attention over positions ``0..T-1`` (queries) and ``0..S-1`` (keys):
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    _check(q, k, v, window)
    if q.device.type == "cuda":
        out = _launch(q, k, v, causal, window)
        LAUNCHES["flash_attention"] += 1
        return out
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    raise ValueError(f"unsupported device {q.device}")
