"""GQA flash attention (causal or not, optionally sliding-window) on the card.

Port of the JAX package's ``kernels/flash_attention.py`` (Pallas kernel
``_fa_kernel``): ``q (B, T, H, hd)``, ``k, v (B, S, KVH, hd)``, float32
or bfloat16, give ``(B, T, H, hd)`` in their type; query head ``h``
reads KV head ``h // (H / KVH)``.
Positions start at 0 for queries and keys alike (a prefill); a key is
live for a query if ``pos_q >= pos_k`` (``causal``) and
``pos_q - pos_k < window`` (``window`` not None).

On a CUDA tensor the wrapper launches ``csrc/flash_attention.cu``: split
TF32 products on the tensor cores, K and V streamed through a cp.async
ring, instances for head_dim 64, 128 and 256, causal or not.  A smaller
head dim is zero-padded to the next instance (:func:`instance_head_dim`)
and run with its own scale ``1/sqrt(hd)``: the zero columns add exact
zeros to the float32 sums, so the result is an ``hd``-wide kernel's, and
the output is sliced back; above 256 it raises.  The kernel's tiles
(``KERNEL_TILES``) and the KV tiles it walks for a q tile
(:func:`kv_tile_range`) are written out here as well, so
that the CPU tests can hold its schedule.  On a CPU tensor the wrapper
runs the plain version below: the online-softmax loop of the JAX
package's ``models/layers.py::_attn_flash`` written out in PyTorch
(float32 ``m``, ``l``, ``acc``, masks built per chunk).

Two plain versions, two bounds.  ``flash_attention_plain`` sums in
another order than the kernel and reads every operand in full float32:
the kernel is held to it at 2e-5, the bound of the JAX package's own
kernel test.  ``flash_attention_mirror`` repeats the kernel's arithmetic
(split TF32 with the MMA's truncated small part and no small*small term,
each MMA's alignment and truncation as the tensor cores do them, its
tile walk, its k-step order, the base-2 softmax): the kernel is held to it at the float32 contract's
2e-6 (``kernels/contracts.py``), the bound between two lowerings of one
algorithm.

The bfloat16 instance (``flash_attention_launch_bf16`` in
``csrc/flash_attention_bf16.cu``) computes what ``_fa_kernel`` and
``_attn_flash`` compute for bfloat16 inputs: float32 scores, ``m``,
``l`` and PV sums, ``p`` rounded to bfloat16 for PV while ``l`` sums the
unrounded ``p``, the output rounded to bfloat16.  Its products are
single bfloat16 ``wgmma`` k-steps of 16 (K and V through TMA, a producer
warpgroup and two consumer warpgroups of 64 rows in ping-pong, one
persistent block an SM), its tiles ``KERNEL_TILES_BF16``.  The plain version takes bfloat16 inputs
with the same rounding (``flash_attention_plain``), and so does the
mirror, which follows the kernel's tiles, k-steps and base-2 softmax and
gives, beside its output, the slack that bounds the kernel's distance
from it (``mirror_bound_bf16``).  Its bounds stand beside the wrapper:
``BF16_PLAIN_TOL`` (JAX's own bfloat16 kernel test) and the mirror's
derived bound; the registry (``kernels/contracts.py``) keeps JAX's
float32-only entry.

``flash_attention`` is a ``torch.autograd.Function`` where an input
requires grad: the forward also returns each row's log-sum-exp of its
scaled live scores (``lse``, natural log, float32, ``(B, H, T)``), which
both kernels write on request, and saves ``q, k, v, out, lse``.  The
backward is FlashAttention-2's three passes, no atomics (``D =
rowsum(dO O)``, dK and dV a KV tile at a time over the G query heads of
its KV head, dQ a q tile at a time), S and dP formed once per (key tile,
q tile) pair in each walk: ``csrc/flash_attention_bwd.cu`` for float32
(split TF32 on ``mma.sync``, the other side's tiles through a
``cp.async`` ring in pre-split TF32 planes) and
``csrc/flash_attention_bwd_bf16.cu`` for bfloat16 (``wgmma`` fed by TMA,
a producer and two consumer warpgroups).  On a
CUDA tensor it is counted under ``LAUNCHES["flash_attention_backward"]``
or ``["flash_attention_backward.bfloat16"]``; on a CPU tensor it is
:func:`flash_attention_backward_plain`.  Each walk's tiles are
``BWD_TILES``.  No TPU kernel stands behind it: JAX differentiates
``models/layers.py::_attn_flash``.
Like ``lru_scan_backward`` it has no entry in ``kernels/contracts.py``
(JAX's registry has none); its bounds stand beside it
(``BWD_F32_TOL``, ``BWD_BF16_TOL``).
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_with_lse", "flash_attention_backward",
           "flash_attention_backward_plain",
           "flash_attention_mirror", "mirror_bound_bf16", "bf16_ulp",
           "mask_bias", "kv_tile_range", "q_tile_range", "instance_head_dim",
           "tf32", "split_tf32", "mma3_steps", "qk_steps", "LAUNCHES",
           "KERNEL_HEAD_DIMS", "KERNEL_TILES", "KERNEL_TILES_BF16",
           "BWD_TILES", "BF16_PLAIN_TOL", "BWD_F32_TOL", "BWD_BF16_TOL",
           "MIRROR_REL_BF16"]

# kernel launches by instance, forward and backward apart (never bumped by
# the plain versions); a backward call is one count for its three launches
LAUNCHES = {"flash_attention": 0, "flash_attention.bfloat16": 0,
            "flash_attention_backward": 0,
            "flash_attention_backward.bfloat16": 0}
# (q rows, keys) of a tile of the kernel, per head_dim
KERNEL_TILES = {64: (64, 32), 128: (64, 32), 256: (64, 32)}
KERNEL_HEAD_DIMS = tuple(KERNEL_TILES)
# the bfloat16 instance's tiles: 128 q rows (64 a consumer warpgroup), 128
# keys but at hd 256, where O takes 128 registers a thread
KERNEL_TILES_BF16 = {64: (128, 128), 128: (128, 128), 256: (128, 64)}
# the backward's tiles per dtype and head_dim, for each walk: "dq" is (q
# rows a block, keys a step), "dkv" (keys a block, q rows a step).
# float32 (csrc/flash_attention_bwd.cu): 64 rows a block, the other side's
# tile as wide as shared memory holds beside its TF32 planes.  bfloat16
# (csrc/flash_attention_bwd_bf16.cu): a dQ block is two consumer
# warpgroups of 64 rows; a dK/dV block two of 64 keys, but one tile of 64
# keys at hd 256, where the consumers split its products
BWD_TILES = {
    torch.float32: {64: {"dq": (64, 32), "dkv": (64, 32)},
                    128: {"dq": (64, 32), "dkv": (64, 32)},
                    256: {"dq": (64, 16), "dkv": (64, 16)}},
    torch.bfloat16: {64: {"dq": (128, 128), "dkv": (128, 128)},
                     128: {"dq": (128, 64), "dkv": (128, 64)},
                     256: {"dq": (128, 32), "dkv": (64, 64)}}}
_MASK_NEG = -1e30  # finite: keeps the online softmax NaN-free
# the bfloat16 instance against its plain version: the bound of the JAX
# package's own bfloat16 kernel test (tests/test_kernels_attention.py:20)
BF16_PLAIN_TOL = 2e-2
# against its mirror (mirror_bound_bf16): the kernel and the mirror form
# the same bfloat16 products and sum them in float32 over the same tiles
# and k-steps, so before the output's rounding they differ by float32
# rounding alone: the MMA's internal accumulation and exp2's last bits,
# a few parts in 2**22 of each term.  Two consequences are bounded with a
# wide margin, at this relative size: a float32 difference of every PV
# term (the sum of p |v| / l), and a flip of p's rounding to bfloat16
# where p lies this close to a rounding boundary (one bfloat16 ulp of p,
# times |v| / l).  Rounding the output to bfloat16 adds one ulp.
MIRROR_REL_BF16 = 2.0 ** -14
# the backward kernel against its plain version taken in float64 from the
# same inputs, each gradient's max abs gap over its max |g|.  float32: the
# split-TF32 products keep about float32's precision (the dropped
# small*small term is 2**-22 of a product), the sums run over up to S keys
# or T * G queries in another order, and P is recomputed from a float32 lse
# (a relative error of |s * scale| * 2**-24 in each p); 2e-5 leaves a
# decade above that.  bfloat16: P and dS are rounded to bfloat16 (2**-9
# relative) for their products, and the gradients to bfloat16: the bound of
# JAX's own bfloat16 kernel test (tests/test_kernels_attention.py:20),
# taken relative
BWD_F32_TOL = 2e-5
BWD_BF16_TOL = 2e-2

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# q, k, v, out, lse; B, T, S, H, KVH, hd, causal, window; scale; stream
_ARGS = [_P] * 5 + [_I] * 8 + [_F, _P]
# q, k, v, out, dout, lse, delta, dq, dk, dv; the same ints; scale; stream
_BWD_ARGS = [_P] * 10 + [_I] * 8 + [_F, _P]
# the entry points of each source (csrc/<name>.cu)
_SIGNATURES = {"flash_attention": {"flash_attention_launch": _ARGS},
               "flash_attention_bf16": {"flash_attention_launch_bf16": _ARGS},
               "flash_attention_bwd": {
                   "flash_attention_backward_launch": _BWD_ARGS},
               "flash_attention_bwd_bf16": {
                   "flash_attention_backward_launch_bf16": _BWD_ARGS}}


# the source, the C entry and the launch count of each instance
_ENTRIES = {torch.float32: ("flash_attention", "flash_attention_launch",
                            "flash_attention"),
            torch.bfloat16: ("flash_attention_bf16",
                             "flash_attention_launch_bf16",
                             "flash_attention.bfloat16")}
_BWD_ENTRIES = {torch.float32: ("flash_attention_bwd",
                                "flash_attention_backward_launch",
                                "flash_attention_backward"),
                torch.bfloat16: ("flash_attention_bwd_bf16",
                                 "flash_attention_backward_launch_bf16",
                                 "flash_attention_backward.bfloat16")}


def instance_head_dim(hd: int) -> int:
    """The kernels' instance that runs head_dim ``hd``: the smallest of
    ``KERNEL_HEAD_DIMS`` that holds it (``hd`` is zero-padded to it)."""
    for n in KERNEL_HEAD_DIMS:
        if 1 <= hd <= n:
            return n
    raise ValueError(f"the flash_attention kernels take head_dim 1 to "
                     f"{KERNEL_HEAD_DIMS[-1]} (instances {KERNEL_HEAD_DIMS}, "
                     f"smaller ones zero-padded), got {hd}")


def _pad(x, n: int):
    """``x`` zero-padded along its last axis to ``n`` (``x`` itself where
    it is that wide already)."""
    return x if x.shape[-1] == n else F.pad(x, (0, n - x.shape[-1]))


def _tiles(hd: int, dtype=torch.float32):
    return (KERNEL_TILES_BF16 if dtype == torch.bfloat16
            else KERNEL_TILES)[instance_head_dim(hd)]


def kv_tile_range(q0: int, T: int, S: int, hd: int, *, causal: bool,
                  window, dtype=torch.float32, tiles=None) -> range:
    """The KV tiles that the kernel's ``dtype`` instance walks at head_dim
    ``hd`` for the q tile of rows ``q0..`` (cut at ``T``): all but those
    that the causal triangle, the window or the end of ``S`` leave
    without a live key for any of its rows.  ``tiles=(bq, bkv)`` takes
    other tiles (the backward's dQ walk: ``BWD_TILES[dtype][hd]["dq"]``)."""
    bq, bkv = tiles or _tiles(hd, dtype)
    q_last = min(q0 + bq, T) - 1
    lo = (q0 - window + 1) // bkv if window and q0 - window + 1 > 0 else 0
    hi = -(-S // bkv) - 1
    if causal:
        hi = min(hi, q_last // bkv)
    return range(lo, hi + 1)


def q_tile_range(k0: int, T: int, S: int, hd: int, *, causal: bool,
                 window, dtype=torch.float32) -> range:
    """The q tiles that the backward's dK/dV walk takes for the KV tile of
    keys ``k0..`` (``BWD_TILES[dtype][hd]["dkv"]``, cut at ``S``): all but
    those that the causal triangle, the window or the end of ``T`` leave
    without a live query for any of its keys (the transpose of
    :func:`kv_tile_range`)."""
    bk, bq = BWD_TILES[dtype][instance_head_dim(hd)]["dkv"]
    nq = -(-T // bq)
    k_last = min(k0 + bk, S) - 1
    lo = (k0 // bq if k0 <= T - 1 else nq) if causal else 0
    hi = nq - 1
    if window is not None:
        hi = min(hi, (k_last + window - 1) // bq)
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
                          q_chunk: int = 1024, kv_chunk: int = 1024,
                          return_lse: bool = False):
    """Plain PyTorch version: ``_attn_flash``'s online softmax over KV
    chunks, one q chunk at a time (a ragged last chunk is allowed).  For
    bfloat16 inputs, ``_attn_flash``'s rounding: float32 scores, ``m``,
    ``l`` and PV sums (the operands upcast: their products are exact in
    float32), ``p`` rounded to ``v``'s type for PV while ``l`` sums it
    unrounded, the output rounded to ``q``'s type.  ``return_lse``: also
    each row's ``m + log(l)``, float32 ``(B, H, T)``."""
    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, T, KVH, G, hd)
    pos_q = torch.arange(T, device=q.device)
    pos_k = torch.arange(S, device=q.device)
    out = torch.empty_like(qg)
    lse = torch.empty((B, KVH, G, T), dtype=torch.float32, device=q.device)
    for q0 in range(0, T, q_chunk):
        qi = qg[:, q0:q0 + q_chunk].float()
        cq = qi.shape[1]
        m = torch.full((B, KVH, G, cq), -math.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KVH, G, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, cq, KVH, G, hd), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, S, kv_chunk):
            kj = k[:, k0:k0 + kv_chunk].float()
            vj = v[:, k0:k0 + kv_chunk].float()
            bias = mask_bias(pos_q[q0:q0 + cq], pos_k[k0:k0 + kv_chunk],
                             causal=causal, window=window)
            s = torch.einsum("bqkgh,bskh->bkgqs", qi, kj) * scale + bias
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).float(), vj)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        out[:, q0:q0 + cq] = acc / l.permute(0, 3, 1, 2)[..., None]
        lse[..., q0:q0 + cq] = m + torch.log(l)
    out = out.reshape(B, T, H, hd)
    return (out, lse.reshape(B, H, T)) if return_lse else out


def flash_attention_backward_plain(q, k, v, out, lse, dout, *,
                                   causal: bool = True, window=None,
                                   q_chunk: int = 1024):
    """Plain PyTorch version of the gradient, in dense formulas one q
    chunk at a time: with ``P = exp(scale * Q K^T + mask - lse)`` (0 on
    masked pairs), ``dP = dO V^T``, ``D = rowsum(dO * out)`` and ``dS =
    P (dP - D)``: ``dV = P^T dO``, ``dK = scale dS^T Q``, ``dQ = scale dS
    K``, each KV head's summed over its G query heads.  It computes in
    float64 for float64 inputs, else in float32 (bfloat16 inputs upcast,
    nothing rounded between), and returns ``(dq, dk, dv)`` in ``q``'s
    type."""
    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    wt = torch.promote_types(q.dtype, torch.float32)
    dev = q.device
    qg = q.to(wt).reshape(B, T, KVH, G, hd)
    dog = dout.to(wt).reshape(B, T, KVH, G, hd)
    og = out.to(wt).reshape(B, T, KVH, G, hd)
    kf, vf = k.to(wt), v.to(wt)
    lseg = lse.to(wt).reshape(B, KVH, G, T)
    pos_q = torch.arange(T, device=dev)
    pos_k = torch.arange(S, device=dev)
    dq = torch.empty_like(qg)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0 in range(0, T, q_chunk):
        qi, doi = qg[:, q0:q0 + q_chunk], dog[:, q0:q0 + q_chunk]
        live = mask_bias(pos_q[q0:q0 + q_chunk], pos_k, causal=causal,
                         window=window) == 0
        s = torch.einsum("bqkgh,bskh->bkgqs", qi, kf) * scale
        p = torch.where(live, torch.exp(s - lseg[..., q0:q0 + q_chunk, None]),
                        0.0)
        dp = torch.einsum("bqkgh,bskh->bkgqs", doi, vf)
        d = (doi * og[:, q0:q0 + q_chunk]).sum(-1).permute(0, 2, 3, 1)
        ds = p * (dp - d[..., None])
        dv += torch.einsum("bkgqs,bqkgh->bskh", p, doi)
        dk += torch.einsum("bkgqs,bqkgh->bskh", ds, qi) * scale
        dq[:, q0:q0 + q_chunk] = torch.einsum("bkgqs,bskh->bqkgh", ds,
                                              kf) * scale
    return (dq.reshape(B, T, H, hd).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round float32 to 10 stored mantissa bits,
    to nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """The kernel's ``split``: ``big`` rounded to TF32, the remainder
    ``small`` truncated to TF32 (the MMA ignores the low 13 bits of an
    operand)."""
    big = tf32(x)
    return big, ((x - big).contiguous().view(torch.int32)
                 & ~0x1FFF).view(torch.float32)


# bits below the leading bit of an MMA's largest addend that its sum keeps
MMA_ALIGN_BITS = 26


def _toward_zero32(x: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` rounded toward zero to float32's 24 significant bits,
    kept in float64 (exact for normal float32 magnitudes)."""
    return (x.view(torch.int64) & ~0x1FFFFFFF).view(torch.float64)


def _mma(acc, a, b):
    """One ``mma.sync`` k-step as the tensor cores round it, on float64
    ``acc (..., M, N)`` holding float32 values: the 8 products of TF32
    operands (exact in float64) and the accumulator are aligned to the
    largest one's exponent, each cut toward zero to ``MMA_ALIGN_BITS``
    bits below that one's leading bit, summed, and the sum cut toward
    zero to float32."""
    prods = a.double()[..., :, :, None] * b.double()[..., None, :, :]
    e = torch.maximum(torch.frexp(acc)[1], torch.frexp(prods)[1].amax(-2))
    ulp = torch.ldexp(torch.ones_like(acc), e - MMA_ALIGN_BITS)
    cut = lambda x, u: torch.trunc(x / u) * u
    return _toward_zero32(cut(acc, ulp)
                          + cut(prods, ulp[..., None, :]).sum(-2))


def mma3_steps(acc, a, b, steps, *, split=True, tensor_core=True):
    """``acc + a @ b`` in split TF32, one k-step (a list of 8 indices of
    the reduction axis) at a time, small terms first as in ``mma3``;
    ``split=False``: single-pass TF32 (big*big only).

    ``tensor_core=True`` rounds each ``mma.sync`` as the H100's tensor
    cores do (:func:`_mma`); ``False`` forms the 8-term product in
    float32 and adds it to the accumulator, each to nearest.  The
    kernel's distance from the second follows that rounding term, not
    the dropped small*small product, the small part's 11-bit read or
    ``exp2`` (``chip_smoke.py`` prints its distance from both)."""
    if tensor_core:
        acc = acc.double()
    for idx in steps:
        ab, as_ = split_tf32(a[..., idx])
        bb, bs = split_tf32(b[..., idx, :])
        terms = ((as_, bb), (ab, bs), (ab, bb)) if split else ((ab, bb),)
        for x, y in terms:
            acc = _mma(acc, x, y) if tensor_core else acc + x @ y
    return acc.float()


def qk_steps(hd: int):
    """The kernel's k-steps of S = Q K^T for each half of hd: in each
    16-wide block, step 0 takes dims 4t and 4t+1, step 1 dims 4t+2 and
    4t+3."""
    return [[[d0 + 4 * t + 2 * s + e for t in range(4) for e in (0, 1)]
             for d0 in range(h0, h0 + hd // 2, 16) for s in (0, 1)]
            for h0 in (0, hd // 2)]


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at ``|x|`` (8 significant bits), as
    float32; at least that of the smallest normal."""
    e = torch.frexp(x.float().abs())[1]
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       torch.clamp_min(e - 8, -133))


def mirror_bound_bf16(got, want, slack):
    """The elementwise bound of the bfloat16 kernel's distance from its
    mirror: one bfloat16 ulp of the larger magnitude (the output's
    rounding) plus the mirror's ``slack`` (``MIRROR_REL_BF16``)."""
    big = torch.maximum(got.float().abs(), want.float().abs())
    return bf16_ulp(big) + slack


def _mma16(acc, a, b, tensor_core: bool):
    """``acc + a @ b`` over one k-step of 16 bfloat16 products: as the
    tensor cores round an MMA (:func:`_mma`, the 16 products in one
    alignment; a ``wgmma`` k16 step rounds as ``mma.sync``'s does: the
    card holds the wgmma kernel to this mirror within its bound), or
    summed in float32 and added to nearest."""
    if tensor_core:
        return _mma(acc.double(), a, b).float()
    return acc + a @ b


def _row_span(rows, T: int, bq: int):
    """The query rows ``r0..r1-1`` a mirror computes (all if ``rows`` is
    None); ``r0`` must start one of the kernel's q tiles."""
    r0, r1 = (0, T) if rows is None else rows
    if not (0 <= r0 < r1 <= T) or r0 % bq:
        raise ValueError(f"rows {rows} must start a {bq}-row q tile and "
                         f"lie within 0..{T}")
    return r0, r1


def _mirror_bf16(q, k, v, causal, window, tensor_core, with_slack, rows,
                 scale):
    """The bfloat16 instance's arithmetic: ``KERNEL_TILES_BF16`` tiles,
    the KV tiles of :func:`kv_tile_range`, S in k-steps of 16 dims, the
    base-2 softmax in float32, ``p`` rounded to bfloat16 (nearest even)
    for PV in k-steps of 16 keys while ``l`` sums it unrounded, ``out =
    acc / max(l, 1e-30)`` rounded to bfloat16.  With ``with_slack`` also
    the slack of :data:`MIRROR_REL_BF16`: over the PV terms, ``(sum of
    one bfloat16 ulp of p over the p within that relative distance of a
    rounding boundary, times |v|) + MIRROR_REL_BF16 * sum of p |v|``,
    over ``l``."""
    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    bq, bkv = KERNEL_TILES_BF16[hd]
    r0, r1 = _row_span(rows, T, bq)
    dev = q.device
    neg = _MASK_NEG
    rel = MIRROR_REL_BF16
    scale_log2 = (torch.tensor(scale, dtype=torch.float32)
                  * torch.tensor(math.log2(math.e), dtype=torch.float32)
                  ).to(dev)
    qg = q.float().reshape(B, T, KVH, G, hd).permute(0, 2, 3, 1, 4)
    kg, vg = k.float().permute(0, 2, 1, 3), v.float().permute(0, 2, 1, 3)

    def pad(x, n):      # zero-fill axis -2 to n rows
        return torch.cat([x, x.new_zeros(x.shape[:-2] + (n - x.shape[-2],)
                                         + x.shape[-1:])], dim=-2)

    span = qg.shape[:3] + (r1 - r0, hd)
    out = torch.empty(span, dtype=torch.bfloat16, device=dev)
    slack = torch.zeros(span, dtype=torch.float32, device=dev)
    for q0 in range(r0, r1, bq):
        qt = pad(qg[..., q0:q0 + bq, :], bq)
        pq = torch.arange(q0, q0 + bq, device=dev)[:, None]
        m = torch.full((B, KVH, G, bq), neg, device=dev)
        l = torch.zeros(B, KVH, G, bq, device=dev)
        acc = torch.zeros(B, KVH, G, bq, hd, device=dev)
        risk, absacc = torch.zeros_like(acc), torch.zeros_like(acc)
        for j in kv_tile_range(q0, T, S, hd, causal=causal, window=window,
                               dtype=torch.bfloat16):
            k0 = j * bkv
            kt = pad(kg[..., k0:k0 + bkv, :], bkv)[:, :, None]
            vt = pad(vg[..., k0:k0 + bkv, :], bkv)[:, :, None]
            st = torch.zeros(B, KVH, G, bq, bkv, device=dev)
            for d0 in range(0, hd, 16):
                st = _mma16(st, qt[..., d0:d0 + 16],
                            kt[..., d0:d0 + 16].transpose(-1, -2),
                            tensor_core)
            pk = torch.arange(k0, k0 + bkv, device=dev)[None, :]
            live = pk < S
            if causal:
                live = live & (pq >= pk)
            if window is not None:
                live = live & (pq - pk < window)
            st = torch.where(live, st * scale_log2, neg)
            m_new = torch.maximum(m, st.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(st - m_new[..., None])
            l = l * corr + p.sum(-1)
            pb = p.to(torch.bfloat16).float()
            acc = acc * corr[..., None]
            for kk in range(0, bkv, 16):
                acc = _mma16(acc, pb[..., kk:kk + 16], vt[..., kk:kk + 16, :],
                             tensor_core)
            if with_slack:
                near = ((p * (1 + rel)).to(torch.bfloat16)
                        != (p * (1 - rel)).to(torch.bfloat16))
                pu = torch.where(near, bf16_ulp(p), 0.0)
                risk = risk * corr[..., None] + pu @ vt.abs()
                absacc = absacc * corr[..., None] + p @ vt.abs()
            m = m_new
        den = torch.clamp_min(l, 1e-30)[..., None]
        n = min(bq, r1 - q0)
        out[..., q0 - r0:q0 - r0 + n, :] = (acc / den)[..., :n, :]
        slack[..., q0 - r0:q0 - r0 + n, :] = ((risk + rel * absacc)
                                              / den)[..., :n, :]
    shape = lambda x: x.permute(0, 3, 1, 2, 4).reshape(B, r1 - r0, H, hd)
    return (shape(out), shape(slack)) if with_slack else shape(out)


def flash_attention_mirror(q, k, v, *, causal: bool = True, window=None,
                           split: bool = True, tensor_core: bool = True,
                           with_slack: bool = False, rows=None):
    """The kernel's arithmetic, tile by tile, in plain PyTorch on the
    device of ``q``.  bfloat16 inputs take the bfloat16 instance's
    (:func:`_mirror_bf16`; ``split`` does not apply, ``with_slack`` also
    returns the slack of its bound); float32 inputs the float32
    instance's: q tiles of ``KERNEL_TILES[hd][0]`` rows, the KV tiles
    of :func:`kv_tile_range` only, ragged last q and KV tiles zero-filled
    and masked, masked scores ``-1e30`` and ``m`` starting at ``-1e30``,
    the online softmax in base 2 on scores scaled by ``scale * log2(e)``,
    every product in split TF32 (:func:`mma3_steps`; ``split=False``:
    single-pass TF32; ``tensor_core=False``: each MMA rounded to nearest
    in two steps, the term the kernel's distance follows), each half of
    hd summed apart and then added, as the kernel's warp pairs do.
    ``rows=(r0, r1)`` computes query rows ``r0..r1-1`` only (``r0`` at
    the start of a q tile), as the kernel computes them in the whole
    ``q``.  A head dim below an instance's is zero-padded to it
    (:func:`instance_head_dim`) with the scale of its own, as the wrapper
    runs it, and the result sliced back.  A Python loop over tiles: slow,
    for small shapes or a few rows."""
    hd = q.shape[-1]
    n = instance_head_dim(hd)
    scale = 1.0 / math.sqrt(hd)
    q, k, v = (_pad(x, n) for x in (q, k, v))
    if q.dtype == torch.bfloat16:
        got = _mirror_bf16(q, k, v, causal, window, tensor_core, with_slack,
                           rows, scale)
        return (tuple(x[..., :hd] for x in got) if with_slack
                else got[..., :hd])
    return _mirror_f32(q, k, v, causal, window, split, tensor_core, rows,
                       scale)[..., :hd]


def _mirror_f32(q, k, v, causal, window, split, tensor_core, rows, scale):
    """The float32 instance's arithmetic (:func:`flash_attention_mirror`)
    at an instance's head dim."""
    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    bq, bkv = KERNEL_TILES[hd]
    r0, r1 = _row_span(rows, T, bq)
    dev = q.device
    neg = _MASK_NEG
    scale_log2 = (torch.tensor(scale, dtype=torch.float32)
                  * torch.tensor(math.log2(math.e), dtype=torch.float32)
                  ).to(dev)
    steps_qk = qk_steps(hd)
    steps_pv = [list(range(n, n + 8)) for n in range(0, bkv, 8)]
    qg = q.reshape(B, T, KVH, G, hd).permute(0, 2, 3, 1, 4)  # B KVH G T hd
    kg, vg = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)     # B KVH S hd

    def pad(x, n):      # zero-fill axis -2 to n rows
        return torch.cat([x, x.new_zeros(x.shape[:-2] + (n - x.shape[-2],)
                                         + x.shape[-1:])], dim=-2)

    out = qg.new_empty(qg.shape[:3] + (r1 - r0, hd))
    for q0 in range(r0, r1, bq):
        qt = pad(qg[..., q0:q0 + bq, :], bq)
        pq = torch.arange(q0, q0 + bq, device=dev)[:, None]
        m = torch.full((B, KVH, G, bq), neg, device=dev)
        l = torch.zeros(B, KVH, G, bq, device=dev)
        acc = torch.zeros(B, KVH, G, bq, hd, device=dev)
        for j in kv_tile_range(q0, T, S, hd, causal=causal, window=window):
            k0 = j * bkv
            kt = pad(kg[..., k0:k0 + bkv, :], bkv)[:, :, None]
            vt = pad(vg[..., k0:k0 + bkv, :], bkv)[:, :, None]
            s = sum(mma3_steps(torch.zeros(B, KVH, G, bq, bkv, device=dev),
                               qt, kt.transpose(-1, -2), st, split=split,
                               tensor_core=tensor_core)
                    for st in steps_qk)
            pk = torch.arange(k0, k0 + bkv, device=dev)[None, :]
            live = pk < S
            if causal:
                live = live & (pq >= pk)
            if window is not None:
                live = live & (pq - pk < window)
            s = torch.where(live, s * scale_log2, neg)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = mma3_steps(acc * corr[..., None], p, vt, steps_pv,
                             split=split, tensor_core=tensor_core)
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        n = min(bq, r1 - q0)
        out[..., q0 - r0:q0 - r0 + n, :] = o[..., :n, :]
    return out.permute(0, 3, 1, 2, 4).reshape(B, r1 - r0, H, hd)


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, T, H, hd) and k, v (B, S, KVH, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2] != 0:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if q.dtype not in _ENTRIES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes float32 or bfloat16 tensors "
                        f"of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def _ready(what: str, *xs):
    for x in xs:
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"the {what} kernel takes contiguous, 16-byte "
                             f"aligned tensors")


def _launch(q, k, v, causal: bool, window, with_lse: bool = False):
    """The forward kernel: ``(out, lse or None)``, ``q``, ``k``, ``v``
    zero-padded to the instance's head dim where they are narrower."""
    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    n = instance_head_dim(hd)
    if S == 0 or (window is not None and T - window >= S):
        raise ValueError(f"the flash_attention kernel needs a live key for "
                         f"every query row (T={T}, S={S}, window={window})")
    _ready("flash_attention", q, k, v)
    q, k, v = (_pad(x, n) for x in (q, k, v))
    source, entry, _ = _ENTRIES[q.dtype]
    lib = _build.load(source, _SIGNATURES[source])
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, T, S, H, KVH, n,
        int(bool(causal)), 0 if window is None else int(window),
        1.0 / math.sqrt(hd), stream)
    _build.check(err, entry)
    return (out if n == hd else out[..., :hd].contiguous()), lse


def _launch_backward(q, k, v, out, lse, dout, causal: bool, window):
    """The backward kernel's three launches: ``(dq, dk, dv)``, the inputs
    zero-padded to the instance's head dim where they are narrower (the
    padded columns of the gradients are zeros and are sliced off)."""
    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    n = instance_head_dim(hd)
    q, k, v, out, dout = (_pad(x, n) for x in (q, k, v, out, dout))
    _ready("flash_attention backward", q, k, v, out, lse, dout)
    source, entry, _ = _BWD_ENTRIES[q.dtype]
    lib = _build.load(source, _SIGNATURES[source])
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, S, H, KVH, n, int(bool(causal)),
        0 if window is None else int(window), 1.0 / math.sqrt(hd), stream)
    _build.check(err, entry)
    if n == hd:
        return dq, dk, dv
    return tuple(x[..., :hd].contiguous() for x in (dq, dk, dv))


def _forward(q, k, v, causal: bool, window, with_lse: bool):
    if q.device.type == "cuda":
        out = _launch(q, k, v, causal, window, with_lse)
        LAUNCHES[_ENTRIES[q.dtype][2]] += 1
        return out
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window, return_lse=True)
        return flash_attention_plain(q, k, v, causal=causal,
                                     window=window), None
    raise ValueError(f"unsupported device {q.device}")


def flash_attention_with_lse(q, k, v, *, causal: bool = True, window=None):
    """``(out, lse)``: the forward as the autograd Function runs it (the
    kernel on a CUDA tensor, counted as a forward launch; the plain
    version on a CPU tensor), outside autograd."""
    _check(q, k, v, window)
    return _forward(q, k, v, causal, window, with_lse=True)


def flash_attention_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                             window=None):
    """``(dq, dk, dv)`` of ``out = flash_attention(q, k, v)`` for the
    output gradient ``dout``, from the forward's ``out`` and ``lse``: the
    backward kernel on a CUDA tensor (counted under
    ``LAUNCHES["flash_attention_backward"]`` or
    ``["flash_attention_backward.bfloat16"]``), the plain version on a
    CPU tensor."""
    _check(q, k, v, window)
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)} "
                         f"and lse {tuple(lse.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if q.device.type == "cuda":
        grads = _launch_backward(q, k, v, out, lse, dout, causal, window)
        LAUNCHES[_BWD_ENTRIES[q.dtype][2]] += 1
        return grads
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, out, lse, dout,
                                              causal=causal, window=window)
    raise ValueError(f"unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _forward(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd may hand a strided gradient: the kernel wants a dense one
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Attention over positions ``0..T-1`` (queries) and ``0..S-1`` (keys):
    the kernel's float32 or bfloat16 instance on a CUDA tensor (counted
    under ``LAUNCHES["flash_attention"]`` or
    ``["flash_attention.bfloat16"]``), the plain version on a CPU tensor.
    Where an input requires grad (in grad mode) it runs as a
    ``torch.autograd.Function``: the forward also keeps ``lse``, and the
    backward is :func:`flash_attention_backward`."""
    _check(q, k, v, window)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window, with_lse=False)[0]
