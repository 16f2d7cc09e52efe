"""The arithmetic and tile walk of the ``flash_attention`` kernel, on the CPU.

``csrc/flash_attention.cu`` cannot run here, so its numerical scheme is
mirrored in plain PyTorch and held to the float32 contract before any
card time is spent:

* split TF32: each operand is ``big + small``, ``big`` rounded to TF32
  as ``cvt.rna.tf32.f32`` does (to nearest, ties away from zero, 10
  stored mantissa bits) and the remainder ``small`` truncated to TF32 as
  the MMA reads it; every product is ``small*big + big*small + big*big``
  added into a float32 accumulator one MMA k-step (8 terms) at a time,
  in the kernel's order of k-steps (for S = Q K^T the dims ``4t, 4t+1``
  and then ``4t+2, 4t+3`` of each 16-wide block, each half of hd in its
  own warp, the two halves' sums added);
* the tile walk: q tiles of ``KERNEL_TILES[hd][0]`` rows, the KV tiles
  of ``kv_tile_range`` only, ragged last q and KV tiles zero-filled and
  masked, masked scores ``-1e30`` and ``m`` starting at ``-1e30``, the
  online softmax in base 2 on scores scaled by ``scale * log2(e)``.

The mirror must agree with JAX's ``flash_ref`` (``_attn_naive`` where
T is not a multiple of ``flash_ref``'s 64-row chunk) and with
``flash_attention_plain`` to 2e-5, the bound the kernel is held to on
the card, at head_dim 64, 128 and 256, one and ten query heads a KV
head, causal, windowed and bidirectional, with T not a multiple of the
tile.  The tile plan itself must visit exactly the KV tiles that hold a
live key for some row of the q tile.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_ref
from repro.models.layers import _attn_naive, _mask_bias

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.kernels import flash_attention as TF

FLASH_TOL = 2e-5
NEG = -1e30


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round float32 to 10 stored mantissa bits,
    to nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """``split``: big rounded to TF32, the remainder truncated to TF32 (the
    MMA ignores the low 13 bits of an operand)."""
    big = tf32(x)
    return big, ((x - big).contiguous().view(torch.int32)
                 & ~0x1FFF).view(torch.float32)


def mma3_steps(acc, a, b, steps, *, split_tf32=True):
    """``acc + a @ b`` in split TF32, one k-step (a list of 8 indices of
    the reduction axis) at a time, small terms first as in ``mma3``;
    ``split_tf32=False``: single-pass TF32 (big*big only)."""
    for idx in steps:
        ab, as_ = split(a[..., idx])
        bb, bs = split(b[..., idx, :])
        if split_tf32:
            acc = acc + as_ @ bb
            acc = acc + ab @ bs
        acc = acc + ab @ bb
    return acc


def qk_steps(hd: int):
    """The kernel's k-steps of S = Q K^T for each half of hd: in each
    16-wide block, step 0 takes dims 4t and 4t+1, step 1 dims 4t+2 and
    4t+3."""
    return [[[d0 + 4 * t + 2 * s + e for t in range(4) for e in (0, 1)]
             for d0 in range(h0, h0 + hd // 2, 16) for s in (0, 1)]
            for h0 in (0, hd // 2)]


def kernel_mirror(q, k, v, *, causal, window, split_tf32=True):
    """What the kernel computes, tile by tile, in plain PyTorch."""
    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    bq, bkv = TF.KERNEL_TILES[hd]
    # the softmax runs in base 2 on scores scaled by scale * log2(e)
    scale_log2 = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
                  * torch.tensor(math.log2(math.e), dtype=torch.float32))
    steps_qk = qk_steps(hd)
    steps_pv = [list(range(n, n + 8)) for n in range(0, bkv, 8)]
    out = torch.empty_like(q)
    pad = lambda x, n: torch.cat([x, x.new_zeros((n - x.shape[0],)
                                                 + x.shape[1:])])
    for b in range(B):
        for kvh in range(KVH):
            heads = slice(kvh * G, (kvh + 1) * G)
            for q0 in range(0, T, bq):
                qt = pad(q[b, q0:q0 + bq, heads], bq).transpose(0, 1)
                pq = torch.arange(q0, q0 + bq)[:, None]
                m = torch.full((G, bq), NEG)
                l = torch.zeros(G, bq)
                acc = torch.zeros(G, bq, hd)
                for j in TF.kv_tile_range(q0, T, S, hd, causal=causal,
                                          window=window):
                    k0 = j * bkv
                    kt = pad(k[b, k0:k0 + bkv, kvh], bkv)
                    vt = pad(v[b, k0:k0 + bkv, kvh], bkv)
                    # each warp of a pair sums half of hd; then the two
                    s = sum(mma3_steps(torch.zeros(G, bq, bkv), qt, kt.T,
                                       steps, split_tf32=split_tf32)
                            for steps in steps_qk)
                    pk = torch.arange(k0, k0 + bkv)[None, :]
                    live = pk < S
                    if causal:
                        live = live & (pq >= pk)
                    if window is not None:
                        live = live & (pq - pk < window)
                    s = torch.where(live, s * scale_log2, NEG)
                    m_new = torch.maximum(m, s.amax(-1))
                    corr = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new[..., None])
                    l = l * corr + p.sum(-1)
                    acc = mma3_steps(acc * corr[..., None], p, vt, steps_pv,
                                     split_tf32=split_tf32)
                    m = m_new
                o = acc / torch.clamp_min(l, 1e-30)[..., None]
                rows = min(bq, T - q0)
                out[b, q0:q0 + rows, heads] = o[:, :rows].transpose(0, 1)
    return out


def _qkv(B, T, H, KVH, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, KVH, hd)).astype(np.float32),
            rng.standard_normal((B, T, KVH, hd)).astype(np.float32))


def test_tf32_rounding_is_rna():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 3.0 ** 0.5], dtype=torch.float32)
    got = tf32(x)
    # ties (2^-11 past 1 is half of the TF32 ulp 2^-10) go away from zero
    assert got[0] == 1.0 and got[1] == 1.0 + 2.0 ** -10
    assert got[2] == 1.0 + 2.0 ** -10 and got[3] == -(1.0 + 2.0 ** -10)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    big, small = split(x)
    # big + small carries the float32 value to 2^-21 of it
    assert ((big + small - x).abs() <= x.abs() * 2.0 ** -21).all()


def _jax_reference(q, k, v, causal, window):
    """JAX's ``flash_ref`` where it takes T (a multiple of its 64-row
    chunk), else ``_attn_naive`` with the same mask."""
    B, T, H, hd = q.shape
    if T % 64 == 0:
        return np.asarray(flash_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window))
    KVH = k.shape[2]
    bias = _mask_bias(jnp.arange(T), jnp.arange(k.shape[1]), causal=causal,
                      window=window)
    out = _attn_naive(jnp.asarray(q).reshape(B, T, KVH, H // KVH, hd),
                      jnp.asarray(k), jnp.asarray(v), bias)
    return np.asarray(out).reshape(B, T, H, hd)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 10])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)],
                         ids=["causal", "window", "bidirectional"])
@pytest.mark.parametrize("T", [150, 192])
def test_split_tf32_tile_walk_holds_the_contract(hd, G, causal, window, T):
    """T = S = 150 leaves the last q tile (64 rows) and KV tile ragged,
    against ``_attn_naive``; T = S = 192 is held against ``flash_ref``."""
    q, k, v = _qkv(1, T, G, 1, hd, seed=hd + G)
    got = kernel_mirror(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                        causal=causal, window=window)
    want = _jax_reference(q, k, v, causal, window)
    plain = TF.flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                     torch.tensor(v), causal=causal,
                                     window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLASH_TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=FLASH_TOL)


# (T, S, causal, window); every query row has a live key (the kernel
# refuses T - window >= S)
_PLANS = [(T, S, c, w) for T, S in ((150, 150), (64, 200), (300, 100))
          for c, w in ((True, None), (True, 40), (False, None), (False, 70))
          if w is None or T - w < S]


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("T,S,causal,window", _PLANS)
def test_tile_plan_visits_exactly_the_live_tiles(hd, T, S, causal, window):
    bq, bkv = TF.KERNEL_TILES[hd]
    pk = np.arange(S)
    for q0 in range(0, T, bq):
        pq = np.arange(q0, min(q0 + bq, T))[:, None]
        live = np.ones((pq.shape[0], S), bool)
        if causal:
            live &= pq >= pk
        if window is not None:
            live &= pq - pk < window
        want = sorted({int(x) // bkv for x in np.nonzero(live.any(0))[0]})
        got = list(TF.kv_tile_range(q0, T, S, hd, causal=causal,
                                    window=window))
        assert got == want, (q0, got, want)


def test_single_pass_tf32_misses_the_contract():
    """Why the products are split: the same walk with one TF32 MMA a
    product (11 bits of each operand) is far outside 2e-5 at hd 256."""
    q, k, v = _qkv(1, 192, 10, 1, 256, seed=3)
    args = (torch.tensor(q), torch.tensor(k), torch.tensor(v))
    plain = TF.flash_attention_plain(*args, causal=True, window=None)
    one = kernel_mirror(*args, causal=True, window=None, split_tf32=False)
    three = kernel_mirror(*args, causal=True, window=None)
    assert (one - plain).abs().max().item() > 10 * FLASH_TOL
    assert (three - plain).abs().max().item() <= FLASH_TOL
