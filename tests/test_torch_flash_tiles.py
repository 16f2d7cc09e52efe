"""The arithmetic and tile walk of the ``flash_attention`` kernel, on the CPU.

``csrc/flash_attention.cu`` cannot run here, so its numerical scheme is
mirrored in plain PyTorch (``flash_attention_mirror`` in the port, which
the card holds the kernel to at the contract's 2e-6) and held here
before any card time is spent:

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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_ref
from repro.models.layers import _attn_naive, _mask_bias

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.kernels import flash_attention as TF

FLASH_TOL = 2e-5


# the kernel's arithmetic mirror lives in the port beside the plain version
tf32, split = TF.tf32, TF.split_tf32


def kernel_mirror(q, k, v, *, causal, window, split_tf32=True):
    """The mirror with each MMA rounded to nearest in float32: the same
    walk and splits as the tensor-core rounding, at a fraction of its
    cost on the CPU (the two differ by a few 1e-7)."""
    return TF.flash_attention_mirror(q, k, v, causal=causal, window=window,
                                     split=split_tf32, tensor_core=False)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("T,S,causal,window", _PLANS)
def test_tile_plan_visits_exactly_the_live_tiles(hd, T, S, causal, window,
                                                 dtype):
    """Each instance's tiles (``KERNEL_TILES``, ``KERNEL_TILES_BF16``)."""
    bq, bkv = (TF.KERNEL_TILES_BF16 if dtype == torch.bfloat16
               else TF.KERNEL_TILES)[hd]
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
                                    window=window, dtype=dtype))
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


def _mma_reference(acc, a, b, bits):
    """One MMA output element in exact rational arithmetic: the
    accumulator and the 8 products aligned to the largest one's exponent,
    each cut toward zero to ``bits`` bits below its leading bit, summed,
    and the sum cut toward zero to float32."""
    import math
    import struct
    from fractions import Fraction
    terms = [Fraction(acc)] + [Fraction(x) * Fraction(y) for x, y in zip(a, b)]
    emax = max(math.frexp(float(t))[1] for t in terms)
    ulp = Fraction(2) ** (emax - bits)
    s = sum(math.trunc(t / ulp) * ulp for t in terms)
    f = struct.unpack("f", struct.pack("f", float(s)))[0]
    if abs(Fraction(f)) > abs(s):       # rounded away from zero: step back
        f = float(np.nextafter(np.float32(f), np.float32(0.0)))
    return f


def test_tensor_core_rounding_of_one_mma():
    """The mirror's MMA (``_mma``) against an exact rational model of the
    same rule, element by element, on TF32 operands of mixed magnitudes
    and signs."""
    rng = np.random.default_rng(11)
    scale = np.exp2(rng.integers(-6, 7, (4, 8))).astype(np.float32)
    a = TF.tf32(torch.tensor(rng.standard_normal((4, 8)).astype(np.float32)
                             * scale))
    b = TF.tf32(torch.tensor(rng.standard_normal((8, 3)).astype(np.float32)))
    acc = torch.tensor(rng.standard_normal((4, 3)), dtype=torch.float32)
    got = TF._mma(acc.double(), a, b).float()
    for i in range(4):
        for j in range(3):
            want = _mma_reference(float(acc[i, j]), a[i].tolist(),
                                  b[:, j].tolist(), TF.MMA_ALIGN_BITS)
            assert float(got[i, j]) == want, (i, j)
    # the mirror with the tensor cores' rounding still holds JAX's bound
    q, k, v = _qkv(1, 150, 4, 1, 64, seed=12)
    tc = TF.flash_attention_mirror(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), causal=True, window=None)
    np.testing.assert_allclose(tc.numpy(), _jax_reference(q, k, v, True, None),
                               rtol=0, atol=FLASH_TOL)
