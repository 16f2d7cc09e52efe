"""Port parity: the language model's two kernels, plain versions on the CPU.

``repro_torch.kernels.flash_attention`` and ``repro_torch.kernels.lru_scan``
on CPU tensors run their plain versions; they are held against the JAX
package's references on the same numpy inputs:

* flash attention against ``flash_ref`` (``_attn_flash``, the Pallas
  kernel's oracle) and ``_attn_naive``, at float32 to 2e-5, the bound
  ``tests/test_kernels_attention.py`` and ``tests/test_layers.py`` hold
  JAX's own flash to (the Pallas kernel itself no longer runs on this
  jax: ``pl.load`` is gone);
* the scan against ``lru_scan(interpret=True)`` (the Pallas kernel),
  ``lru_scan_ref`` (the chunked associative scan) and a numpy brute
  force, to 2e-6, the float32 tolerance of the kernels' lowering
  contract (``kernels/contracts.py``): the port's sequential recurrence
  and the associative scan round in a different order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_ref
from repro.kernels.lru_scan import lru_scan as j_lru_scan
from repro.kernels.lru_scan import lru_scan_ref
from repro.models.layers import _attn_naive, _mask_bias

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import lru_scan as TL
from repro_torch.kernels import ops

FLASH_TOL = 2e-5
SCAN_TOL = 2e-6


def _qkv(B, T, S, H, KVH, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KVH, hd)).astype(np.float32),
            rng.standard_normal((B, S, KVH, hd)).astype(np.float32))


def _naive(q, k, v, causal, window):
    B, T, H, hd = q.shape
    KVH = k.shape[2]
    bias = _mask_bias(jnp.arange(T), jnp.arange(k.shape[1]), causal=causal,
                      window=window)
    out = _attn_naive(jnp.asarray(q).reshape(B, T, KVH, H // KVH, hd),
                      jnp.asarray(k), jnp.asarray(v), bias)
    return np.asarray(out).reshape(B, T, H, hd)


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 32),
                                           (False, None)],
                         ids=["causal", "window", "bidirectional"])
def test_plain_flash_matches_jax(causal, window, G, hd):
    B, T, KVH = 2, 128, 2
    q, k, v = _qkv(B, T, T, KVH * G, KVH, hd, seed=G + hd)
    got = ops.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=causal, window=window)
    want_ref = np.asarray(flash_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window))
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=0, atol=FLASH_TOL)
    np.testing.assert_allclose(got.numpy(), _naive(q, k, v, causal, window),
                               rtol=0, atol=FLASH_TOL)


@pytest.mark.parametrize("T,q_chunk,kv_chunk", [(100, 32, 48), (64, 64, 16)])
def test_plain_flash_ragged_chunks_match_naive(T, q_chunk, kv_chunk):
    """Chunks that do not divide T (as the kernel's 64-row tiles do not
    divide T + 1 in the prefill-then-decode check) change nothing."""
    q, k, v = _qkv(1, T, T, 4, 1, 16, seed=T)
    got = TF.flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), causal=True, window=24,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), _naive(q, k, v, True, 24),
                               rtol=0, atol=FLASH_TOL)


def _scan_inputs(B, T, W, seed):
    rng = np.random.default_rng(seed)
    # decay factors in (0, 1), the RG-LRU regime
    a = (1.0 / (1.0 + np.exp(-2.0 * rng.standard_normal((B, T, W))))
         ).astype(np.float32)
    b = (0.5 * rng.standard_normal((B, T, W))).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return a, b, h0


def _brute(a, b, h0):
    h = h0.astype(np.float64)
    out = np.zeros(a.shape)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, h


@pytest.mark.parametrize("B,T,W,chunk", [(1, 64, 128, 16), (2, 128, 256, 32),
                                         (2, 64, 128, 64)])
def test_plain_lru_scan_matches_jax(B, T, W, chunk):
    a, b, h0 = _scan_inputs(B, T, W, seed=T + W)
    n0 = TL.LAUNCHES["lru_scan"]
    got_seq, got_last = ops.lru_scan(torch.tensor(a), torch.tensor(b),
                                     torch.tensor(h0))
    assert TL.LAUNCHES["lru_scan"] == n0       # a CPU tensor launches nothing
    ja, jb, jh = (jnp.asarray(x) for x in (a, b, h0))
    refs = [j_lru_scan(ja, jb, jh, chunk=chunk, interpret=True),
            lru_scan_ref(ja, jb, jh, chunk=chunk), _brute(a, b, h0)]
    for want_seq, want_last in refs:
        np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq),
                                   rtol=0, atol=SCAN_TOL)
        np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                                   rtol=0, atol=SCAN_TOL)


def test_wrappers_check_their_inputs():
    q, k, v = (torch.tensor(x) for x in _qkv(1, 8, 8, 4, 2, 16))
    with pytest.raises(TypeError, match="float32"):
        TF.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="fit"):
        TF.flash_attention(q, k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="window"):
        TF.flash_attention(q, k, v, window=0)
    a, b, h0 = (torch.tensor(x) for x in _scan_inputs(1, 8, 4, 0))
    with pytest.raises(ValueError, match="h0"):
        TL.lru_scan(a, b, h0[:, :2])
    with pytest.raises(TypeError, match="float32"):
        TL.lru_scan(a.double(), b.double(), h0.double())
