"""Port parity: the encoder-decoder arch (seamless-m4t-medium) serving,
reduced, on the CPU.

The reduced config keeps the family: 2 encoder and 2 decoder layers,
the ``audio_stub`` frontend (frame embeddings in), tanh-gelu MLPs, 4
query heads over 2 KV heads, head_dim 16.  The encoder reads ``S_ENC =
48`` frames and the decoder ``S = 32`` tokens, so the cross attention
has ``T != S``.  Held to the JAX package: ``attention`` with ``x_kv``
(cross) and with a cached ``kv`` (decode, no rotary embedding), at
ragged ``T != S`` both ways; the prefill's last logits, KV cache and
cross cache ``xk``/``xv``; four greedy decode steps and
``LMEngine.generate``'s tokens, with the port's attention both
``flash`` (its plain version here) and ``naive``.  The JAX references
come from its engine's own compiled prefill and decode, one compile of
each (``tests/_torch_lm_ref.py``).

Tolerance 2e-5 absolute, as ``tests/test_torch_lm.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL

import _torch_lm_ref as R
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.convert import layer_trees
from repro_torch.launch import serve as port_serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCH = "seamless-m4t-medium"
IMPLS = ("flash", "naive")


@pytest.fixture(scope="module")
def ref():
    return R.reference(ARCH)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("T_,S_", [(20, 37), (37, 20)])
def test_cross_attention_matches_jax(ref, impl, T_, S_):
    """A decoder layer's cross attention: K/V projected from ``x_kv``
    without rotary embedding, every key live; then the same queries one
    at a time against the cached K/V (``kv=``, ``use_rope=False``), as
    decode runs them."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    jp = jax.tree.map(jnp.asarray, layer_trees(ref["params"], cfg)[0]["cross"])
    port = ref["model"].blocks[0].cross
    rng = np.random.default_rng(T_)
    x = rng.standard_normal((R.B, T_, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((R.B, S_, cfg.d_model)).astype(np.float32)
    want, (wk, wv) = JL.attention(jp, jnp.asarray(x), jcfg,
                                  x_kv=jnp.asarray(enc), causal=False,
                                  dtype=jnp.float32)
    got, (k, v) = L.attention(port, torch.tensor(x), cfg,
                              x_kv=torch.tensor(enc), causal=False, impl=impl,
                              dtype=torch.float32)
    assert k.shape == (R.B, S_, cfg.n_kv_heads, cfg.resolved_head_dim)
    for g, w in ((got, want), (k, wk), (v, wv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=R.TOL)
    for t in (0, T_ - 1):
        pos = jnp.full((1,), t)
        w1, _ = JL.attention(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                             kv=(wk, wv), positions=pos, causal=False,
                             dtype=jnp.float32, use_rope=False)
        g1, _ = L.attention(port, torch.tensor(x[:, t:t + 1]), cfg,
                            kv=(k, v), positions=torch.full((1,), t),
                            causal=False, impl=impl, dtype=torch.float32,
                            use_rope=False)
        np.testing.assert_allclose(g1.numpy(), np.asarray(w1), rtol=0,
                                   atol=R.TOL)
        np.testing.assert_allclose(g1.numpy(), got[:, t:t + 1].numpy(),
                                   rtol=0, atol=R.TOL)


def test_encoder_is_bidirectional_and_matches_jax(ref):
    """The encoder's output feeds every cross cache: the first layer's
    ``xk`` is ``enc_out @ wk``; a frame's change reaches earlier
    frames' outputs (no causal mask)."""
    cfg, model = ref["cfg"], ref["model"]
    run = T.RunCfg(dtype=torch.float32, impl="flash")
    enc_out = T.encode(model, R.batch_of(ref), cfg, run)
    assert enc_out.shape == (R.B, R.S_ENC, cfg.d_model)
    xk = (enc_out @ model.blocks[0].cross.wk).reshape(
        R.B, R.S_ENC, cfg.n_kv_heads, cfg.resolved_head_dim)
    np.testing.assert_allclose(xk.numpy(), ref["cache"][0]["xk"], rtol=0,
                               atol=R.TOL)
    moved = R.batch_of(ref)
    moved["enc_embeds"] = moved["enc_embeds"].clone()
    moved["enc_embeds"][:, -1] += 1.0
    other = T.encode(model, moved, cfg, run)
    assert (other[:, 0] - enc_out[:, 0]).abs().max() > 1e-4


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_matches_jax_logits_kv_and_cross_cache(ref, impl):
    cache = R.check_prefill(ref, impl)
    assert [sorted(c) for c in cache] == [["k", "v", "xk", "xv"]] * len(cache)
    assert cache[0]["xk"].shape[1] == R.S_ENC != R.S


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_steps_match_jax(ref, impl):
    R.check_decode(ref, impl)


@pytest.mark.parametrize("impl", IMPLS)
def test_engine_tokens_match_jax(ref, impl):
    R.check_engine(ref, impl)


def test_decode_after_prefill_equals_longer_prefill(ref):
    R.check_decode_after_prefill(ref, "flash")


def test_config_matches_jax_and_every_leaf_converts():
    tree, model = R.check_bijection(ARCH)
    assert len(model.enc_blocks) == 2 and len(model.blocks) == 2
    assert all(hasattr(b, "cross") for b in model.blocks)
    assert not any(hasattr(b, "cross") for b in model.enc_blocks)
    assert np.array_equal(model.enc_norm.scale.numpy(),
                          tree["enc_norm"]["scale"])


def test_serve_launcher_draws_frames_and_needs_them(capsys):
    out = port_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8",
                           "--new-tokens", "3"])
    assert out.shape == (2, 3) and (0 <= out).all() and (out < 512).all()
    assert capsys.readouterr().out.count("seq ") == 2
    cfg = R.cfgs(ARCH)[0]
    model = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(KeyError, match="enc_embeds"):
        T.prefill(model, {"tokens": torch.zeros(1, 4, dtype=torch.int64)},
                  cfg, T.RunCfg(dtype=torch.float32))
