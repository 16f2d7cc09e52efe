"""Port parity: recurrentgemma-2b serving, reduced to 8 layers, on the CPU.

The JAX package's ``init_lm(PRNGKey(0))`` weights go through
``repro_torch.convert.lm_params_from_jax``; the port (``device="cpu"``,
so the kernels' plain versions run) is held against the JAX package's
``prefill`` (last logits and every cache entry), four greedy
``decode_step`` logits, and ``LMEngine.generate``'s tokens.  8 layers
are 2 pattern repetitions of (rglru, rglru, local) plus 2 remainder
layers, the shape of the full model's 26 = 8 * 3 + 2 (the reduced
default of 2 layers holds no local-attention layer); the reduced window
is 32, so a 64-token prompt exercises it.

Tolerance 2e-5 absolute: float32 sums taken in another order (matmuls,
the sequential scan against JAX's associative one).  The issue's bound
was 1e-4; the differences measured here are below 5e-6, so the test
holds the tighter bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64: the references get explicit float32)
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import layers as JL
from repro.models.transformer import RunCfg as JRunCfg
from repro.models.transformer import init_lm as j_init_lm
from repro.serve.engine import LMEngine as JLMEngine

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import layer_trees, lm_params_from_jax
from repro_torch.core import device as D
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.engine import LMEngine
from repro_torch.train.step import train_state

ARCH = "recurrentgemma-2b"
TOL = 2e-5
B, S, NEW = 2, 64, 4
JRUN = JRunCfg(dtype=jnp.float32, impl="flash", attn_q_chunk=16,
               attn_kv_chunk=16, scan_chunk=16)
RUN = T.RunCfg(dtype=torch.float32, impl="flash")


def _cfgs():
    return (reduced_config(get_config(ARCH), n_layers=8),
            j_reduced_config(j_get_config(ARCH), n_layers=8))


def _margin(logits):
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


@pytest.fixture(scope="module")
def ref():
    """The JAX package's run: prefill of S tokens, NEW greedy decode
    steps, and its engine's tokens.  The prefill and decode steps go
    through the engine's own compiled ``prefill`` and ``decode_step``
    (one compile each; run op by op they took four times as long)."""
    cfg, jcfg = _cfgs()
    params, _ = j_init_lm(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S + 1))
    eng = JLMEngine(params, jcfg, JRUN, batch=B, max_len=S + NEW)
    logits, cache = eng._prefill(params, {"tokens": jnp.asarray(
        toks[:, :S], jnp.int32)})
    out = dict(params=jax.tree.map(np.asarray, params), toks=toks,
               logits=np.asarray(logits),
               cache=layer_trees(jax.tree.map(np.asarray, cache), cfg),
               fed=[], dec_logits=[])
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    for i in range(NEW):
        out["fed"].append(np.asarray(tok))
        logits, cache = eng._decode(params, cache, tok, jnp.int32(S + i))
        out["dec_logits"].append(np.asarray(logits))
        tok = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)[:, None]
    out["engine"] = eng.generate(toks[:, :S], NEW)
    return out


@pytest.fixture(scope="module")
def port(ref):
    cfg, _ = _cfgs()
    return cfg, lm_params_from_jax(ref["params"], cfg, device="cpu")


def test_prefill_matches_jax_logits_and_cache(ref, port):
    cfg, model = port
    logits, cache = T.prefill(model, {"tokens": torch.tensor(ref["toks"][:, :S])},
                              cfg, RUN, max_len=S + NEW)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=0, atol=TOL)
    assert [sorted(c) for c in cache] == [sorted(c) for c in ref["cache"]]
    assert [sorted(c) for c in cache].count(["k", "v"]) == 2
    for layer, (got, want) in enumerate(zip(cache, ref["cache"])):
        for name in want:
            assert got[name].shape == want[name].shape, (layer, name)
            np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0,
                                       atol=TOL, err_msg=f"{layer} {name}")


def test_decode_steps_match_jax(ref, port):
    cfg, model = port
    _, cache = T.prefill(model, {"tokens": torch.tensor(ref["toks"][:, :S])},
                         cfg, RUN, max_len=S + NEW)
    for i, (fed, want) in enumerate(zip(ref["fed"], ref["dec_logits"])):
        logits, cache = T.decode_step(model, cache, torch.tensor(fed), S + i,
                                      cfg, RUN)
        assert logits.shape == want.shape
        np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=TOL,
                                   err_msg=f"step {i}")


def test_engine_tokens_match_jax(ref, port):
    """Greedy tokens are compared while the reference's top-2 margin is
    above the logits' tolerance (a closer pair may tie either way)."""
    cfg, model = port
    eng = LMEngine(model, cfg, RUN, batch=B, max_len=S + NEW)
    got = eng.generate(ref["toks"][:, :S], NEW)
    assert got.shape == ref["engine"].shape == (B, NEW)
    margins = [_margin(ref["logits"])] + [_margin(x) for x in
                                          ref["dec_logits"][:NEW - 1]]
    compared = 0
    for i, m in enumerate(margins):
        if m <= 2 * TOL:
            break
        np.testing.assert_array_equal(got[:, i], ref["engine"][:, i])
        compared += 1
    assert compared == NEW, margins
    assert set(eng.timings) == {"prefill_s", "decode_s", "decode_steps"}


def test_decode_after_prefill_equals_longer_prefill(port):
    """prefill(T) then decode of token T equals prefill(T + 1)'s last
    logits (as ``tests/test_layers.py`` holds the JAX model): the cache
    and recurrent state carry over.  Flash attention and the scan
    against naive attention and the one-step recurrence: 2e-5."""
    cfg, model = port
    toks = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab,
                                                          (B, S + 1)))
    full, _ = T.prefill(model, {"tokens": toks}, cfg, RUN)
    _, cache = T.prefill(model, {"tokens": toks[:, :S]}, cfg, RUN,
                         max_len=S + 1)
    dec, _ = T.decode_step(model, cache, toks[:, S:], S, cfg, RUN)
    np.testing.assert_allclose(dec[:, 0].numpy(), full.numpy(), rtol=0,
                               atol=TOL)


def test_configs_and_init_match_the_jax_tree():
    for red in (False, True):
        cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
        if red:
            cfg, jcfg = _cfgs()
        assert dataclasses.asdict(cfg) | {"notes": ""} == \
            dataclasses.asdict(jcfg) | {"notes": ""}
        assert cfg.param_count() == jcfg.param_count()
    assert get_config(ARCH).param_count() == 2_802_590_720
    cfg, jcfg = _cfgs()
    jparams = jax.eval_shape(lambda k: j_init_lm(k, jcfg)[0],
                             jax.random.PRNGKey(0))
    model = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == sum(
        s.size for s in jax.tree.leaves(jparams))
    assert model.embed.shape == jparams["embed"].shape
    assert model.lm_head.shape == jparams["lm_head"].shape
    for blk, tree in zip(model.blocks, layer_trees(
            jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jparams),
            cfg)):
        flat = {f"{sub}.{leaf}": a.shape for sub, d in tree.items()
                for leaf, a in d.items()}
        assert {n: tuple(p.shape) for n, p in blk.named_parameters()} == flat
    # the JAX package's initial values where they are fixed, and the
    # truncation of the random ones at 2 / sqrt(fan_in)
    rg = model.blocks[0].rglru
    assert torch.equal(rg.lam, torch.full_like(rg.lam, 4.0))
    assert torch.equal(model.blocks[2].norm1.scale,
                       torch.ones_like(model.blocks[2].norm1.scale))
    w = model.blocks[2].attn.wq
    assert w.abs().max() <= 2.0 / cfg.d_model ** 0.5
    assert 0.8 < float(w.std()) * cfg.d_model ** 0.5 < 0.96   # 0.88 truncated


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = _cfgs()
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_lm(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        port_serve.main(["--arch", ARCH, "--reduced"])
    out = port_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8",
                           "--new-tokens", "3"])
    assert out.shape == (2, 3) and (0 <= out).all() and (out < 512).all()
    assert D.resolve_device("cpu").type == "cpu"


def test_unported_paths_raise_naming_the_roadmap(tmp_path):
    """Training on a rank mesh is ported: the train launcher's
    ``--data``/``--model`` above 1 start ranks, and on ``cuda`` refuse a
    host with fewer cards than ranks; ``--moe-impl dispatch`` on one
    device runs dense, as JAX's.  What stays unported raises: ring
    attention's backward (ROADMAP).  The encoder-decoder and MoE archs
    build."""
    for arch, blocks in (("seamless-m4t-medium", 12), ("dbrx-132b", 40)):
        cfg = get_config(arch)
        assert cfg.name == arch and cfg.n_layers == blocks
        assert (cfg.n_encoder_layers > 0) == (cfg.moe is None)
    for flags, n in ((["--data", "2"], 2), (["--model", "4"], 4)):
        with pytest.raises(RuntimeError, match=f"{n} ranks on device 'cuda' "
                           f"need {n} cards"):
            port_train.main(["--arch", ARCH, "--device", "cuda"] + flags)
    out = port_train.main(["--arch", "dbrx-132b", "--reduced", "--steps", "1",
                           "--batch", "2", "--seq", "8", "--moe-impl",
                           "dispatch", "--device", "cpu", "--ckpt",
                           str(tmp_path)])
    assert np.isfinite(out["final_loss"])
    from repro_torch.models.context_parallel import ring_attention_local
    q = torch.zeros(1, 4, 1, 1, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ring_attention_local(q, q[..., 0, :], q[..., 0, :], None, "model")


def test_serve_ckpt_serves_the_trainers_checkpoint(tmp_path):
    """``launch/train.py`` writes checkpoints; ``launch/serve.py --ckpt``
    serves the newest one: its tokens are those of an engine on the
    trained weights, restored from the same checkpoint by hand, and the
    launcher's weights are not its random init."""
    cfg = reduced_config(get_config(ARCH))          # the launchers' --reduced
    out = port_train.main(["--arch", ARCH, "--reduced", "--steps", "3",
                           "--batch", "2", "--seq", "16", "--ckpt",
                           str(tmp_path), "--device", "cpu"])
    assert len(out["losses"]) == 3 and np.isfinite(out["final_loss"])
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "4"]
    got = port_serve.main(argv + ["--ckpt", str(tmp_path)])
    gen = torch.Generator().manual_seed(0)
    init = T.init_lm(cfg, gen, device="cpu")        # the launcher's draws
    prompt = torch.randint(0, cfg.vocab, (2, 8), generator=gen).numpy()
    state = train_state(T.init_lm(cfg, torch.Generator().manual_seed(1),
                                  device="cpu"))
    tree = ckpt.restore(tmp_path, like=convert.train_state_to_jax(state, cfg))
    assert int(tree.opt.step) == 3
    trained = convert.train_state_from_jax(tree, cfg, state).params
    assert not torch.equal(trained.blocks[0].rglru.w_in,
                           init.blocks[0].rglru.w_in)
    want = LMEngine(trained, cfg, T.RunCfg(dtype=torch.float32), batch=2,
                    max_len=12).generate(prompt, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("flags", [(False, False), (True, True)],
                         ids=["plain", "qk_norm+qkv_bias"])
def test_attention_layer_matches_jax(flags, impl):
    """The attention layer on its own, both implementations, with and
    without per-head qk norm and qkv bias (the full-attention archs'
    flags; their norm and bias weights drawn at random here)."""
    qk_norm, qkv_bias = flags
    cfg, jcfg = (dataclasses.replace(c, qk_norm=qk_norm, qkv_bias=qkv_bias)
                 for c in _cfgs())
    rng = np.random.default_rng(7)
    params, _ = JL.init_attention(jax.random.PRNGKey(3), jcfg)
    params = {k: np.asarray(v) + (rng.standard_normal(v.shape).astype(
        np.float32) * 0.1 if v.ndim == 1 else 0) for k, v in params.items()}
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    want, (wk, wv) = JL.attention(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jcfg,
        causal=True, window=cfg.local_window, impl=impl, dtype=jnp.float32,
        q_chunk=16, kv_chunk=16)
    layer = L.Attention(cfg, device="cpu")
    assert {n for n, _ in layer.named_parameters()} == set(params)
    for name, val in params.items():
        getattr(layer, name).data.copy_(torch.tensor(val))
    got, (gk, gv) = L.attention(layer, torch.tensor(x), cfg,
                                window=cfg.local_window, impl=impl,
                                dtype=torch.float32)
    for a, b in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)


def test_naive_prefill_matches_flash_prefill(port):
    cfg, model = port
    toks = torch.tensor(np.random.default_rng(2).integers(0, cfg.vocab,
                                                          (B, S)))
    flash, _ = T.prefill(model, {"tokens": toks}, cfg, RUN)
    naive, _ = T.prefill(model, {"tokens": toks}, cfg,
                         T.RunCfg(dtype=torch.float32, impl="naive"))
    np.testing.assert_allclose(naive.numpy(), flash.numpy(), rtol=0, atol=TOL)


def test_converter_refuses_a_tree_that_does_not_fit(ref):
    cfg, _ = _cfgs()
    params = dict(ref["params"])
    with pytest.raises(KeyError, match="encoder"):
        lm_params_from_jax(dict(params, encoder={}), cfg)
    rem0 = {k: v for k, v in params["rem0"].items() if k != "mlp"}
    with pytest.raises(KeyError, match="mlp"):
        lm_params_from_jax(dict(params, rem0=rem0), cfg)
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_jax(dict(params, embed=params["embed"][:, :8]), cfg)
