"""Port parity: falcon-mamba-7b serving, reduced, on the CPU.

The mamba block on its own, then the whole model: the JAX package's
``init_lm(PRNGKey(0))`` weights at ``reduced_config(falcon-mamba-7b,
n_layers=2)`` (d_model 64, d_state 8) go through
``repro_torch.convert.lm_params_from_jax``; the port (``device="cpu"``,
so ``lru_scan``'s plain version runs) is held against the JAX package's
``prefill`` (last logits and every cache entry), four greedy
``decode_step`` logits and ``LMEngine.generate``'s tokens.  The JAX
engine's own compiled prefill and decode give the reference logits, so
the reference compiles once.

Tolerance 2e-5 absolute, as ``tests/test_torch_lm.py``: float32 sums in
another order (the sequential scan against JAX's associative one).
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
from repro_torch.kernels import lru_scan as LS
from repro_torch.launch import serve as port_serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.engine import LMEngine

ARCH = "falcon-mamba-7b"
TOL = 2e-5
B, S, NEW = 2, 64, 4
JRUN = JRunCfg(dtype=jnp.float32, impl="flash", attn_q_chunk=16,
               attn_kv_chunk=16, scan_chunk=16)
RUN = T.RunCfg(dtype=torch.float32, impl="flash")


def _cfgs():
    return (reduced_config(get_config(ARCH)),
            j_reduced_config(j_get_config(ARCH)))


def _margin(logits):
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


@pytest.fixture(scope="module")
def ref():
    """The JAX package's run through its engine's compiled prefill and
    decode: the prefill of S tokens, NEW greedy decode steps, and the
    engine's tokens."""
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


def _block_inputs(cfg, T_):
    """Seeded weights and inputs for one block.  The fixed leaves are
    perturbed so that each of them matters; the convolution is drawn at
    scale 1 (not 0.1) and ``dt_bias`` lowered by 3, so that ``delta`` is
    about 0.05, the state decays slowly (``a`` near 0.95) and ``h`` is of
    order 0.1-1: the carry is what the scan computes."""
    rng = np.random.default_rng(5)
    params, _ = JL.init_mamba(jax.random.PRNGKey(4), cfg)
    params = {k: np.asarray(v) + (rng.standard_normal(v.shape).astype(
        np.float32) * 0.1 if k in ("dt_bias", "A_log", "D") else 0)
        for k, v in params.items()}
    params["conv"] = params["conv"] * 10.0
    params["dt_bias"] = params["dt_bias"] - 3.0
    x = rng.standard_normal((B, T_, cfg.d_model)).astype(np.float32)
    di, ds = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
    state = (rng.standard_normal((B, cfg.ssm.d_conv - 1, di)).astype(
        np.float32), rng.standard_normal((B, di, ds)).astype(np.float32))
    return params, x, state


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["from_zero", "with_state"])
@pytest.mark.parametrize("T_", [1, 32], ids=["T1", "T32"])
def test_mamba_block_matches_jax(T_, with_state):
    """``mamba_block`` against JAX's on seeded numpy inputs: a prefill
    (T = 32, the scan) and one decode step (T = 1), from a zero state and
    from a given one."""
    cfg, jcfg = _cfgs()
    params, x, state = _block_inputs(jcfg, T_)
    jstate = tuple(map(jnp.asarray, state)) if with_state else None
    want, (wconv, wh) = JL.mamba_block(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jcfg,
        state=jstate, chunk=16, dtype=jnp.float32)
    layer = L.Mamba(cfg, device="cpu")
    assert {n: tuple(p.shape) for n, p in layer.named_parameters()} == {
        k: v.shape for k, v in params.items()}
    for name, val in params.items():
        getattr(layer, name).data.copy_(torch.tensor(val))
    tstate = tuple(map(torch.tensor, state)) if with_state else None
    got, (gconv, gh) = L.mamba_block(layer, torch.tensor(x), cfg,
                                     state=tstate, dtype=torch.float32)
    for a, b in ((got, want), (gconv, wconv), (gh, wh)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
    # once it has a carry the state is of order 0.1-1, so 2e-5 is a tight
    # hold on it (one step from zero is bx alone, about 1e-3)
    if with_state or T_ > 1:
        assert float(np.abs(np.asarray(wh)).max()) > 0.1


def test_mamba_block_runs_the_scan_on_the_flattened_width(monkeypatch):
    """A prefill hands ``lru_scan`` one ``(B, T, di * ds)`` width (as JAX
    hands ``_linear_scan_chunked``); decode does not call it."""
    cfg, _ = _cfgs()
    params, x, _ = _block_inputs(cfg, 32)
    layer = L.Mamba(cfg, device="cpu")
    for name, val in params.items():
        getattr(layer, name).data.copy_(torch.tensor(val))
    shapes = []
    orig = LS.lru_scan

    def spy(a, b, h0):
        shapes.append((tuple(a.shape), tuple(h0.shape)))
        return orig(a, b, h0)
    monkeypatch.setattr(LS, "lru_scan", spy)
    di, ds = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
    _, (_, h) = L.mamba_block(layer, torch.tensor(x), cfg,
                              dtype=torch.float32)
    assert shapes == [((B, 32, di * ds), (B, di * ds))]
    L.mamba_block(layer, torch.tensor(x[:, :1]), cfg,
                  state=(torch.zeros(B, cfg.ssm.d_conv - 1, di), h),
                  dtype=torch.float32)
    assert len(shapes) == 1


def test_prefill_matches_jax_logits_and_cache(ref, port):
    cfg, model = port
    logits, cache = T.prefill(model, {"tokens": torch.tensor(ref["toks"][:, :S])},
                              cfg, RUN, max_len=S + NEW)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=0, atol=TOL)
    assert [sorted(c) for c in cache] == [sorted(c) for c in ref["cache"]] \
        == [["conv", "h"]] * cfg.n_layers
    di = cfg.ssm.expand * cfg.d_model
    for layer, (got, want) in enumerate(zip(cache, ref["cache"])):
        # a recurrent state: its size does not follow max_len
        assert tuple(got["h"].shape) == (B, di, cfg.ssm.d_state)
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


def test_decode_after_prefill_equals_longer_prefill(port):
    """prefill(T) then decode of token T equals prefill(T + 1)'s last
    logits: the conv and SSM states carry over (the scan against the
    one-step update)."""
    cfg, model = port
    toks = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab,
                                                          (B, S + 1)))
    full, _ = T.prefill(model, {"tokens": toks}, cfg, RUN)
    _, cache = T.prefill(model, {"tokens": toks[:, :S]}, cfg, RUN,
                         max_len=S + 1)
    dec, _ = T.decode_step(model, cache, toks[:, S:], S, cfg, RUN)
    np.testing.assert_allclose(dec[:, 0].numpy(), full.numpy(), rtol=0,
                               atol=TOL)


def test_config_and_init_match_the_jax_tree():
    """The port's config equals JAX's field for field (full and reduced),
    its parameter count is JAX's, a mamba block holds no MLP and no
    second norm, and the fixed leaves start where JAX's do."""
    for red in (False, True):
        cfg, jcfg = _cfgs() if red else (get_config(ARCH), j_get_config(ARCH))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
    cfg, jcfg = _cfgs()
    jparams = jax.eval_shape(lambda k: j_init_lm(k, jcfg)[0],
                             jax.random.PRNGKey(0))
    model = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == sum(
        s.size for s in jax.tree.leaves(jparams))
    blk = model.blocks[0]
    assert {n for n, _ in blk.named_children()} == {"norm1", "mamba"}
    jm = jax.tree.map(np.asarray, JL.init_mamba(jax.random.PRNGKey(0),
                                                jcfg)[0])
    for name in ("dt_bias", "A_log", "D"):
        np.testing.assert_allclose(getattr(blk.mamba, name).numpy(),
                                   jm[name], rtol=1e-6, atol=0)
    w = blk.mamba.in_proj
    assert w.abs().max() <= 2.0 / cfg.d_model ** 0.5
    assert blk.mamba.conv.abs().max() <= 0.2 / blk.mamba.conv.shape[0] ** 0.5
    cache = T.init_cache(cfg, B, 10_000, device="cpu")
    di = cfg.ssm.expand * cfg.d_model
    assert [tuple(c["h"].shape) for c in cache] == \
        [(B, di, cfg.ssm.d_state)] * cfg.n_layers


def test_serve_launcher_prints_tokens(capsys):
    out = port_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8",
                           "--new-tokens", "3"])
    assert out.shape == (2, 3) and (0 <= out).all() and (out < 512).all()
    text = capsys.readouterr().out
    assert text.count("seq ") == 2 and "tokens in" in text
