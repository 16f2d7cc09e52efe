"""Port parity: the dense GQA archs (qwen3-0.6b, qwen3-4b, internlm2-1.8b,
qwen2.5-14b, chameleon-34b) serving, reduced, on the CPU; and the weight
conversion of every arch of the mamba and dense families.

For each arch, the JAX package's ``init_lm(PRNGKey(0))`` weights at
``reduced_config(..., n_layers=2)`` (d_model 64, 4 query heads over 2 KV
heads, head_dim 16; qk-norm, qkv-bias and rope theta as the arch has
them) go through ``repro_torch.convert.lm_params_from_jax``; the port
(``device="cpu"``, so ``flash_attention``'s plain version runs) is held
against the JAX package's prefill (last logits and the KV cache), four
greedy decode steps and ``LMEngine.generate``'s tokens.  The JAX
references come from its engine's own compiled prefill and decode, one
compile of each an arch, made once per module.

Tolerance 2e-5 absolute, as ``tests/test_torch_lm.py``: float32 sums in
another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64: the references get explicit float32)
from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs import reduced_config as j_reduced_config
from repro.models.transformer import RunCfg as JRunCfg
from repro.models.transformer import init_lm as j_init_lm
from repro.serve.engine import LMEngine as JLMEngine

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.convert import layer_trees, lm_params_from_jax
from repro_torch.launch import serve as port_serve
from repro_torch.models import transformer as T
from repro_torch.serve.engine import LMEngine

DENSE = ("qwen3-0.6b", "qwen3-4b", "internlm2-1.8b", "qwen2.5-14b",
         "chameleon-34b")
SLICE = ("falcon-mamba-7b",) + DENSE
TOL = 2e-5
B, S, NEW = 2, 32, 4
JRUN = JRunCfg(dtype=jnp.float32, impl="flash", attn_q_chunk=16,
               attn_kv_chunk=16, scan_chunk=16)
RUN = T.RunCfg(dtype=torch.float32, impl="flash")


def _cfgs(arch):
    return (reduced_config(get_config(arch)),
            j_reduced_config(j_get_config(arch)))


def _margin(logits):
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


@pytest.fixture(scope="module")
def refs():
    """The JAX package's run of each arch, made at its first use: the
    prefill of S tokens, NEW greedy decode steps through the engine's
    compiled functions, and the engine's tokens."""
    made = {}

    def get(arch):
        if arch in made:
            return made[arch]
        cfg, jcfg = _cfgs(arch)
        params, _ = j_init_lm(jax.random.PRNGKey(0), jcfg)
        toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S + 1))
        eng = JLMEngine(params, jcfg, JRUN, batch=B, max_len=S + NEW)
        logits, cache = eng._prefill(params, {"tokens": jnp.asarray(
            toks[:, :S], jnp.int32)})
        out = dict(cfg=cfg, params=jax.tree.map(np.asarray, params),
                   toks=toks, logits=np.asarray(logits),
                   cache=layer_trees(jax.tree.map(np.asarray, cache), cfg),
                   fed=[], dec_logits=[])
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        for i in range(NEW):
            out["fed"].append(np.asarray(tok))
            logits, cache = eng._decode(params, cache, tok, jnp.int32(S + i))
            out["dec_logits"].append(np.asarray(logits))
            tok = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)[:, None]
        out["engine"] = eng.generate(toks[:, :S], NEW)
        out["model"] = lm_params_from_jax(out["params"], cfg, device="cpu")
        made[arch] = out
        return out
    return get


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_jax_logits_and_cache(refs, arch):
    ref = refs(arch)
    cfg, model = ref["cfg"], ref["model"]
    logits, cache = T.prefill(model, {"tokens": torch.tensor(ref["toks"][:, :S])},
                              cfg, RUN, max_len=S + NEW)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=0, atol=TOL)
    assert [sorted(c) for c in cache] == [sorted(c) for c in ref["cache"]] \
        == [["k", "v"]] * cfg.n_layers
    for layer, (got, want) in enumerate(zip(cache, ref["cache"])):
        for name in want:
            assert got[name].shape == want[name].shape, (layer, name)
            np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0,
                                       atol=TOL, err_msg=f"{layer} {name}")


@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match_jax(refs, arch):
    ref = refs(arch)
    cfg, model = ref["cfg"], ref["model"]
    _, cache = T.prefill(model, {"tokens": torch.tensor(ref["toks"][:, :S])},
                         cfg, RUN, max_len=S + NEW)
    for i, (fed, want) in enumerate(zip(ref["fed"], ref["dec_logits"])):
        logits, cache = T.decode_step(model, cache, torch.tensor(fed), S + i,
                                      cfg, RUN)
        assert logits.shape == want.shape
        np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=TOL,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("arch", DENSE)
def test_engine_tokens_match_jax(refs, arch):
    """Greedy tokens are compared while the reference's top-2 margin is
    above the logits' tolerance (a closer pair may tie either way)."""
    ref = refs(arch)
    cfg, model = ref["cfg"], ref["model"]
    got = LMEngine(model, cfg, RUN, batch=B, max_len=S + NEW).generate(
        ref["toks"][:, :S], NEW)
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


@pytest.mark.parametrize("arch", DENSE)
def test_decode_after_prefill_equals_longer_prefill(refs, arch):
    """prefill(T) then decode of token T equals prefill(T + 1)'s last
    logits: the flash path's ragged last chunk against naive decode
    attention over the KV cache."""
    ref = refs(arch)
    cfg, model = ref["cfg"], ref["model"]
    toks = torch.tensor(ref["toks"])
    full, _ = T.prefill(model, {"tokens": toks}, cfg, RUN)
    _, cache = T.prefill(model, {"tokens": toks[:, :S]}, cfg, RUN,
                         max_len=S + 1)
    dec, _ = T.decode_step(model, cache, toks[:, S:], S, cfg, RUN)
    np.testing.assert_allclose(dec[:, 0].numpy(), full.numpy(), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("arch", SLICE)
def test_config_matches_jax_and_every_leaf_converts(arch):
    """The port's config equals JAX's field for field, full and reduced,
    with JAX's parameter count; and the conversion is a bijection: JAX's
    ``init_lm`` tree filled with distinct values (0, 1, 2, ... over all
    its leaves) lands in the port's model with every value once, so no
    JAX leaf is dropped and no port parameter is left unfilled."""
    for red in (False, True):
        cfg, jcfg = _cfgs(arch) if red else (get_config(arch),
                                             j_get_config(arch))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
    cfg, jcfg = _cfgs(arch)
    shapes = jax.eval_shape(lambda k: j_init_lm(k, jcfg)[0],
                            jax.random.PRNGKey(0))
    leaves, treedef = jax.tree.flatten(shapes)
    n = sum(s.size for s in leaves)
    assert n < 2 ** 24           # every value exact in float32
    filled, start = [], 0
    for s in leaves:
        filled.append(np.arange(start, start + s.size,
                                dtype=np.float32).reshape(s.shape))
        start += s.size
    model = lm_params_from_jax(jax.tree.unflatten(treedef, filled), cfg)
    got = torch.cat([p.reshape(-1) for p in model.parameters()])
    assert torch.equal(got.sort().values, torch.arange(n, dtype=torch.float32))
    # and leaf for leaf, in the port's names
    tree = jax.tree.unflatten(treedef, filled)
    for i, layer in enumerate(layer_trees(tree, cfg)):
        flat = {f"{sub}.{leaf}": a for sub, d in layer.items()
                for leaf, a in d.items()}
        params = dict(model.blocks[i].named_parameters())
        assert set(params) == set(flat), i
        for name, a in flat.items():
            assert np.array_equal(params[name].numpy(), a), (i, name)
    assert np.array_equal(model.embed.numpy(), tree["embed"])


def test_list_archs_and_the_refusals_naming_the_roadmap():
    """The port serves every arch of the JAX package: ``list_archs()``
    equals JAX's ten, and each builds, the MoE and encoder-decoder ones
    too; an unknown arch still raises."""
    assert list(list_archs()) == list(j_list_archs())
    assert set(SLICE) | {"recurrentgemma-2b", "dbrx-132b",
                         "llama4-scout-17b-a16e",
                         "seamless-m4t-medium"} == set(list_archs())
    for arch in list_archs():
        assert get_config(arch).name == arch
    for arch in ("dbrx-132b", "llama4-scout-17b-a16e", "seamless-m4t-medium"):
        model = T.LM(reduced_config(get_config(arch)), device="meta")
        assert len(model.blocks) == 2
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", ["qwen3-4b", "chameleon-34b",
                                  "seamless-m4t-medium"])
def test_serve_launcher_prints_tokens(arch, capsys):
    out = port_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8",
                           "--new-tokens", "3"])
    assert out.shape == (2, 3) and (0 <= out).all() and (out < 512).all()
    text = capsys.readouterr().out
    assert text.count("seq ") == 2 and "tokens in" in text
