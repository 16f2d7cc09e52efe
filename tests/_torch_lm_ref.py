"""JAX references for the port's LM parity tests, and their checks.

``reference(arch)`` runs the JAX package's reduced ``arch`` (``init_lm``
at ``PRNGKey(0)``, float32) through its engine's own compiled prefill
and decode, once: the prefill of ``S`` tokens (with ``S_ENC`` encoder
frames for an encoder-decoder arch, so that ``S_ENC != S``), ``NEW``
greedy decode steps and ``LMEngine.generate``'s tokens; and converts its
weights into the port's model.  The ``check_*`` functions hold the port
(``device="cpu"``: the kernels' plain versions) to it at ``TOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core  # noqa: F401  (x64: the references get explicit float32)
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models.transformer import RunCfg as JRunCfg
from repro.models.transformer import init_lm as j_init_lm
from repro.serve.engine import LMEngine as JLMEngine

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import layer_trees, lm_params_from_jax
from repro_torch.models import transformer as T
from repro_torch.serve.engine import LMEngine

# float32 sums in another order
TOL = 2e-5
B, S, NEW = 2, 32, 4
S_ENC = 48
JRUN = JRunCfg(dtype=jnp.float32, impl="flash", attn_q_chunk=16,
               attn_kv_chunk=16, scan_chunk=16)


def cfgs(arch):
    return (reduced_config(get_config(arch)),
            j_reduced_config(j_get_config(arch)))


def margin(logits):
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def reference(arch):
    cfg, jcfg = cfgs(arch)
    params, _ = j_init_lm(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (B, S + 1))
    enc = (rng.standard_normal((B, S_ENC, jcfg.d_model)).astype(np.float32)
           if jcfg.n_encoder_layers else None)
    eng = JLMEngine(params, jcfg, JRUN, batch=B, max_len=S + NEW)
    batch = {"tokens": jnp.asarray(toks[:, :S], jnp.int32)}
    if enc is not None:
        batch["enc_embeds"] = jnp.asarray(enc)
    logits, cache = eng._prefill(params, batch)
    params_np = jax.tree.map(np.asarray, params)
    out = dict(cfg=cfg, jcfg=jcfg, params=params_np, toks=toks, enc=enc,
               logits=np.asarray(logits),
               cache=layer_trees(jax.tree.map(np.asarray, cache), cfg),
               fed=[], dec_logits=[])
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    for i in range(NEW):
        out["fed"].append(np.asarray(tok))
        logits, cache = eng._decode(params, cache, tok, jnp.int32(S + i))
        out["dec_logits"].append(np.asarray(logits))
        tok = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)[:, None]
    out["engine"] = eng.generate(toks[:, :S], NEW, enc_embeds=enc)
    out["model"] = lm_params_from_jax(params_np, cfg, device="cpu")
    return out


def run32(impl):
    return T.RunCfg(impl=impl, dtype=torch.float32)


def batch_of(ref, n=S):
    batch = {"tokens": torch.tensor(ref["toks"][:, :n])}
    if ref["enc"] is not None:
        batch["enc_embeds"] = torch.tensor(ref["enc"])
    return batch


def check_prefill(ref, impl):
    cfg, model = ref["cfg"], ref["model"]
    logits, cache = T.prefill(model, batch_of(ref), cfg, run32(impl),
                              max_len=S + NEW)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=0, atol=TOL)
    assert [sorted(c) for c in cache] == [sorted(c) for c in ref["cache"]]
    for layer, (got, want) in enumerate(zip(cache, ref["cache"])):
        for name in want:
            assert got[name].shape == want[name].shape, (layer, name)
            np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0,
                                       atol=TOL, err_msg=f"{layer} {name}")
    return cache


def check_decode(ref, impl):
    cfg, model, run = ref["cfg"], ref["model"], run32(impl)
    _, cache = T.prefill(model, batch_of(ref), cfg, run, max_len=S + NEW)
    for i, (fed, want) in enumerate(zip(ref["fed"], ref["dec_logits"])):
        logits, cache = T.decode_step(model, cache, torch.tensor(fed), S + i,
                                      cfg, run)
        assert logits.shape == want.shape
        np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=TOL,
                                   err_msg=f"step {i}")


def check_engine(ref, impl):
    """Greedy tokens are compared while the reference's top-2 margin is
    above the logits' tolerance (a closer pair may tie either way)."""
    cfg, model = ref["cfg"], ref["model"]
    got = LMEngine(model, cfg, run32(impl), batch=B,
                   max_len=S + NEW).generate(ref["toks"][:, :S], NEW,
                                             enc_embeds=ref["enc"])
    assert got.shape == ref["engine"].shape == (B, NEW)
    margins = [margin(ref["logits"])] + [margin(x) for x in
                                         ref["dec_logits"][:NEW - 1]]
    compared = 0
    for i, m in enumerate(margins):
        if m <= 2 * TOL:
            break
        np.testing.assert_array_equal(got[:, i], ref["engine"][:, i])
        compared += 1
    assert compared == NEW, margins


def check_decode_after_prefill(ref, impl):
    """prefill(T) then decode of token T equals prefill(T + 1)'s last
    logits."""
    cfg, model, run = ref["cfg"], ref["model"], run32(impl)
    full, _ = T.prefill(model, batch_of(ref, S + 1), cfg, run)
    _, cache = T.prefill(model, batch_of(ref), cfg, run, max_len=S + 1)
    dec, _ = T.decode_step(model, cache, torch.tensor(ref["toks"][:, S:]), S,
                           cfg, run)
    np.testing.assert_allclose(dec[:, 0].numpy(), full.numpy(), rtol=0,
                               atol=TOL)


def check_bijection(arch):
    """The port's config equals JAX's field for field, full and reduced,
    with JAX's parameter count; and the conversion is a bijection: JAX's
    ``init_lm`` tree filled with distinct values (0, 1, 2, ... over all
    its leaves) lands in the port's model with every value once, leaf for
    leaf under the port's names, in the decoder's and the encoder's
    stacks."""
    for red in (False, True):
        cfg, jcfg = cfgs(arch) if red else (get_config(arch),
                                            j_get_config(arch))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
    cfg, jcfg = cfgs(arch)
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
    tree = jax.tree.unflatten(treedef, filled)
    model = lm_params_from_jax(tree, cfg)
    got = torch.cat([p.reshape(-1) for p in model.parameters()])
    assert torch.equal(got.sort().values, torch.arange(n, dtype=torch.float32))
    stacks = [("", model.blocks)]
    if cfg.n_encoder_layers:
        stacks.append(("enc_", model.enc_blocks))
    for prefix, blocks in stacks:
        for i, layer in enumerate(layer_trees(tree, cfg, prefix)):
            flat = {}

            def walk(node, path):
                for key, val in node.items():
                    if isinstance(val, dict):
                        walk(val, path + key + ".")
                    else:
                        flat[path + key] = val
            walk(layer, "")
            params = dict(blocks[i].named_parameters())
            assert set(params) == set(flat), (prefix, i)
            for name, a in flat.items():
                assert np.array_equal(params[name].numpy(), a), (i, name)
    return tree, model
