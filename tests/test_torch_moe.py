"""Port parity: the mixture-of-experts archs (dbrx-132b, llama4-scout-17b-a16e)
serving, reduced, on the CPU.

The reduced configs keep each arch's routing: dbrx top-2 of 4 experts,
llama4-scout top-1 of 4 plus the shared expert (d_model 64, 4 query heads
over 2 KV heads, head_dim 16, expert width 96).  ``moe_dense`` is held
to JAX's ``moe_dense`` (output and load-balancing loss); the whole model
to the JAX package's prefill (last logits and the KV cache), four greedy
decode steps and ``LMEngine.generate``'s tokens, with the port's
attention both ``flash`` (its plain version here) and ``naive``; the
JAX references come from its engine's own compiled prefill and decode,
one compile of each an arch (``tests/_torch_lm_ref.py``).

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
from repro_torch.models import layers as L

ARCHS = ("dbrx-132b", "llama4-scout-17b-a16e")
IMPLS = ("flash", "naive")


@pytest.fixture(scope="module")
def refs():
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = R.reference(arch)
        return made[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_jax_out_and_aux(refs, arch):
    """The first layer's experts on seeded activations: the gate mix, the
    shared expert and the router's loss; the reduced routing is the
    arch's (top-2, or top-1 with the shared expert)."""
    ref = refs(arch)
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    assert (cfg.moe.top_k, cfg.moe.shared_expert) == {
        "dbrx-132b": (2, False), "llama4-scout-17b-a16e": (1, True)}[arch]
    jp = layer_trees(ref["params"], cfg)[0]["moe"]
    x = np.random.default_rng(1).standard_normal(
        (R.B, 24, cfg.d_model)).astype(np.float32)
    want, want_aux = JL.moe_dense(jax.tree.map(jnp.asarray, jp),
                                  jnp.asarray(x), jcfg, jnp.float32)
    got, aux = L.moe_dense(ref["model"].blocks[0].moe, torch.tensor(x), cfg,
                           torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=R.TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0,
                               atol=R.TOL)
    # the routing itself: each token's top-k set is JAX's
    _, _, top_i = L.moe_route(ref["model"].blocks[0].moe, torch.tensor(x),
                              cfg, torch.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(jp["router"]), -1)
    j_top = np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1])
    assert np.array_equal(np.sort(top_i.numpy(), -1), np.sort(j_top, -1))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax_logits_and_cache(refs, arch, impl):
    cache = R.check_prefill(refs(arch), impl)
    assert [sorted(c) for c in cache] == [["k", "v"]] * len(cache)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(refs, arch, impl):
    R.check_decode(refs(arch), impl)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax(refs, arch, impl):
    R.check_engine(refs(arch), impl)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_equals_longer_prefill(refs, arch):
    R.check_decode_after_prefill(refs(arch), "flash")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax_and_every_leaf_converts(arch):
    tree, model = R.check_bijection(arch)
    assert all(hasattr(b, "moe") and not hasattr(b, "mlp")
               for b in model.blocks)
    assert hasattr(model.blocks[0].moe, "shared") == (
        arch == "llama4-scout-17b-a16e")
