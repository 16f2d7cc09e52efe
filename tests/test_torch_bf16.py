"""Port parity in bfloat16, JAX's default compute dtype, on the CPU.

* ``RunCfg().dtype`` is JAX's ``DEFAULT_DTYPE``; ``init_lm(dtype=)``
  stores the float32 draw rounded.
* ``flash_attention``'s bfloat16 plain version against JAX's
  ``_attn_flash`` on bfloat16 inputs (causal, window, bidirectional,
  T != S), and its bfloat16 mirror against the plain version.
* The layers: attention (QKV bias, qk-norm), the gated MLP, the
  mixture of experts, the RG-LRU and mamba blocks against JAX's own
  functions in bfloat16.
* Reduced prefill, decode and their logits for one arch of each family
  (dense GQA with QKV bias: qwen2.5-14b; qk-norm: chameleon-34b; RG-LRU:
  recurrentgemma-2b with a local-attention layer; mamba:
  falcon-mamba-7b; MoE: dbrx-132b; encoder-decoder:
  seamless-m4t-medium) against JAX's ``prefill`` and ``decode_step``
  with ``RunCfg(dtype=bfloat16)``, once on float32 weights cast at use
  and once on weights tree-mapped to bfloat16; ``lm_loss``'s value and
  gradients on bfloat16 weights; three ``param_dtype=bfloat16`` +
  ``master_fp32`` train steps (two microbatches, so the bfloat16
  gradients are summed in float32).
* ``convert`` and ``ckpt`` keep bfloat16 leaves both ways.

Where JAX rounds.  JAX's program rounds to bfloat16 after every
primitive; XLA's compiler may skip those roundings inside a fusion (its
``xla_allow_excess_precision``, on by default), and then differs from
the same program run primitive by primitive by about as much as
bfloat16 differs from float32 (ROADMAP Queue C).  The references here
are compiled with that option off (:func:`_compiled`), so that they
round where JAX's program does.  Against them the port is bit-equal
for falcon-mamba-7b's whole prefill and decode, and each layer's outputs
differ from JAX's in under ``LAYER_FLIP_SHARE`` of their elements
(float32 sums taken in another order, or contracted into fused
multiply-adds by XLA, land a value on the other side of a rounding
boundary, one ulp, which the next product carries on; measured 0.59% in
attention, 0.12% in mamba, one element in the MoE, none in the RG-LRU
block), each within ``2**-7`` of the layer's largest value.  Through several layers those flips grow as any bfloat16
perturbation does, so the whole-model holds are relative to JAX's own
bfloat16 distance from float32 on the same inputs and weights: the port
within ``GAP_FACTOR`` times it (measured 0.5-1.3 times it), and the
port's bfloat16 distinct from its float32 (it rounds).  The float32
reference is the port's float32 path, which the float32 tests hold to
JAX's at 2e-5.  A path that computed in float32 would pass those
distances, so each whole-model test also counts bfloat16 bits that
differ from JAX's, with the float32 path as a control that must do
worse: the logits (which the head rounds to bfloat16) within
``MODEL_FLIP_SHARE``, the control beyond it; the gradients and the
trained weights with fewer differing bits than the control's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64: the references get explicit dtypes)
from repro.checkpoint import ckpt as j_ckpt
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import layers as JL
from repro.models.transformer import RunCfg as JRunCfg
from repro.models.transformer import decode_step as j_decode_step
from repro.models.transformer import init_lm as j_init_lm
from repro.models.transformer import lm_loss as j_lm_loss
from repro.models.transformer import prefill as j_prefill
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as j_make_train_step

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import flash_attention as FL
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (init_train_state, make_train_step,
                                    train_state)

BF16 = torch.bfloat16
B, S, S_ENC = 2, 32, 48
# one arch of each family -> reduced depth (recurrentgemma's 3 layers:
# two RG-LRU layers and a local-attention one)
FAMILIES = {"qwen2.5-14b": 2, "chameleon-34b": 2, "recurrentgemma-2b": 3,
            "falcon-mamba-7b": 2, "dbrx-132b": 2, "seamless-m4t-medium": 2}
# JAX's flash chunks at their default (1024): one chunk at S = 32, as the
# port's plain version takes it
JRUN = JRunCfg(dtype=jnp.bfloat16, impl="flash", scan_chunk=16)
JTRAIN = JRunCfg(dtype=jnp.bfloat16, impl="naive")
RUN = T.RunCfg(dtype=BF16)
TRAIN = T.RunCfg(dtype=BF16, impl="naive")
F32 = T.RunCfg(dtype=torch.float32)
F32_TRAIN = T.RunCfg(dtype=torch.float32, impl="naive")
GAP_FACTOR = 2.0
LAYER_FLIP_SHARE = 0.02
# the whole model's logits, which the head rounds to bfloat16 as JAX's:
# the share of them whose bits differ from JAX's.  Measured 0 for the
# RG-LRU and mamba archs and 0.26-0.39 for those with attention (the
# layers' rare flips carried through the rows they touch); the port's
# float32 path rounded to bfloat16, the control each test checks, differs
# in 0.69-0.91 of them
MODEL_FLIP_SHARE = 0.5
# the loss is a float32 mean of bfloat16-derived terms whose rounding
# errors may cancel: its reference distance is floored at this share of
# it (one bfloat16 ulp, 2**-8, spread over the mean of 256 terms)
LOSS_FLOOR = 2.0 ** -16


def _compiled(fn, *args):
    """``fn(*args)`` compiled without XLA's excess precision: rounding to
    bfloat16 after every primitive, as JAX's program says."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _cfgs(arch):
    n = FAMILIES[arch]
    return (reduced_config(get_config(arch), n_layers=n),
            j_reduced_config(j_get_config(arch), n_layers=n))


def _np(x):
    """A JAX array as float32 numpy (bfloat16 widened exactly)."""
    return np.asarray(x).astype(np.float32)


def _gap(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else _np(a)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else _np(b)
    return float(np.abs(a.astype(np.float64) - b).max())


def _bits(x) -> np.ndarray:
    """The 16-bit patterns of a bfloat16 tensor or JAX array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _flip_share(got, want) -> float:
    """The share of elements whose bfloat16 bits differ: ``got`` a port
    tensor, ``want`` a JAX array, each rounded to bfloat16 (exact where
    it holds bfloat16 values)."""
    a = _bits(got.to(BF16))
    b = np.asarray(jnp.asarray(want).astype(jnp.bfloat16)).view(np.int16)
    return float((a != b).mean())


def _f32_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float32), tree)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1))
    enc = (rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
           if cfg.n_encoder_layers else None)
    return toks, enc


def _port_batch(toks, enc, n=S):
    out = {"tokens": torch.tensor(toks[:, :n])}
    if enc is not None:
        out["enc_embeds"] = torch.tensor(enc)
    return out


@pytest.fixture(scope="module")
def jax_params():
    made = {}

    def get(arch):
        if arch not in made:
            _, jcfg = _cfgs(arch)
            made[arch] = j_init_lm(jax.random.PRNGKey(0), jcfg)[0]
        return made[arch]
    return get


# --------------------------------------------------------------------- #
# the dtype policy and storage
# --------------------------------------------------------------------- #
def test_runcfg_default_dtype_is_jaxs():
    assert jnp.dtype(JL.DEFAULT_DTYPE).name == "bfloat16"
    assert T.RunCfg().dtype == L.DEFAULT_DTYPE == BF16
    assert JRunCfg().dtype == JL.DEFAULT_DTYPE


def test_init_lm_stores_the_float32_draw_rounded():
    cfg, _ = _cfgs("recurrentgemma-2b")
    m32 = T.init_lm(cfg, torch.Generator().manual_seed(3), device="cpu")
    m16 = T.init_lm(cfg, torch.Generator().manual_seed(3), device="cpu",
                    dtype=BF16)
    for (name, a), (_, b) in zip(m32.named_parameters(),
                                 m16.named_parameters()):
        assert a.dtype == torch.float32 and b.dtype == BF16, name
        assert torch.equal(a.to(BF16), b), name


# --------------------------------------------------------------------- #
# flash_attention in bfloat16
# --------------------------------------------------------------------- #
# (T, S, H, KVH, hd, causal, window)
FLASH_CASES = ((40, 40, 4, 2, 64, True, None), (48, 48, 2, 1, 128, True, 16),
               (40, 40, 2, 2, 64, False, None),
               (24, 56, 4, 2, 64, False, None))
# cases past one tile at the kernel's bfloat16 tiles: three 128-row q
# tiles over three 128-key KV tiles (a window edge inside them), and four
# 64-key KV tiles at hd 256, S < T
FLASH_MULTI_TILE = ((300, 300, 4, 2, 64, True, 160),
                    (300, 200, 2, 1, 256, False, None))


def _flash_inputs(T_, S_, H, KVH, hd, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = mk(1, T_, H, hd), mk(1, S_, KVH, hd), mk(1, S_, KVH, hd)
    return [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_bf16_matches_jax_attn_flash(case):
    """JAX's ``_attn_flash`` on bfloat16 inputs (one chunk, as the
    plain version's 1024 at these sizes): the same roundings, so equal
    but for one-ulp flips of the output where float32 sums in another
    order straddle a boundary; held at JAX's bfloat16 kernel bound."""
    T_, S_, H, KVH, hd, causal, window = case
    q, k, v = _flash_inputs(T_, S_, H, KVH, hd)
    want = JL._attn_flash(q.reshape(1, T_, KVH, H // KVH, hd), k, v,
                          jnp.arange(T_), jnp.arange(S_), causal=causal,
                          window=window)
    got = FL.flash_attention_plain(*(convert.to_torch(np.asarray(a))
                                     for a in (q, k, v)),
                                   causal=causal, window=window)
    assert got.dtype == BF16
    want = np.asarray(want).reshape(got.shape)
    assert _gap(got, want) <= FL.BF16_PLAIN_TOL
    assert float((_bits(got) != want.view(np.int16)).mean()) <= \
        LAYER_FLIP_SHARE


@pytest.mark.parametrize("case", FLASH_CASES + FLASH_MULTI_TILE)
def test_flash_mirror_bf16_matches_plain(case):
    """The mirror walks the kernel's 128-row q tiles and its KV tiles
    (``KERNEL_TILES_BF16``: 128 keys, 64 at hd 256), so its ``p`` is
    rounded against each tile's running max: within the plain version's
    bound, and past one tile (``FLASH_MULTI_TILE``) within the same
    bound of JAX's ``_attn_flash`` too.  Its two MMA roundings (the
    tensor cores' and to-nearest) differ from each other only within
    its own bound."""
    T_, S_, H, KVH, hd, causal, window = case
    jq, jk, jv = _flash_inputs(T_, S_, H, KVH, hd, seed=1)
    q, k, v = (convert.to_torch(np.asarray(a)) for a in (jq, jk, jv))
    kw = dict(causal=causal, window=window)
    plain = FL.flash_attention_plain(q, k, v, **kw)
    near, slack = FL.flash_attention_mirror(q, k, v, tensor_core=False,
                                            with_slack=True, **kw)
    assert near.dtype == BF16
    assert _gap(near, plain) <= FL.BF16_PLAIN_TOL
    if case in FLASH_MULTI_TILE:
        want = JL._attn_flash(jq.reshape(1, T_, KVH, H // KVH, hd), jk, jv,
                              jnp.arange(T_), jnp.arange(S_), causal=causal,
                              window=window)
        assert _gap(near, np.asarray(want).reshape(near.shape)) <= \
            FL.BF16_PLAIN_TOL
    if case == FLASH_CASES[1] or case in FLASH_MULTI_TILE:
        tc = FL.flash_attention_mirror(q, k, v, **kw)
        d = (tc.float() - near.float()).abs()
        assert (d <= FL.mirror_bound_bf16(tc, near, slack)).all()


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_mirror_rows_are_the_whole_mirrors_rows(dtype):
    """``rows=(r0, r1)`` gives the whole mirror's rows ``r0..r1-1`` (the
    card holds the kernel's last q tiles of a long sequence this way),
    slack too, the last tile ragged; a span that does not start a q tile
    raises."""
    q, k, v = (convert.to_torch(np.asarray(a)).to(dtype)
               for a in _flash_inputs(150, 150, 2, 1, 64, seed=2))
    kw = dict(causal=True, window=100, tensor_core=False)
    if dtype == BF16:
        kw["with_slack"] = True
    bq = (FL.KERNEL_TILES_BF16 if dtype == BF16 else FL.KERNEL_TILES)[64][0]
    whole = FL.flash_attention_mirror(q, k, v, **kw)
    part = FL.flash_attention_mirror(q, k, v, rows=(bq, 150), **kw)
    for w, p in zip(whole, part) if dtype == BF16 else ((whole, part),):
        assert p.shape == (1, 150 - bq, 2, 64) and torch.equal(w[:, bq:], p)
    with pytest.raises(ValueError, match="q tile"):
        FL.flash_attention_mirror(q, k, v, rows=(32, 150), **kw)


def test_flash_bf16_refusals():
    """Mixed types are refused; inputs that require grad get a bfloat16
    gradient (the Function's plain backward here), within 2e-2 of its
    max |g| of the float64 gradient of the same inputs."""
    q = torch.zeros(1, 8, 2, 64, dtype=BF16)
    with pytest.raises(TypeError, match="bfloat16"):
        FL.flash_attention(q, q.float(), q)
    g = torch.Generator().manual_seed(5)
    q = torch.randn(1, 8, 2, 64, generator=g).to(BF16)
    k = torch.randn(1, 8, 1, 64, generator=g).to(BF16)
    leaf = q.clone().requires_grad_()
    FL.flash_attention(leaf, k, k).float().sum().backward()
    assert leaf.grad.dtype == BF16
    o, lse = FL.flash_attention_plain(q, k, k, return_lse=True)
    want = FL.flash_attention_backward_plain(
        *(x.double() for x in (q, k, k, o, lse, torch.ones_like(o))))[0]
    assert (leaf.grad.double() - want).abs().max().item() <= \
        FL.BWD_BF16_TOL * want.abs().max().item()


# --------------------------------------------------------------------- #
# the layers, op by op
# --------------------------------------------------------------------- #
def _fill(module, params):
    for name, val in params.items():
        if isinstance(val, dict):
            _fill(getattr(module, name), val)
        else:
            getattr(module, name).data.copy_(torch.tensor(np.asarray(val)))


def _same_bits(got, want):
    assert got.dtype == BF16 and tuple(got.shape) == want.shape
    flips = _bits(got) != np.asarray(want).view(np.int16)
    assert float(flips.mean()) <= LAYER_FLIP_SHARE
    assert _gap(got, want) <= 2.0 ** -7 * float(np.abs(_np(want)).max())


def test_layers_round_where_jax_rounds(jax_params):
    """Each apply function in bfloat16 on float32 weights against JAX's
    (:func:`_compiled`): bit-equal but for rare one-ulp flips."""
    rng = np.random.default_rng(5)
    for arch, blk_name, fn, jfn in (
            ("chameleon-34b", "attn",
             lambda m, x, c: L.attention(m, x, c, dtype=BF16)[0],
             lambda p, x, c: JL.attention(p, x, c, impl="flash",
                                          dtype=jnp.bfloat16)[0]),
            ("dbrx-132b", "moe",
             lambda m, x, c: L.moe_dense(m, x, c, BF16)[0],
             lambda p, x, c: JL.moe_dense(p, x, c, jnp.bfloat16)[0]),
            ("recurrentgemma-2b", "rglru",
             lambda m, x, c: L.rglru_block(m, x, c, dtype=BF16)[0],
             lambda p, x, c: JL.rglru_block(p, x, c, chunk=16,
                                            dtype=jnp.bfloat16)[0]),
            ("falcon-mamba-7b", "mamba",
             lambda m, x, c: L.mamba_block(m, x, c, dtype=BF16)[0],
             lambda p, x, c: JL.mamba_block(p, x, c, chunk=16,
                                            dtype=jnp.bfloat16)[0])):
        cfg, jcfg = _cfgs(arch)
        lt = convert.layer_trees(jax.tree.map(np.asarray, jax_params(arch)),
                                 cfg)
        params = lt[0][blk_name]
        model = T.LM(cfg, device="cpu")
        module = getattr(model.blocks[0], blk_name)
        _fill(module, params)
        x = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)).astype(jnp.bfloat16)
        want = _compiled(lambda p, x_: jfn(p, x_, jcfg),
                         jax.tree.map(jnp.asarray, params), x)
        got = fn(module, convert.to_torch(np.asarray(x)), cfg)
        _same_bits(got, want)


# --------------------------------------------------------------------- #
# whole models: prefill, decode, loss, train steps
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def serve_refs(jax_params):
    """JAX's bfloat16 prefill and decode logits of an arch on its float32
    weights and on them tree-mapped to bfloat16 (one compile for both)."""
    made = {}

    def get(arch):
        if arch not in made:
            cfg, jcfg = _cfgs(arch)
            toks, enc = _batch(cfg)
            jb = {"tokens": jnp.asarray(toks[:, :S], jnp.int32)}
            if enc is not None:
                jb["enc_embeds"] = jnp.asarray(enc)

            def run(p, b, nxt):
                out = {}
                for name, pp in (("float32", p), ("bfloat16", jax.tree.map(
                        lambda a: a.astype(jnp.bfloat16), p))):
                    logits, cache = j_prefill(pp, b, jcfg, JRUN,
                                              max_len=S + 1)
                    dec, _ = j_decode_step(pp, cache, nxt, jnp.int32(S),
                                           jcfg, JRUN)
                    out[name] = (logits, dec)
                return out
            made[arch] = _compiled(run, jax_params(arch), jb,
                                   jnp.asarray(toks[:, S:], jnp.int32))
        return made[arch]
    return get


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_prefill_and_decode_bf16_against_jax(jax_params, serve_refs, arch,
                                             param_dtype):
    cfg, _ = _cfgs(arch)
    params = jax_params(arch)
    if param_dtype == "bfloat16":
        params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    toks, enc = _batch(cfg)
    j_pre, j_dec = serve_refs(arch)[param_dtype]
    params_np = jax.tree.map(np.asarray, params)
    model = convert.lm_params_from_jax(params_np, cfg)
    assert model.embed.dtype == {"float32": torch.float32,
                                 "bfloat16": BF16}[param_dtype]
    m32 = convert.lm_params_from_jax(_f32_tree(params_np), cfg)
    out = {}
    for key, mdl, run_cfg in (("bf16", model, RUN), ("f32", m32, F32)):
        pre, cache = T.prefill(mdl, _port_batch(toks, enc), cfg, run_cfg,
                               max_len=S + 1)
        dec, _ = T.decode_step(mdl, cache, torch.tensor(toks[:, S:]), S,
                               cfg, run_cfg)
        out[key] = (pre, dec[:, 0], cache)
    pre, dec, cache = out["bf16"]
    assert pre.dtype == dec.dtype == torch.float32      # JAX's logits
    for c in cache:
        for name, t in c.items():
            assert t.dtype == (torch.float32 if name == "h" else BF16), name
    f32_pre, f32_dec, _ = out["f32"]
    jax_gap = max(_gap(j_pre, f32_pre), _gap(j_dec[:, 0], f32_dec))
    port_gap = max(_gap(pre, j_pre), _gap(dec, j_dec[:, 0]))
    assert 0 < jax_gap < 0.2
    assert port_gap <= GAP_FACTOR * jax_gap, (port_gap, jax_gap)
    assert max(_gap(pre, f32_pre), _gap(dec, f32_dec)) > 0
    # the head rounds to bfloat16 where JAX's does: the port's bits, and
    # the float32 path's rounded ones as the control that must fail
    assert torch.equal(pre, pre.to(BF16).float())
    port_flips = (_flip_share(pre, j_pre), _flip_share(dec, j_dec[:, 0]))
    f32_flips = (_flip_share(f32_pre, j_pre),
                 _flip_share(f32_dec, j_dec[:, 0]))
    assert max(port_flips) <= MODEL_FLIP_SHARE, port_flips
    assert min(f32_flips) > MODEL_FLIP_SHARE, f32_flips
    if arch in ("falcon-mamba-7b", "recurrentgemma-2b"):   # JAX's bits
        assert port_gap == 0.0


def _loss_batch(cfg, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, lead + (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[..., :-1], "targets": toks[..., 1:],
           "mask": (rng.random(lead + (B, S)) > 0.2).astype(np.float32)}
    if cfg.n_encoder_layers:
        out["enc_embeds"] = rng.standard_normal(
            lead + (B, S_ENC, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _port_grads(model, batch, cfg, run):
    model.requires_grad_(True)
    loss, _ = T.lm_loss(model, batch, cfg, run)
    loss.backward()
    return float(loss.detach()), {k: p.grad.float() for k, p in
                         model.named_parameters()}


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_lm_loss_gradients_bf16_against_jax(jax_params, arch):
    """bfloat16 weights, bfloat16 compute: the loss and each leaf's
    gradient (relative to the leaf's largest |g|), worst leaf against
    JAX's own worst distance from float32."""
    cfg, jcfg = _cfgs(arch)
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jax_params(arch))
    batch = _loss_batch(cfg)
    (j_loss, _), j_grads = _compiled(
        jax.value_and_grad(lambda p, b: j_lm_loss(p, b, jcfg, JTRAIN),
                           has_aux=True),
        params, jax.tree.map(jnp.asarray, batch))
    j_grads = convert.lm_named_from_jax(
        jax.tree.map(lambda g: convert.to_torch(np.asarray(g)).float(),
                     j_grads), cfg)
    params_np = jax.tree.map(np.asarray, params)
    loss, grads = _port_grads(convert.lm_params_from_jax(params_np, cfg),
                              _torch_batch(batch), cfg, TRAIN)
    f_loss, f_grads = _port_grads(
        convert.lm_params_from_jax(_f32_tree(params_np), cfg),
        _torch_batch(batch), cfg, F32_TRAIN)

    def worst(a, b):
        return max(float((a[k] - b[k]).abs().max())
                   / max(float(b[k].abs().max()), 1e-12) for k in b)
    assert set(grads) == set(j_grads)
    jax_gap = worst(j_grads, f_grads)
    assert worst(grads, j_grads) <= GAP_FACTOR * jax_gap

    def flips(a):        # bfloat16 bits differing from JAX's, all leaves
        return (sum(int((_bits(a[k].to(BF16)) != _bits(j_grads[k].to(BF16)))
                        .sum()) for k in j_grads)
                / sum(g.numel() for g in j_grads.values()))
    # fewer than the float32 path's (measured 0.20-0.71 against 0.61-0.78)
    assert flips(grads) < flips(f_grads)
    want = float(j_loss)
    assert abs(loss - want) <= GAP_FACTOR * max(abs(want - f_loss),
                                                LOSS_FLOOR * abs(want))


def test_three_param_dtype_train_steps_against_jax(jax_params):
    """``init_train_state(param_dtype=bfloat16)`` with ``master_fp32``:
    three steps of two microbatches from JAX's weights, against JAX's
    ``make_train_step``.  The losses within ``GAP_FACTOR`` times JAX's
    own distance from the float32 port's; after each step the bfloat16
    parameters are their float32 master rounded (JAX's write-back)."""
    arch = "qwen2.5-14b"
    cfg, jcfg = _cfgs(arch)
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jax_params(arch))
    opt = dict(lr=1e-3, master_fp32=True)
    batches = [_loss_batch(cfg, seed=10 + i, lead=(2,)) for i in range(3)]
    jstate = JTrainState(params, j_adamw_init(params, JAdamWConfig(**opt)))
    jfn = j_make_train_step(jcfg, JTRAIN, JAdamWConfig(**opt))
    jstep = jax.jit(jfn).lower(
        jstate, jax.tree.map(jnp.asarray, batches[0])).compile(
            compiler_options={"xla_allow_excess_precision": False})
    params_np = jax.tree.map(np.asarray, params)
    state = train_state(convert.lm_params_from_jax(params_np, cfg),
                        AdamWConfig(**opt))
    step = make_train_step(cfg, TRAIN, AdamWConfig(**opt))
    ref = train_state(convert.lm_params_from_jax(_f32_tree(params_np), cfg),
                      AdamWConfig(lr=1e-3))
    ref_step = make_train_step(cfg, F32_TRAIN, AdamWConfig(lr=1e-3))
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, _torch_batch(b))
        ref, rm = ref_step(ref, _torch_batch(b))
        want, f32 = float(jm["loss"]), float(rm["loss"])
        assert abs(float(m["loss"]) - want) <= GAP_FACTOR * max(
            abs(want - f32), LOSS_FLOOR * abs(want)), i
        assert int(m["step"]) == int(jm["step"]) == i + 1
        for name, p in state.params.named_parameters():
            assert p.dtype == BF16
            assert torch.equal(p, state.opt.master[name].to(BF16)), name
        # the bfloat16 weights' bits: fewer differ from JAX's than the
        # float32 path's rounded ones do (measured 193, 3800, 7149 of
        # 139840 after the three steps, against 541, 5541, 9227)
        jp = convert.lm_named_from_jax(jax.tree.map(
            lambda a: convert.to_torch(np.asarray(a)), jstate.params), cfg)
        flips = [sum(int((_bits(m[k].to(BF16)) != _bits(jp[k])).sum())
                     for k in jp) for m in (
                         dict(state.params.named_parameters()),
                         dict(ref.params.named_parameters()))]
        assert flips[0] < flips[1], (i, flips)
    assert all(t.dtype == torch.float32 for t in state.opt.m.values())
    with pytest.raises(ValueError, match="master_fp32"):
        init_train_state(cfg, torch.Generator(), device="cpu",
                         param_dtype=BF16)


# --------------------------------------------------------------------- #
# convert and ckpt keep bfloat16 leaves
# --------------------------------------------------------------------- #
def test_convert_keeps_bfloat16_leaves_both_ways(jax_params):
    arch = "seamless-m4t-medium"
    cfg, _ = _cfgs(arch)
    # bfloat16 but for the norms' scales: each leaf keeps its own dtype
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: a if "norm" in jax.tree_util.keystr(path)
        else a.astype(jnp.bfloat16), jax_params(arch))
    params_np = jax.tree.map(np.asarray, tree)
    model = convert.lm_params_from_jax(params_np, cfg)
    named = convert.lm_named_from_jax(params_np, cfg)
    for name, p in model.named_parameters():
        a = named[name]
        if a.dtype.name == "bfloat16":
            assert p.dtype == BF16 and np.array_equal(_bits(p), _bits(a))
        else:
            assert p.dtype == torch.float32 and np.array_equal(p.numpy(), a)
    back = convert.lm_params_to_jax(model, cfg)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    got, want = flat(back), flat(params_np)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        if w.dtype.name == "bfloat16":
            assert isinstance(g, torch.Tensor) and g.dtype == BF16, path
            assert np.array_equal(_bits(g), _bits(w)), path
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w), path


def test_ckpt_bfloat16_train_state_both_ways(jax_params, tmp_path):
    """A ``param_dtype=bfloat16`` state (params bfloat16; master, m, v
    float32) written by the port restores in JAX bit for bit, and JAX's
    restores in the port."""
    arch = "recurrentgemma-2b"
    cfg, _ = _cfgs(arch)
    opt = AdamWConfig(master_fp32=True)
    state = init_train_state(cfg, torch.Generator().manual_seed(4),
                             device="cpu", param_dtype=BF16, opt_cfg=opt)
    with torch.no_grad():
        for name, t in state.opt.m.items():
            t.normal_(generator=torch.Generator().manual_seed(len(name)))
    tree = convert.train_state_to_jax(state, cfg)
    ckpt.save(tmp_path / "port", 7, tree)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jax_params(arch))
    jtree = JTrainState(jp, j_adamw_init(jp, JAdamWConfig(master_fp32=True)))
    got = j_ckpt.restore(tmp_path / "port", 7, like=jtree)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    for (path, g), (_, w) in zip(flat(got), flat(tree)):
        g = np.asarray(g)
        if isinstance(w, torch.Tensor):
            assert g.dtype.name == "bfloat16", path
            assert np.array_equal(g.view(np.int16), _bits(w)), path
        else:
            assert g.dtype == np.asarray(w).dtype, path
            assert np.array_equal(g, np.asarray(w)), path
    # JAX's write, the port's read into a fresh state
    j_ckpt.save(tmp_path / "jax", 3, got)
    fresh = init_train_state(cfg, torch.Generator().manual_seed(9),
                             device="cpu", param_dtype=BF16, opt_cfg=opt)
    back = ckpt.restore(tmp_path / "jax", 3,
                        like=convert.train_state_to_jax(fresh, cfg))
    fresh = convert.train_state_from_jax(back, cfg, fresh)
    assert int(fresh.opt.step) == int(state.opt.step)
    for name, p in state.params.named_parameters():
        q = dict(fresh.params.named_parameters())[name]
        assert q.dtype == BF16 and torch.equal(p, q), name
        assert torch.equal(state.opt.master[name], fresh.opt.master[name])
        assert torch.equal(state.opt.m[name], fresh.opt.m[name])
