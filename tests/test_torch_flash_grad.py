"""Port parity: ``flash_attention``'s gradient on the CPU against JAX.

JAX's ``impl="flash"`` attention is ``models/layers.py::_attn_flash``,
plain jnp that JAX differentiates; the port's ``flash_attention`` is a
``torch.autograd.Function`` whose backward on the CPU is
``flash_attention_backward_plain`` (on the card the backward kernel of
``csrc/flash_attention_bwd.cu`` and ``csrc/flash_attention_bwd_bf16.cu``,
held to that plain version by the card tests and ``chip_smoke.py``).
Here, on numpy inputs made from one seed:

* float32: the plain backward (from the plain forward's ``out`` and
  ``lse``) and the Function's gradient against ``jax.vjp`` of
  ``_attn_flash``: each of dQ, dK, dV within 1e-5 of its max |g| (float32
  sums in other orders: the dense formulas against JAX's autodiff of the
  online softmax);
* bfloat16: the Function's gradient on bfloat16 inputs within
  ``GAP_FACTOR`` times JAX's own bfloat16-vs-float32 gradient gap on the
  same inputs (the form ``tests/test_torch_bf16.py`` holds the port to);
* the backward's tile plans: the dQ walk's KV tiles and the dK/dV walk's
  q tiles (``BWD_TILES``) are exactly the tiles with a live pair; each
  instance's entry point is declared in the source its wrapper builds;
* head dims below the kernels' instances: the mirrors pad to the
  instance (``instance_head_dim``) and hold JAX's ``_attn_flash``.

Cases: causal GQA (G = 2), a 32-key window, bidirectional, cross T != S;
head dims 16, 24 and 64.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64: the references get explicit float32)
from repro.models.layers import _attn_flash

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FL

GRAD_TOL = 1e-5
GAP_FACTOR = 2.0
BF16 = torch.bfloat16

# (label, B, T, S, KVH, G, hd, causal, window)
CASES = [("causal-gqa", 2, 48, 48, 2, 2, 16, True, None),
         ("window", 1, 64, 64, 1, 2, 24, True, 32),
         ("bidirectional", 2, 40, 40, 2, 1, 64, False, None),
         ("cross", 2, 24, 40, 2, 2, 16, False, None),
         ("causal-hd64", 1, 48, 48, 2, 2, 64, True, None)]


def _inputs(B, T, S, KVH, G, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, KVH, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
    do = rng.standard_normal((B, T, KVH, G, hd)).astype(np.float32)
    return q, k, v, do


def _jax_vjp(q, k, v, do, causal, window, dtype=jnp.float32):
    """``(out, (dq, dk, dv))`` of JAX's ``_attn_flash`` in ``dtype``, as
    float32 numpy, q and dq in the port's (B, T, H, hd) layout.  Compiled
    with XLA's backend (LLVM) optimisation off: the same HLO program,
    2-3x faster to compile here, its results within an ulp."""
    T, S = q.shape[1], k.shape[1]

    def fwd_bwd(q_, k_, v_, do_):
        out, vjp = jax.vjp(lambda a, b, c: _attn_flash(
            a, b, c, jnp.arange(T), jnp.arange(S), causal=causal,
            window=window), q_, k_, v_)
        return out, vjp(do_)
    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v, do)]
    out, grads = jax.jit(fwd_bwd).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    f = lambda x: np.asarray(x.astype(jnp.float32))
    B, _, KVH, G, hd = q.shape
    dq, dk, dv = (f(g) for g in grads)
    return f(out).reshape(B, T, KVH * G, hd), (
        dq.reshape(B, T, KVH * G, hd), dk, dv)


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _port(q, k, v):
    B, T, KVH, G, hd = q.shape
    return (torch.tensor(q.reshape(B, T, KVH * G, hd)), torch.tensor(k),
            torch.tensor(v))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_matches_jax_vjp_float32(case):
    _, B, T, S, KVH, G, hd, causal, window = case
    q, k, v, do = _inputs(B, T, S, KVH, G, hd, seed=T + hd)
    j_out, j_grads = _jax_vjp(q, k, v, do, causal, window)
    tq, tk, tv = _port(q, k, v)
    tdo = torch.tensor(do.reshape(B, T, KVH * G, hd))
    kw = dict(causal=causal, window=window)
    out, lse = FL.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    assert lse.shape == (B, KVH * G, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), j_out, rtol=0, atol=2e-5)
    plain = FL.flash_attention_backward_plain(tq, tk, tv, out, lse, tdo, **kw)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    got = FL.flash_attention(*leaves, **kw)
    assert got.grad_fn is not None and torch.equal(got.detach(), out)
    got.backward(tdo)
    for name, p, leaf, want in zip(("dq", "dk", "dv"), plain, leaves,
                                   j_grads):
        assert p.shape == want.shape and p.dtype == torch.float32, name
        assert _rel(p, want) <= GRAD_TOL, (name, _rel(p, want))
        assert torch.equal(leaf.grad, p), name
    assert all(n == 0 for n in FL.LAUNCHES.values())   # plain versions only


@pytest.mark.parametrize("case", CASES[:4], ids=[c[0] for c in CASES[:4]])
def test_backward_bf16_within_jax_own_distance(case):
    """bfloat16 inputs: the Function's gradient (float32 formulas on the
    upcast inputs, gradients rounded to bfloat16) against JAX's bfloat16
    vjp, within ``GAP_FACTOR`` times JAX's bfloat16 vjp's distance from
    its float32 vjp on the same (bfloat16-rounded) inputs."""
    _, B, T, S, KVH, G, hd, causal, window = case
    q, k, v, do = (np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                              .astype(jnp.float32))
                   for x in _inputs(B, T, S, KVH, G, hd, seed=T + hd + 1))
    _, j_bf = _jax_vjp(q, k, v, do, causal, window, jnp.bfloat16)
    _, j_f32 = _jax_vjp(q, k, v, do, causal, window)
    leaves = [x.to(BF16).requires_grad_() for x in _port(q, k, v)]
    out = FL.flash_attention(*leaves, causal=causal, window=window)
    assert out.dtype == BF16
    out.backward(torch.tensor(do.reshape(B, T, KVH * G, hd)).to(BF16))
    for name, leaf, jb, jf in zip(("dq", "dk", "dv"), leaves, j_bf, j_f32):
        assert leaf.grad.dtype == BF16, name
        jax_gap = _rel(jb, jf)
        assert 0 < jax_gap and _rel(leaf.grad, jb) <= GAP_FACTOR * jax_gap, (
            name, _rel(leaf.grad, jb), jax_gap)


@pytest.mark.parametrize("dtype", [torch.float32, BF16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
@pytest.mark.parametrize("T,S,causal,window", [
    (T, S, c, w) for T, S in ((150, 150), (64, 200), (300, 100))
    for c, w in ((True, None), (True, 40), (False, None), (False, 70))
    if w is None or T - w < S])
def test_backward_tile_plans_visit_exactly_the_live_tiles(T, S, causal,
                                                          window, hd, dtype):
    """The dQ walk's KV tiles for each q tile and the dK/dV walk's q tiles
    for each KV tile are exactly those holding a live (query, key)
    pair, each walk at its own tiles (``BWD_TILES``)."""
    tiles = FL.BWD_TILES[dtype][FL.instance_head_dim(hd)]
    br, bc = tiles["dq"]
    pq, pk = np.arange(T)[:, None], np.arange(S)[None, :]
    live = np.ones((T, S), bool)
    if causal:
        live &= pq >= pk
    if window is not None:
        live &= pq - pk < window
    for q0 in range(0, T, br):
        want = sorted({int(x) // bc for x in
                       np.nonzero(live[q0:q0 + br].any(0))[0]})
        got = list(FL.kv_tile_range(q0, T, S, hd, causal=causal,
                                    window=window, tiles=(br, bc)))
        assert got == want, ("dq", q0, got, want)
    bk, bq = tiles["dkv"]
    for k0 in range(0, S, bk):
        want = sorted({int(x) // bq for x in
                       np.nonzero(live[:, k0:k0 + bk].any(1))[0]})
        got = list(FL.q_tile_range(k0, T, S, hd, causal=causal,
                                   window=window, dtype=dtype))
        assert got == want, ("dkv", k0, got, want)


@pytest.mark.parametrize("dtype", [torch.float32, BF16],
                         ids=["float32", "bfloat16"])
def test_backward_entry_points_live_in_their_sources(dtype):
    """Each instance's backward entry point is declared, with the
    wrapper's number of arguments, in the source the wrapper builds and
    binds for it; that source's local includes are in ``csrc/``; the
    instance has its own launch count."""
    source, entry, key = FL._BWD_ENTRIES[dtype]
    assert FL._SIGNATURES[source] == {entry: FL._BWD_ARGS}
    text = (_build.CSRC / f"{source}.cu").read_text()
    found = re.search(rf'extern "C" int {entry}\((.*?)\)\s*{{', text, re.S)
    assert found, (source, entry)
    assert found.group(1).count(",") + 1 == len(FL._BWD_ARGS)
    for header in re.findall(r'#include "([^"]+)"', text):
        assert (_build.CSRC / header).is_file(), header
    assert key in FL.LAUNCHES


@pytest.mark.parametrize("hd", [16, 24])
def test_mirrors_pad_small_head_dims(hd):
    """A head dim below the instances' is zero-padded to 64 with its own
    scale: the float32 mirror (tensor cores' rounding off) within 2e-5 of
    JAX's ``_attn_flash``, the bfloat16 mirror within 2e-2 of JAX's on
    bfloat16 inputs; the output keeps the head dim."""
    q, k, v, _ = _inputs(1, 70, 70, 2, 2, hd, seed=hd)
    j_out, _ = _jax_vjp(q, k, v, np.zeros_like(q), True, 40)
    tq, tk, tv = _port(q, k, v)
    got = FL.flash_attention_mirror(tq, tk, tv, window=40, tensor_core=False)
    assert got.shape == tq.shape
    np.testing.assert_allclose(got.numpy(), j_out, rtol=0, atol=2e-5)
    qb, kb, vb = (x.to(BF16) for x in (tq, tk, tv))
    j_bf = np.asarray(jax.jit(lambda a, b, c: _attn_flash(
        a, b, c, jnp.arange(70), jnp.arange(70), causal=True, window=40))(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in
          (qb.reshape(1, 70, 2, 2, hd), kb, vb))).astype(jnp.float32))
    got_bf, slack = FL.flash_attention_mirror(qb, kb, vb, window=40,
                                              tensor_core=False,
                                              with_slack=True)
    assert got_bf.shape == qb.shape and slack.shape == qb.shape
    assert float(np.abs(got_bf.float().numpy() - j_bf.reshape(
        1, 70, 4, hd)).max()) <= FL.BF16_PLAIN_TOL
    with pytest.raises(ValueError, match="head_dim"):
        FL.instance_head_dim(288)
