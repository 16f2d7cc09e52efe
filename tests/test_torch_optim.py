"""Port parity: AdamW, the learning-rate schedules and int8 quantisation
against the JAX package's ``optim/``, on the same numpy inputs.

``adamw_update`` is held to JAX's within 1e-6 (absolute, on values of
order 1) on the same gradients and state: clipping active, 1-D leaves
(no decay) beside 2-D ones, a nonzero state at step 3, and the
``master_fp32`` branch (the gradient norm within 1e-6 relative).
``quantize_int8`` and the schedules are held to equality, but for the
cosine schedule past its warmup: torch's float32 ``cos`` and XLA's round
apart by up to 2 ulp at some steps, so those steps are held within
3e-7 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64: the references get explicit float32)
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.optim import schedule as JS

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.optim import adamw as A
from repro_torch.optim import compression as C
from repro_torch.optim import schedule as S

TOL = 1e-6
# torch.cos and XLA's float32 cos differ by up to 2 ulp at some angles
LR_RTOL = 3e-7
SHAPES = {"w": (8, 16), "b": (16,), "scale": (4,), "e": (3, 4, 5)}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("lr", ["const", "cosine"])
def test_adamw_update_matches_jax(master, lr):
    rng = np.random.default_rng(0)
    params, grads = _tree(rng), _tree(rng, 3.0)
    m, v = _tree(rng, 0.1), {k: np.abs(a) for k, a in _tree(rng, 0.1).items()}
    kw = dict(lr=(2e-3 if lr == "const" else None), weight_decay=0.1,
              clip_norm=1.0, master_fp32=master)
    jkw = dict(kw, lr=kw["lr"] or JS.warmup_cosine(1e-2, 2, 10))
    tkw = dict(kw, lr=kw["lr"] or S.warmup_cosine(1e-2, 2, 10))
    jst = JA.AdamWState(step=jnp.int32(3),
                        m=jax.tree.map(jnp.asarray, m),
                        v=jax.tree.map(jnp.asarray, v),
                        master=(jax.tree.map(jnp.asarray, params) if master
                                else None))
    jp, jst2, jm = JA.adamw_update(JA.AdamWConfig(**jkw),
                                   jax.tree.map(jnp.asarray, grads), jst,
                                   jax.tree.map(jnp.asarray, params))
    tp = _torch(params)
    tst = A.AdamWState(step=torch.tensor(3, dtype=torch.int32), m=_torch(m),
                       v=_torch(v), master=_torch(params) if master else None)
    tg = _torch(grads)
    out, tst2, tm = A.adamw_update(A.AdamWConfig(**tkw), tg, tst, tp)
    assert out is tp                        # updated in place
    assert float(jm["grad_norm"]) > 1.0     # clipping is active
    want = float(jm["grad_norm"])
    assert abs(float(tm["grad_norm"]) - want) <= TOL * want
    assert abs(float(tm["lr"]) - float(jm["lr"])) <= LR_RTOL * float(jm["lr"])
    assert int(tst2.step) == int(jst2.step) == 4
    for name, (got, want) in {"params": (tp, jp), "m": (tst2.m, jst2.m),
                              "v": (tst2.v, jst2.v)}.items():
        for k in SHAPES:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=TOL, err_msg=f"{name} {k}")
    if master:
        for k in SHAPES:
            np.testing.assert_allclose(tst2.master[k].numpy(),
                                       np.asarray(jst2.master[k]), rtol=0,
                                       atol=TOL)


def test_decay_skips_1d_leaves_and_norms_match_jax():
    params = {"w": torch.ones(2, 2), "scale": torch.ones(4)}
    state = A.adamw_init(params)
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    A.adamw_update(A.AdamWConfig(lr=0.1, weight_decay=0.5, clip_norm=None),
                   zeros, state, params)
    assert float((params["scale"] - 1.0).abs().max()) < 1e-7
    assert float(params["w"].max()) < 1.0
    rng = np.random.default_rng(1)
    tree = _tree(rng, 5.0)
    want = float(JA.global_norm(jax.tree.map(jnp.asarray, tree)))
    assert abs(float(A.global_norm(_torch(tree))) - want) <= 1e-6 * want
    clipped, norm = A.clip_by_global_norm(_torch(tree), 1.0)
    jclipped, _ = JA.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    for k in SHAPES:
        np.testing.assert_allclose(clipped[k].numpy(),
                                   np.asarray(jclipped[k]), rtol=0, atol=TOL)


def test_schedules_equal_jax_at_every_step():
    pairs = [(S.constant(3e-4), JS.constant(3e-4)),
             (S.warmup_cosine(3e-4, 10, 100), JS.warmup_cosine(3e-4, 10, 100)),
             (S.warmup_cosine(1e-2, 2, 12, 0.2),
              JS.warmup_cosine(1e-2, 2, 12, 0.2)),
             (S.warmup_linear(5e-3, 7, 50), JS.warmup_linear(5e-3, 7, 50))]
    differ, worst = [], 0.0
    for fn, jfn in pairs:
        for step in range(0, 120):
            got = fn(torch.tensor(step, dtype=torch.int32))
            want = jfn(jnp.int32(step))
            assert got.dtype == torch.float32
            if float(got) != float(want):
                worst = max(worst, abs(float(got) / float(want) - 1.0))
                differ.append(step)
            assert abs(float(got) - float(want)) <= LR_RTOL * float(want), (
                step, float(got), float(want))
    # only the cosine's steps past the warmup may differ (torch's and
    # XLA's float32 cos round apart)
    assert all(step > 2 for step in differ), differ
    print(f"schedules: {len(differ)} steps differ, worst {worst:.3e}")


def test_quantize_int8_equals_jax():
    rng = np.random.default_rng(2)
    for x in (rng.standard_normal((64, 33)).astype(np.float32) * 7,
              np.zeros((5,), np.float32),
              np.array([1.0, -127.5, 0.5, 254.0], np.float32)):
        q, scale = C.quantize_int8(torch.tensor(x))
        jq, jscale = JC.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(scale) == float(jscale)
        np.testing.assert_array_equal(
            C.dequantize_int8(q, scale).numpy(),
            np.asarray(JC.dequantize_int8(jq, jscale)))
    ef = C.ef_init({"a": torch.ones(2, 3)})
    assert torch.equal(ef.residual["a"], torch.zeros(2, 3))
