"""Port parity: the training path on the CPU against the JAX package.

* ``lru_scan``'s gradient (``torch.autograd.Function``, its plain
  backward here) against ``jax.vjp`` of JAX's ``_linear_scan_chunked``
  and against autograd through ``lru_scan_plain``.
* ``lm_loss``: value and every gradient against JAX's
  ``jax.value_and_grad(lm_loss)``, on JAX's ``init_lm(PRNGKey(0))``
  weights carried across by ``lm_params_from_jax``, for four reduced
  archs: internlm2-1.8b (JAX's ``test_train_loop.py``), recurrentgemma-2b
  with 3 layers (two RG-LRU layers through the scan, one local
  attention), dbrx-132b (the MoE: its load-balancing term must match)
  and seamless-m4t-medium (the encoder-decoder), with a token mask;
  and with ``impl="flash"`` (the port's ``flash_attention`` Function
  against JAX's autodiff of ``_attn_flash``) for internlm2-1.8b (causal
  GQA), recurrentgemma-2b (a local window) and seamless-m4t-medium
  (bidirectional and cross).  One JAX compile an arch and impl (a
  module-scoped fixture).
* ``remat``: ``full`` and ``dots`` give ``none``'s loss and gradients.
* Three steps of ``make_train_step`` with ``n_micro=2`` against JAX's.
* The data sources bit-equal to JAX's; the trainer's restart bit for
  bit, and its loss falling over 20 steps (JAX's ``test_train_loop``).

Tolerances: the loss within 1e-5 relative, each gradient within 1e-4 of
its leaf's largest ``|g|`` (float32 sums in other orders; measured:
below 1.5e-7 and 2.5e-6); the scan's gradient within 1e-5; the
3-step loss trajectory within 1e-4 relative (AdamW's first step is
about ``lr * sign(g)``, so a parameter whose gradient is near 0 may move
either way; the losses, not the parameters, are held, and the gradient
norm at the first step only, within 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64: the references get explicit float32)
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.data.pipeline import MemmapSource as JMemmapSource
from repro.data.pipeline import SyntheticSource as JSyntheticSource
from repro.models.layers import _linear_scan_chunked
from repro.models.transformer import RunCfg as JRunCfg
from repro.models.transformer import init_lm as j_init_lm
from repro.models.transformer import lm_loss as j_lm_loss
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as j_make_train_step
from repro.optim.adamw import adamw_init as j_adamw_init

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import lm_named_from_jax, lm_params_from_jax
from repro_torch.data.pipeline import (MemmapSource, Prefetcher,
                                       SyntheticSource, make_batches)
from repro_torch.kernels import lru_scan as LS
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import make_train_step, train_state
from repro_torch.train.trainer import TrainerConfig, train

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
B, S, S_ENC = 2, 32, 24
JRUN = JRunCfg(dtype=jnp.float32, impl="naive")
RUN = T.RunCfg(dtype=torch.float32, impl="naive")
# arch -> reduced depth
ARCHS = {"internlm2-1.8b": 2, "recurrentgemma-2b": 3, "dbrx-132b": 2,
         "seamless-m4t-medium": 2}
# the archs held with impl="flash" too: causal GQA, a local window,
# bidirectional and cross attention
FLASH_ARCHS = ("internlm2-1.8b", "recurrentgemma-2b", "seamless-m4t-medium")


def _fast_jit(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with XLA's backend (LLVM)
    optimisation off: the same HLO program, 2-3x faster to compile on the
    CPU, its float32 results within an ulp of the optimised build's
    (internlm2's loss: one ulp), far inside the bounds here."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _cfgs(arch):
    n = ARCHS[arch]
    return (reduced_config(get_config(arch), n_layers=n),
            j_reduced_config(j_get_config(arch), n_layers=n))


def _batch_np(cfg, seed=0, lead=()):
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


def _port_model(params_np, cfg):
    model = lm_params_from_jax(params_np, cfg)
    model.requires_grad_(True)
    return model


def _port_grads(model, batch, cfg, run=RUN):
    for p in model.parameters():
        p.grad = None
    loss, metrics = T.lm_loss(model, batch, cfg, run)
    loss.backward()
    return loss.detach(), metrics, {
        k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def refs():
    made = {}

    def get(arch, impl="naive"):
        if (arch, impl) not in made:
            cfg, jcfg = _cfgs(arch)
            params, _ = j_init_lm(jax.random.PRNGKey(0), jcfg)
            batch = _batch_np(cfg)
            jrun = JRunCfg(dtype=jnp.float32, impl=impl)
            jbatch = jax.tree.map(jnp.asarray, batch)
            fn = _fast_jit(jax.value_and_grad(
                lambda p, b: j_lm_loss(p, b, jcfg, jrun), has_aux=True),
                params, jbatch)
            (loss, metrics), grads = fn(params, jbatch)
            params_np = jax.tree.map(np.asarray, params)
            made[arch, impl] = dict(
                cfg=cfg, params=params_np, batch=batch, loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=lm_named_from_jax(jax.tree.map(np.asarray, grads), cfg))
        return made[arch, impl]
    return get


# --------------------------------------------------------------------- #
# the scan's gradient
# --------------------------------------------------------------------- #
def test_lru_scan_gradient_matches_jax_vjp_and_plain_autograd():
    rng = np.random.default_rng(3)
    Bx, Tx, Wx = 2, 64, 48
    a = rng.uniform(0.5, 1.0, (Bx, Tx, Wx)).astype(np.float32)
    b = rng.standard_normal((Bx, Tx, Wx)).astype(np.float32)
    h0 = rng.standard_normal((Bx, Wx)).astype(np.float32)
    dh_seq = rng.standard_normal((Bx, Tx, Wx)).astype(np.float32)
    dh_last = rng.standard_normal((Bx, Wx)).astype(np.float32)
    _, vjp = jax.vjp(lambda a_, b_, h_: _linear_scan_chunked(a_, b_, h_, 16),
                     *map(jnp.asarray, (a, b, h0)))
    want = vjp((jnp.asarray(dh_seq), jnp.asarray(dh_last)))

    xs = [torch.tensor(x, requires_grad=True) for x in (a, b, h0)]
    h_seq, h_last = LS.lru_scan(*xs)
    assert h_seq.grad_fn is not None
    torch.autograd.backward((h_seq, h_last),
                            (torch.tensor(dh_seq), torch.tensor(dh_last)))
    for name, x, w in zip(("da", "db", "dh0"), xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=name)
    ys = [torch.tensor(x, requires_grad=True) for x in (a, b, h0)]
    torch.autograd.backward(LS.lru_scan_plain(*ys),
                            (torch.tensor(dh_seq), torch.tensor(dh_last)))
    for name, x, y in zip(("da", "db", "dh0"), xs, ys):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_lru_scan_gradient_when_one_output_is_unused():
    """Autograd hands ``None`` for an output that took no part in the
    loss, or expanded zeros: the backward materialises them."""
    rng = np.random.default_rng(5)
    a, b, h0 = (torch.tensor(rng.uniform(0.5, 1.0, s).astype(np.float32),
                             requires_grad=True)
                for s in ((1, 9, 5), (1, 9, 5), (1, 5)))
    h_seq, h_last = LS.lru_scan(a, b, h0)
    h_last.sum().backward()            # h_seq unused; dh_last expanded ones
    da, db, dh0 = LS.lru_scan_backward_plain(
        a.detach(), h0.detach(), h_seq.detach(), torch.zeros(1, 9, 5),
        torch.ones(1, 5))
    for got, want in ((a.grad, da), (b.grad, db), (h0.grad, dh0)):
        assert torch.equal(got, want)
    assert LS.LAUNCHES["lru_scan_backward"] == 0     # the plain version


# --------------------------------------------------------------------- #
# lm_loss and its gradients
# --------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "arch,impl", [(a, "naive") for a in ARCHS]
    + [(a, "flash") for a in FLASH_ARCHS],
    ids=list(ARCHS) + [f"{a}-flash" for a in FLASH_ARCHS])
def test_lm_loss_and_gradients_match_jax(refs, arch, impl):
    """``impl="naive"``: JAX's trainer's attention; ``impl="flash"``:
    ``flash_attention``'s Function (its plain versions here) against
    JAX's autodiff of ``_attn_flash``, at the same bounds."""
    ref = refs(arch, impl)
    cfg = ref["cfg"]
    model = _port_model(ref["params"], cfg)
    loss, metrics, grads = _port_grads(
        model, _torch_batch(ref["batch"]), cfg,
        T.RunCfg(dtype=torch.float32, impl=impl))
    assert abs(float(loss) - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    for name in ("loss", "aux_loss", "tokens"):
        assert abs(float(metrics[name].detach()) - ref["metrics"][name]) <= \
            LOSS_RTOL * max(abs(ref["metrics"][name]), 1e-6), name
    if cfg.moe is not None:
        assert ref["metrics"]["aux_loss"] > 0
    assert set(grads) == set(ref["grads"])
    for name, want in ref["grads"].items():
        scale = float(np.abs(want).max())
        gap = float(np.abs(grads[name].numpy() - want).max())
        assert gap <= GRAD_TOL * max(scale, 1e-12), (name, gap, scale)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "dbrx-132b"])
def test_remat_full_and_dots_give_the_same_loss_and_gradients(refs, arch):
    ref = refs(arch)
    cfg = ref["cfg"]
    model = _port_model(ref["params"], cfg)
    batch = _torch_batch(ref["batch"])
    base = _port_grads(model, batch, cfg)
    for remat in ("full", "dots"):
        loss, _, grads = _port_grads(model, batch, cfg, T.RunCfg(
            dtype=torch.float32, impl="naive", remat=remat))
        assert torch.equal(loss, base[0]), remat
        for name, g in grads.items():
            assert torch.equal(g, base[2][name]), (remat, name)


def test_training_refuses_flash_and_dispatch(refs):
    """``impl="flash"`` trains (``flash_attention``'s Function): its loss
    and gradients equal ``impl="naive"``'s within 1e-5 (relative; each
    gradient of its leaf's max |g|), and it still runs under
    ``no_grad``.  Expert dispatch without mesh rules runs dense, as
    JAX's ``_apply_block`` does: reduced dbrx-132b's loss and gradients
    equal ``moe_impl="dense"``'s bit for bit, and JAX's loss.  An unknown
    ``remat`` is refused."""
    ref = refs("internlm2-1.8b")
    cfg = ref["cfg"]
    model = _port_model(ref["params"], cfg)
    batch = _torch_batch(ref["batch"])
    naive = _port_grads(model, batch, cfg)
    loss, _, grads = _port_grads(model, batch, cfg, T.RunCfg(
        dtype=torch.float32, impl="flash"))
    assert abs(float(loss) - float(naive[0])) <= 1e-5 * abs(float(naive[0]))
    for name, g in grads.items():
        want = naive[2][name]
        assert (g - want).abs().max().item() <= 1e-5 * max(
            want.abs().max().item(), 1e-12), name
    with torch.no_grad():            # serving-style calls still run it
        T.lm_loss(model, batch, cfg,
                  T.RunCfg(dtype=torch.float32, impl="flash"))
    moe = refs("dbrx-132b")
    mcfg = moe["cfg"]
    mmodel = _port_model(moe["params"], mcfg)
    mbatch = _torch_batch(moe["batch"])
    dense = _port_grads(mmodel, mbatch, mcfg)
    loss, _, grads = _port_grads(mmodel, mbatch, mcfg, T.RunCfg(
        dtype=torch.float32, impl="naive", moe_impl="dispatch"))
    assert torch.equal(loss, dense[0])
    assert abs(float(loss) - moe["loss"]) <= LOSS_RTOL * abs(moe["loss"])
    for name, g in grads.items():
        assert torch.equal(g, dense[2][name]), name
    with pytest.raises(ValueError, match="remat"):
        T.lm_loss(model, batch, cfg, T.RunCfg(
            dtype=torch.float32, impl="naive", remat="all"))


def test_kernels_without_backward_refuse_grad_on_cpu():
    """The pricing kernels have no backward: on inputs that require grad,
    in grad mode, they raise on the CPU as on the card, rather than return
    an output without a ``grad_fn``.  ``flash_attention`` has one (an
    autograd Function): its output carries a ``grad_fn`` there."""
    from repro_torch.kernels import binomial_step as TB
    from repro_torch.kernels import flash_attention as TF
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = torch.randn(1, 8, 1, 16)
    out = TF.flash_attention(q, k, k)
    assert out.grad_fn is not None and out.shape == q.shape
    out.sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    with torch.no_grad():
        assert TF.flash_attention(q, k, k).grad_fn is None
    assert TF.flash_attention(q.detach(), k, k).grad_fn is None
    v = torch.zeros(1, 8, dtype=torch.float64, requires_grad=True)
    sc = torch.tensor([[7.0, 0.5, 0.99, 1.0, 1.0, 0.1]], dtype=torch.float64)
    with pytest.raises(RuntimeError, match="no backward"):
        TB.lattice_round(v, sc, levels=2, block=8)


def test_three_train_steps_with_microbatches_match_jax(refs):
    """``make_train_step`` with ``n_micro=2`` and JAX's AdamW defaults
    (clipping at 1.0 active: the reduced model's gradient norm is above
    it), from JAX's weights and its zero state, on the same batches."""
    ref = refs("internlm2-1.8b")
    cfg = ref["cfg"]
    _, jcfg = _cfgs("internlm2-1.8b")
    opt = dict(lr=1e-3)
    batches = [_batch_np(cfg, seed=10 + i, lead=(2,)) for i in range(3)]
    jparams = jax.tree.map(jnp.asarray, ref["params"])
    jstate = JTrainState(jparams, j_adamw_init(jparams))
    jstep = _fast_jit(j_make_train_step(jcfg, JRUN, JAdamWConfig(**opt)),
                      jstate, jax.tree.map(jnp.asarray, batches[0]))
    state = train_state(_port_model(ref["params"], cfg))
    step = make_train_step(cfg, RUN, AdamWConfig(**opt))
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, _torch_batch(b))
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= 1e-4 * abs(want), i
        if i == 0:      # later norms follow the parameters' first moves
            want = float(jm["grad_norm"])
            assert abs(float(m["grad_norm"]) - want) <= LOSS_RTOL * want
            assert want > 1.0
        assert float(m["lr"]) == float(jm["lr"])
        assert int(m["step"]) == int(jm["step"]) == i + 1


# --------------------------------------------------------------------- #
# data sources
# --------------------------------------------------------------------- #
def test_data_sources_bit_equal_to_jax(tmp_path):
    for kw in (dict(vocab=512, global_batch=4, seq_len=16, n_micro=2,
                    seed=3), dict(vocab=256000, global_batch=2,
                                  seq_len=1024, seed=0)):
        src, jsrc = SyntheticSource(**kw), JSyntheticSource(**kw)
        for step in (0, 1, 7, 2 ** 20):
            got, want = src.batch(step), jsrc.batch(step)
            for k in ("tokens", "targets"):
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
    path = tmp_path / "corpus.bin"
    np.random.default_rng(1).integers(0, 1000, 5000).astype(
        np.int32).tofile(path)
    src = MemmapSource(str(path), 1000, 4, 31, n_micro=2)
    jsrc = JMemmapSource(str(path), 1000, 4, 31, n_micro=2)
    for step in (0, 3, 100):
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(src.batch(step)[k],
                                          jsrc.batch(step)[k])


def test_make_batches_resumes_and_prefetcher_follows(tmp_path):
    src = SyntheticSource(vocab=100, global_batch=2, seq_len=8)
    it = make_batches(src, device="cpu")
    first = [next(it) for _ in range(5)]
    resumed = make_batches(src, device="cpu", start_step=3)
    for step, b in (next(resumed), next(resumed)):
        assert torch.equal(b["tokens"], first[step][1]["tokens"])
        assert b["tokens"].dtype == torch.int32 and b["tokens"].is_contiguous()
    pf = Prefetcher(src, device="cpu", depth=2, start_step=2)
    try:
        for want in (2, 3, 4):
            step, b = next(pf)
            assert step == want
            assert torch.equal(b["targets"], first[step][1]["targets"])
    finally:
        pf.stop()
    assert not pf.thread.is_alive()


# --------------------------------------------------------------------- #
# the trainer (JAX's tests/test_train_loop.py)
# --------------------------------------------------------------------- #
TRAIN_CFG = reduced_config(get_config("internlm2-1.8b"))


def _tc(tmp, **kw):
    base = dict(steps=12, global_batch=4, seq_len=32, n_micro=2,
                peak_lr=5e-3, warmup=2, ckpt_every=4, log_every=100,
                ckpt_dir=str(tmp))
    base.update(kw)
    return TrainerConfig(**base)


def _train(tc):
    return train(TRAIN_CFG, tc, log=lambda *a: None, device="cpu")


def test_trainer_loss_decreases_over_20_steps(tmp_path):
    out = _train(_tc(tmp_path / "a", steps=20))
    assert len(out["losses"]) == 20
    assert np.mean(out["losses"][-3:]) < np.mean(out["losses"][:3])
    assert ckpt.latest_step(tmp_path / "a") == 20


def test_trainer_restart_bit_exact(tmp_path):
    """Killed at step 8 (simulated), resumed from the step-8 checkpoint:
    steps 8..11 give the uninterrupted run's losses bit for bit."""
    ref = _train(_tc(tmp_path / "ref"))
    with pytest.raises(RuntimeError, match="simulated node failure"):
        _train(_tc(tmp_path / "kill", simulate_failure_at=8))
    assert ckpt.latest_step(tmp_path / "kill") == 8
    logs = []
    resumed = train(TRAIN_CFG, _tc(tmp_path / "kill"), log=logs.append,
                    device="cpu")
    assert "[trainer] resumed from step 8" in logs
    assert resumed["losses"] == ref["losses"][-4:]
    assert resumed["final_loss"] == ref["final_loss"]
