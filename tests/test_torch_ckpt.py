"""Port parity: checkpoints in the JAX package's format, both ways.

A port ``TrainState`` written by ``repro_torch.checkpoint.ckpt`` (through
``convert.train_state_to_jax``) restores in JAX's ``ckpt.restore(like=
init_train_state(...)[0])`` leaf for leaf, bit for bit, and a JAX
checkpoint restores in the port; both at reduced recurrentgemma-2b of 8
layers (a stacked ``scan`` group of 2 repetitions and 2 remainder
layers) and seamless-m4t-medium (the encoder's ``enc_scan``).  Also: the
conversion's round trip is the identity, bfloat16 leaves cross both
ways, a torn checkpoint is ignored, the async checkpointer collects
garbage, and ``launch/serve.py --ckpt`` serves a JAX checkpoint.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64: the references get explicit float32)
from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.optim.adamw import AdamWState as JAdamWState
from repro.train.step import TrainState as JTrainState
from repro.train.step import init_train_state as j_init_train_state

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve as port_serve
from repro_torch.models import transformer as T
from repro_torch.serve.engine import LMEngine
from repro_torch.train.step import train_state

ARCHS = {"recurrentgemma-2b": 8, "seamless-m4t-medium": 2}


def _cfgs(arch):
    n = ARCHS[arch]
    return (reduced_config(get_config(arch), n_layers=n),
            j_reduced_config(j_get_config(arch), n_layers=n))


def _jax_state(arch, step):
    """JAX's init_train_state with moments and step made nonzero."""
    _, jcfg = _cfgs(arch)
    state, _ = j_init_train_state(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(step)
    noise = lambda t: jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), t)
    return JTrainState(state.params, JAdamWState(
        jnp.int32(step), noise(state.params), noise(state.params), None))


def _port_state(arch, jstate):
    cfg, _ = _cfgs(arch)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    state = train_state(convert.lm_params_from_jax(np_tree(jstate.params),
                                                   cfg))
    return convert.train_state_from_jax(
        JTrainState(np_tree(jstate.params), JAdamWState(
            np.asarray(jstate.opt.step), np_tree(jstate.opt.m),
            np_tree(jstate.opt.v), None)), cfg, state)


def _leaves_equal(a, b):
    """The same JAX checkpoint paths (JAX's own ``_flatten``, the port's
    ``flatten_paths``) and equal leaves of one dtype."""
    fa, fb = jckpt._flatten(a)[0], jckpt._flatten(b)[0]
    assert list(fa) == [k for k, _ in ckpt.flatten_paths(a)]
    assert sorted(fa) == sorted(fb)
    for key, xa in fa.items():
        xb = fb[key]
        assert xa.dtype == xb.dtype and xa.shape == xb.shape, key
        np.testing.assert_array_equal(xa, xb, err_msg=key)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_port_checkpoint_restores_in_jax_bit_equal(tmp_path, arch):
    cfg, jcfg = _cfgs(arch)
    jstate = _jax_state(arch, 5)
    state = _port_state(arch, jstate)
    # the port's state moves on: a perturbed weight and moment, step 6
    with torch.no_grad():
        state.params.embed.mul_(1.5)
        state.opt.m["final_norm.scale"].add_(0.25)
    state = state._replace(opt=state.opt._replace(
        step=torch.tensor(6, dtype=torch.int32)))
    tree = convert.train_state_to_jax(state, cfg)
    ckpt.save(tmp_path, 6, tree)
    like, _ = j_init_train_state(jax.random.PRNGKey(1), jcfg)
    got = jckpt.restore(tmp_path, like=like)
    _leaves_equal(got, tree)
    assert int(got.opt.step) == 6
    np.testing.assert_array_equal(
        np.asarray(got.params["embed"]), np.asarray(jstate.params["embed"])
        * np.float32(1.5))
    # the paths are JAX's own
    jckpt.save(tmp_path / "jax", 6, got)
    keys = lambda d: set(np.load(d / "step_0000000006" / "arrays.npz").files)
    assert keys(tmp_path) == keys(tmp_path / "jax")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_jax_checkpoint_restores_in_the_port_bit_equal(tmp_path, arch):
    cfg, _ = _cfgs(arch)
    jstate = _jax_state(arch, 7)
    jckpt.save(tmp_path, 7, jstate)
    # a port state from other weights, restored in place
    state = train_state(T.init_lm(cfg, torch.Generator().manual_seed(3),
                                  device="cpu"))
    assert ckpt.latest_step(tmp_path) == 7
    tree = ckpt.restore(tmp_path, like=convert.train_state_to_jax(state, cfg))
    state = convert.train_state_from_jax(tree, cfg, state)
    assert int(state.opt.step) == 7 and state.opt.step.dtype == torch.int32
    _leaves_equal(convert.train_state_to_jax(state, cfg),
                  jax.tree.map(np.asarray, jstate))


def test_conversion_round_trip_is_the_identity():
    for arch in ARCHS:
        cfg, jcfg = _cfgs(arch)
        params = jax.tree.map(np.asarray, _jax_state(arch, 1).params)
        model = convert.lm_params_from_jax(params, cfg)
        _leaves_equal(convert.lm_params_to_jax(model, cfg), params)
        named = convert.lm_named_from_jax(params, cfg)
        assert set(named) == {k for k, _ in model.named_parameters()}
        _leaves_equal(convert.lm_named_to_jax(named, cfg), params)
        state = _port_state(arch, _jax_state(arch, 2))
        again = convert.train_state_from_jax(
            convert.train_state_to_jax(state, cfg), cfg,
            train_state(T.init_lm(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")))
        _leaves_equal(convert.train_state_to_jax(again, cfg),
                      convert.train_state_to_jax(state, cfg))


def test_bfloat16_leaves_cross_both_ways(tmp_path):
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    tb = torch.tensor(x).to(torch.bfloat16)
    ckpt.save(tmp_path / "port", 1, {"w": tb, "n": {"i": np.int32(4)}})
    got = jckpt.restore(tmp_path / "port",
                        like={"w": jnp.zeros((3, 5), jnp.bfloat16),
                              "n": {"i": jnp.int32(0)}})
    assert got["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["w"], np.float32),
                                  tb.float().numpy())
    jckpt.save(tmp_path / "jax", 1, {"w": jnp.asarray(x, jnp.bfloat16)})
    back = ckpt.restore(tmp_path / "jax",
                        like={"w": torch.zeros(3, 5, dtype=torch.bfloat16)})
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], tb)
    up = ckpt.restore(tmp_path / "jax", like={"w": torch.zeros(3, 5)})
    assert up["w"].dtype == torch.float32 and torch.equal(up["w"], tb.float())


def test_torn_checkpoint_ignored_and_async_gc(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "t": (torch.zeros(2),
                                                        np.int32(7))}
    ckpt.save(tmp_path / "t", 1, tree)
    torn = tmp_path / "t" / "step_0000000009"
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"garbage")
    (tmp_path / "t" / "tmp.12").mkdir()
    assert ckpt.latest_step(tmp_path / "t") == 1
    out = ckpt.restore(tmp_path / "t", like=tree)
    assert torch.equal(out["a"], tree["a"]) and int(out["t"][1]) == 7
    assert isinstance(out["t"], tuple)
    saver = ckpt.AsyncCheckpointer(tmp_path / "g", keep=2)
    live = {"a": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        saver.save(s, live)
        live["a"].add_(1.0)          # the snapshot was taken at save
    saver.wait()
    steps = sorted(int(d.name.split("_")[1])
                   for d in (tmp_path / "g").iterdir()
                   if d.name.startswith("step_"))
    assert steps == [3, 4] and saver.last_saved == 4
    got = ckpt.restore(tmp_path / "g", 3, like={"a": torch.empty(4)})
    assert torch.equal(got["a"], torch.full((4,), 2.0))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "empty", like=tree)


def test_serve_launcher_serves_a_jax_checkpoint(tmp_path):
    """``launch/serve.py --ckpt`` on a checkpoint of JAX's trainer state:
    the tokens an engine gives on the JAX weights, not the random ones."""
    arch = "recurrentgemma-2b"
    cfg = reduced_config(get_config(arch))         # the launcher's --reduced
    jcfg = j_reduced_config(j_get_config(arch))
    state, _ = j_init_train_state(jax.random.PRNGKey(4), jcfg)
    jckpt.save(tmp_path, 3, state)
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "4"]
    got = port_serve.main(argv + ["--ckpt", str(tmp_path)])
    gen = torch.Generator().manual_seed(0)
    T.init_lm(cfg, gen, device="cpu")                # the launcher's draws
    prompt = torch.randint(0, cfg.vocab, (2, 8), generator=gen).numpy()
    model = convert.lm_params_from_jax(jax.tree.map(np.asarray, state.params),
                                       cfg)
    want = LMEngine(model, cfg, T.RunCfg(dtype=torch.float32), batch=2,
                    max_len=12).generate(prompt, 4)
    np.testing.assert_array_equal(got, want)
