"""Port parity: the rank mesh on four gloo ranks on the CPU, against the
JAX package.

One spawn of four ranks for the module (``test_torch_mesh_worker.run``, a
``file://`` store under the module's temporary directory, one torch
thread a rank, the port only) runs every case; the JAX references are
computed in this process meanwhile:

* ``moe_dispatch`` on (2, 2): each rank's output within 1e-5 of max
  |out| of JAX's ``moe_dispatch`` on a 1 x 1 mesh applied to its data
  slice, at the config's capacity (tokens dropped alike: the capacity
  and the token-major ranks come from the local tokens); within JAX's
  3e-4 of ``moe_dense`` at ``capacity_factor=8`` (JAX's
  ``test_moe_dispatch_matches_dense_on_mesh``);
* ring attention at W = 1, 2, 4 in the three cases of JAX's
  ``test_context_parallel.py``: within 2e-5 of JAX's ``_attn_naive``
  and within 1e-5 of JAX's ``ring_attention_local`` under ``jax.vmap``;
* a (2, 2) ``make_train_step`` step of reduced qwen3-0.6b on JAX's test
  batch (``test_distributed.py``) against JAX's single-device step: the
  loss within 1e-5 relative and each gradient leaf within 1e-4 of its
  max |g| (PERF.md's card-vs-CPU bars); replicated parameters equal on
  every rank;
* ``lm_loss``'s gradient through ``moe_dispatch`` on (1, 2) meshes
  against the port's dense gradient on one process, at a capacity
  where nothing drops, at the same bars (each rank's experts against
  their slice);
* the 2-stage GPipe loss on JAX's pipeline config (internlm2-1.8b
  reduced to 4 layers, 3 microbatches) within 1e-5 relative of JAX's
  single-device mean, its gradients at the bars above;
* ``compressed_psum`` over 4 ranks against JAX's own function under
  ``jax.vmap(axis_name=)``, run op by op, twice (the residual fed
  back): equal;
* the launcher: ``--data 2 --model 2`` (its own spawn of ranks) gives
  ``--data 1 --model 1``'s final loss within 1e-5 relative, and
  ``--device cuda`` with fewer cards than ranks raises.
"""
import concurrent.futures
import dataclasses
import multiprocessing
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64: the references get explicit float32)
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import layers as JL
from repro.models.context_parallel import ring_attention_local as j_ring
from repro.models.sharding import MeshRules as JMeshRules
from repro.models.transformer import RunCfg as JRunCfg
from repro.models.transformer import init_lm as j_init_lm
from repro.models.transformer import lm_loss as j_lm_loss
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.compression import compressed_psum as j_compressed_psum
from repro.train.step import init_train_state as j_init_train_state
from repro.train.step import make_train_step as j_make_train_step

import test_torch_mesh_worker as worker
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import lm_named_from_jax, lm_params_from_jax
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T

WORLD = 4
JOIN_S = 240
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
RING_CASES = ((True, None), (False, None), (True, 48))


def _fast_jit(fn, *args):
    """``jax.jit(fn)`` compiled with XLA's backend optimisation off (faster
    to compile on the CPU, float32 results within an ulp)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _with_cf(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _jit_init(fn, key):
    """``fn(key)`` (a JAX init's params) compiled once with the backend
    optimisation off: the same draws as op by op, one compile instead of
    one an operation and shape."""
    return _fast_jit(fn, key)(key)


def _inputs():
    """Every case's inputs, numpy and port configs only (the ranks import
    no JAX), and what the references need; the JAX draws made in
    threads."""
    key = jax.random.PRNGKey(0)
    inp, ref = {}, {}
    moe_jcfg = j_reduced_config(j_get_config("dbrx-132b"))
    train_jcfg = j_reduced_config(j_get_config("qwen3-0.6b"))
    grad_jcfg = _with_cf(moe_jcfg, 8.0)
    pp_jcfg = dataclasses.replace(j_reduced_config(j_get_config(
        "internlm2-1.8b")), n_layers=4)

    def ring_draws(k):
        ks = jax.random.split(k, 3)
        B, S, KVH, G, hd = 2, 128, 2, 2, 16
        return (jax.random.normal(ks[0], (B, S, KVH, G, hd), jnp.float32),
                jax.random.normal(ks[1], (B, S, KVH, hd), jnp.float32),
                jax.random.normal(ks[2], (B, S, KVH, hd), jnp.float32))
    jobs = {
        # moe_dispatch: JAX's test's shapes (4 experts over tp 2, batch 4
        # over dp 2)
        "moe": lambda: _jit_init(lambda k: (
            JL.init_moe(k, moe_jcfg)[0],
            jax.random.normal(k, (4, 8, moe_jcfg.d_model), jnp.float32)),
            key),
        # ring attention: JAX's test's draws
        "ring": lambda: _jit_init(ring_draws, key),
        # the (2, 2) train step: JAX's test's config, weights and batch
        "train": lambda: (_jit_init(
            lambda k: j_init_train_state(k, train_jcfg)[0], key), {
            "tokens": jax.random.randint(key, (2, 4, 32), 0,
                                         train_jcfg.vocab),
            "targets": jax.random.randint(key, (2, 4, 32), 0,
                                          train_jcfg.vocab)}),
        # the dispatch gradient: reduced dbrx, nothing dropped
        "dispatch_grad": lambda: _jit_init(
            lambda k: j_init_lm(k, grad_jcfg)[0], key),
        # the pipeline: JAX's test's config, weights and batch
        "pipeline": lambda: (_jit_init(lambda k: j_init_lm(k, pp_jcfg)[0],
                                       key), {
            "tokens": jax.random.randint(key, (3, 2, 16), 0, pp_jcfg.vocab),
            "targets": jax.random.randint(jax.random.PRNGKey(1), (3, 2, 16),
                                          0, pp_jcfg.vocab)}),
    }
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futs = {name: pool.submit(fn) for name, fn in jobs.items()}
        got = {name: f.result() for name, f in futs.items()}
    cfg = reduced_config(get_config("dbrx-132b"))
    p, x = got["moe"]
    inp["moe"] = dict(cfg=cfg, cfg8=_with_cf(cfg, 8.0), params=_np_tree(p),
                      x=np.asarray(x))
    ref["moe"] = dict(jcfg=moe_jcfg, p=p, x=x)
    q, k, v = got["ring"]
    inp["ring"] = dict(q=np.asarray(q), k=np.asarray(k), v=np.asarray(v),
                       cases=RING_CASES)
    state, batch = got["train"]
    inp["train"] = dict(cfg=reduced_config(get_config("qwen3-0.6b")),
                        params=_np_tree(state.params),
                        batch=_np_tree(batch))
    ref["train"] = dict(jcfg=train_jcfg, state=state, batch=batch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, grad_jcfg.vocab, (2, 17)).astype(np.int64)
    inp["dispatch_grad"] = dict(cfg=_with_cf(cfg, 8.0),
                                params=_np_tree(got["dispatch_grad"]),
                                batch={"tokens": toks[:, :-1],
                                       "targets": toks[:, 1:]})
    params, batch = got["pipeline"]
    inp["pipeline"] = dict(
        cfg=dataclasses.replace(reduced_config(get_config("internlm2-1.8b")),
                                n_layers=4),
        params=_np_tree(params), batch=_np_tree(batch))
    ref["pipeline"] = dict(jcfg=pp_jcfg, params=params, batch=batch)
    # compressed_psum: 4 participants, two leaves
    rng = np.random.default_rng(2)
    inp["compress"] = dict(grads={
        "w": rng.standard_normal((WORLD, 64)).astype(np.float32),
        "b": (rng.standard_normal((WORLD, 3, 5)) * 1e-3).astype(np.float32)})
    return inp, ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the four ranks, compute the JAX references while they run,
    and collect each rank's results: ``(results by rank, inputs,
    references)``."""
    tmp = tmp_path_factory.mktemp("mesh_ranks")
    inp, ref = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run,
                         args=(r, WORLD, f"file://{tmp / 'store'}",
                               str(tmp / "inputs.pkl"), str(tmp)))
             for r in range(WORLD)]
    for pr in procs:
        pr.start()
    try:
        refs = _references(inp, ref)
        for pr in procs:
            pr.join(JOIN_S)
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join(10)
    res = {}
    for r in range(WORLD):
        path = tmp / f"{r}.pkl"
        res[r] = pickle.load(open(path, "rb")) if path.exists() else {}
    codes = [pr.exitcode for pr in procs]
    return res, inp, refs, codes


def _case(ranks, name):
    res, inp, refs, codes = ranks
    for r in range(WORLD):
        got = res[r].get(name)
        assert got is not None and "error" not in got, (
            f"rank {r} (exit codes {codes}): "
            + (got["error"] if got else "no result"))
    return [res[r][name] for r in range(WORLD)], inp[name], refs[name]


# --------------------------------------------------------------------- #
# the JAX references
# --------------------------------------------------------------------- #
def _references(inp, ref):
    """The JAX (and dense port) references of every case, their compiles
    run in threads (XLA compiles without the interpreter lock)."""
    run = JRunCfg(dtype=jnp.float32)

    def moe():
        r = ref["moe"]
        mesh11 = jax.make_mesh((1, 1), ("data", "model"))
        rules = JMeshRules(mesh=mesh11, fsdp=("data",), tp=("model",))
        disp = _fast_jit(lambda p, x: JL.moe_dispatch(
            p, x, r["jcfg"], rules, jnp.float32)[0], r["p"], r["x"][:2])
        return dict(
            cf=[np.asarray(disp(r["p"], r["x"][i:i + 2])) for i in (0, 2)],
            dense=np.asarray(JL.moe_dense(r["p"], r["x"], r["jcfg"],
                                          jnp.float32)[0]))

    def ring(W):
        # naive attention and JAX's ring body under vmap over W shards
        q, k, v = (jnp.asarray(inp["ring"][n]) for n in "qkv")
        pos = jnp.arange(q.shape[1])
        split = lambda a: a.reshape((a.shape[0], W, -1) + a.shape[2:]
                                    ).swapaxes(0, 1)
        out = {}
        for causal, window in RING_CASES:
            if W == 1:
                bias = JL._mask_bias(pos, pos, causal=causal, window=window)
                out[("naive", causal, window)] = np.asarray(JL._attn_naive(
                    q, k, v, bias))
            body = jax.vmap(lambda qq, kk, vv: j_ring(
                qq, kk, vv, "model", causal=causal, window=window),
                axis_name="model")
            args = (split(q), split(k), split(v))
            o = _fast_jit(body, *args)(*args)
            out[(W, causal, window)] = np.asarray(
                o.swapaxes(0, 1).reshape(q.shape))
        return out

    def train_loss():
        # JAX's single-device step: its loss and gradient norm
        r = ref["train"]
        step = _fast_jit(j_make_train_step(r["jcfg"], run, JAdamWConfig()),
                         r["state"], r["batch"])
        _, m = step(r["state"], r["batch"])
        return float(m["loss"]), float(m["grad_norm"])

    def train_grads():
        r = ref["train"]

        def mean_loss(params, batch):
            n = batch["tokens"].shape[0]
            return sum(j_lm_loss(params, jax.tree.map(lambda a: a[i], batch),
                                 r["jcfg"], run)[0] for i in range(n)) / n
        grads = _fast_jit(jax.grad(mean_loss), r["state"].params,
                          r["batch"])(r["state"].params, r["batch"])
        return lm_named_from_jax(_np_tree(grads), inp["train"]["cfg"])

    def pipeline():
        # JAX's single-device mean over the microbatches
        r = ref["pipeline"]
        lg = _fast_jit(jax.value_and_grad(lambda params, batch: mean_loss_pp(
            params, batch, r["jcfg"], run)), r["params"], r["batch"])
        loss, grads = lg(r["params"], r["batch"])
        return dict(loss=float(loss), grads=lm_named_from_jax(
            _np_tree(grads), inp["pipeline"]["cfg"]))

    jobs = {"moe": moe, "train_loss": train_loss, "train_grads": train_grads,
            "pipeline": pipeline, **{("ring", W): (lambda W=W: ring(W))
                                     for W in (1, 2, 4)}}
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futs = {name: pool.submit(fn) for name, fn in jobs.items()}
        got = {name: f.result() for name, f in futs.items()}
    out = {"moe": got["moe"], "pipeline": got["pipeline"], "ring": {}}
    for W in (1, 2, 4):
        out["ring"].update(got[("ring", W)])
    loss, norm = got["train_loss"]
    out["train"] = dict(loss=loss, grad_norm=norm, grads=got["train_grads"])
    # dispatch gradient: the port's dense gradient in this process
    d = inp["dispatch_grad"]
    model = lm_params_from_jax(d["params"], d["cfg"])
    model.requires_grad_(True)
    loss, _ = T.lm_loss(model, {k: torch.from_numpy(a) for k, a in
                                d["batch"].items()}, d["cfg"],
                        T.RunCfg(impl="naive", dtype=torch.float32))
    loss.backward()
    out["dispatch_grad"] = dict(loss=float(loss.detach()), grads={
        k: p.grad.numpy() for k, p in model.named_parameters()})
    # compressed_psum under vmap with 4 participants, twice
    g = {k: jnp.asarray(a) for k, a in inp["compress"]["grads"].items()}

    def twice(gg):
        red, ef = j_compressed_psum(gg, None, "data")
        red2, ef2 = j_compressed_psum(gg, ef, "data")
        return red, ef.residual, red2, ef2.residual
    # op by op: jit fuses g - q * scale into other roundings (1e-7 off)
    red, res, red2, res2 = jax.vmap(twice, axis_name="data")(g)
    out["compress"] = dict(red=_np_tree(red), res=_np_tree(res),
                           red2=_np_tree(red2), res2=_np_tree(res2))
    return out


def mean_loss_pp(params, batch, jcfg, run):
    """JAX's pipeline test's reference: single-device ``lm_loss``'s
    ``loss`` metric averaged over the microbatches."""
    n = batch["tokens"].shape[0]
    return sum(j_lm_loss(params, jax.tree.map(lambda a: a[i], batch), jcfg,
                         run)[1]["loss"] for i in range(n)) / n


def _close_grads(got, want, names=None):
    names = names if names is not None else want.keys()
    for name in names:
        w = np.asarray(want[name])
        gap = np.abs(got[name] - w).max()
        assert gap <= GRAD_TOL * max(np.abs(w).max(), 1e-12), (name, gap)


# --------------------------------------------------------------------- #
# the holds
# --------------------------------------------------------------------- #
def test_moe_dispatch_ranks_match_jax(ranks):
    got, inp, ref = _case(ranks, "moe")
    for r, out in enumerate(got):
        d = r // 2                           # the rank's data slice
        y, _ = out["cf"]
        want = ref["cf"][d]
        assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max(), r
        y8, _ = out["cf8"]
        np.testing.assert_allclose(y8, ref["dense"][2 * d:2 * d + 2],
                                   rtol=3e-4, atol=3e-4)
    # the capacity drops a token of data slice 1 (else nothing is held)
    assert np.abs(ref["cf"][1] - ref["dense"][2:]).max() > 1e-3
    # the tp ranks of a data slice agree bit for bit
    for d in (0, 2):
        assert np.array_equal(got[d]["cf"][0], got[d + 1]["cf"][0])


@pytest.mark.parametrize("W", (1, 2, 4))
def test_ring_attention_ranks_match_jax(ranks, W):
    got, _, ref = _case(ranks, "ring")
    for causal, window in RING_CASES:
        for out in got:
            o = out[(W, causal, window)]
            naive = ref[("naive", causal, window)]
            assert np.abs(o - naive).max() < 2e-5, (causal, window)
            ring = ref[(W, causal, window)]
            assert np.abs(o - ring).max() < 1e-5, (causal, window)


def test_train_step_on_2x2_matches_jax(ranks):
    got, inp, ref = _case(ranks, "train")
    want = ref["loss"]
    scale = min(1.0, 1.0 / max(ref["grad_norm"], 1e-12))    # JAX's clip
    clipped = {k: g * scale for k, g in ref["grads"].items()}
    for out in got:
        assert abs(out["loss"] - want) <= LOSS_RTOL * abs(want)
        assert abs(out["grad_norm"] - ref["grad_norm"]) <= \
            LOSS_RTOL * ref["grad_norm"]
        _close_grads(out["grads"], clipped)
    # replicated parameters got the same update on every rank
    for out in got[1:]:
        for name, p in out["params"].items():
            assert np.array_equal(p, got[0]["params"][name]), name


def test_dispatch_gradient_matches_dense(ranks):
    got, inp, ref = _case(ranks, "dispatch_grad")
    want = ref["grads"]
    for out in got:
        assert abs(out["loss"] - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
        lo, hi = out["experts"]
        assert hi - lo == 2                  # 4 experts over tp 2
        for name, g in out["grads"].items():
            w = want[name]
            if name.rsplit(".", 1)[-1] in ("wi", "wg", "wo") and \
                    ".moe." in name:
                w = w[lo:hi]
            gap = np.abs(g - w).max()
            assert gap <= GRAD_TOL * max(np.abs(w).max(), 1e-12), (name, gap)
        assert set(out["grads"]) == set(want)


def test_pipeline_two_stages_match_jax(ranks):
    got, inp, ref = _case(ranks, "pipeline")
    want = ref["loss"]
    seen = set()
    for out in got:
        assert abs(out["loss"] - want) <= LOSS_RTOL * abs(want)
        assert abs(out["step_loss"] - want) <= LOSS_RTOL * abs(want)
        _close_grads(out["grads"], ref["grads"], out["grads"].keys())
        seen |= set(out["grads"])
    assert seen == set(ref["grads"])         # every leaf held by a stage
    assert {out["stage"] for out in got} == {0, 1}


def test_compressed_psum_ranks_match_jax(ranks):
    got, inp, ref = _case(ranks, "compress")
    for r, out in enumerate(got):
        for key in ("red", "res", "red2", "res2"):
            for leaf, a in out[key].items():
                assert np.array_equal(a, ref[key][leaf][r]), (key, leaf)


def test_train_launcher_2x2_matches_1x1(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    base = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "32"]
    one = launch_train.main(base + ["--ckpt", str(tmp_path / "a")])
    four = launch_train.main(base + ["--ckpt", str(tmp_path / "b"),
                                     "--data", "2", "--model", "2"])
    assert abs(four["final_loss"] - one["final_loss"]) <= \
        LOSS_RTOL * abs(one["final_loss"])
    assert (tmp_path / "b" / "step_0000000003").exists()


def test_train_launcher_refuses_too_few_cards(tmp_path):
    with pytest.raises(RuntimeError, match="4 ranks on device 'cuda' need 4 "
                       "cards"):
        launch_train.main(["--arch", "qwen3-0.6b", "--reduced", "--device",
                           "cuda", "--steps", "1", "--data", "2", "--model",
                           "2", "--ckpt", str(tmp_path)])
