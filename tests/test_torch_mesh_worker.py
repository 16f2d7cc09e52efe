"""The ranks of ``tests/test_torch_mesh_ranks.py`` (no tests of its own).

``run(rank, world, store, inp, out)`` is one gloo rank of a 4-rank world
on the CPU: it joins the group over a ``file://`` store, reads the cases'
inputs (numpy, written by the test module from the JAX package's
weights and draws), runs every case through the port's rank-mesh code
and writes its results to ``out/<rank>.pkl``.  It imports the port
only, never JAX, and runs one torch thread.
"""
import os
import pickle
import traceback

import torch


def _np(t):
    return t.detach().cpu().numpy().copy()


def _grads(model, names=None):
    return {k: _np(p.grad) for k, p in model.named_parameters()
            if p.grad is not None and (names is None or k in names)}


def case_moe(inp, meshes):
    """moe_dispatch on (2, 2): the config's capacity and capacity 8."""
    from repro_torch.launch.mesh import mesh_rules
    from repro_torch.models import layers as L
    rules = mesh_rules(meshes["2x2"])
    out = {}
    for label, cfg in (("cf", inp["cfg"]), ("cf8", inp["cfg8"])):
        E = cfg.moe.num_experts
        p = L.MoE(cfg, device="cpu", experts=rules.expert_slice(E))
        with torch.no_grad():
            for k, v in inp["params"].items():
                w = torch.from_numpy(v)
                getattr(p, k).copy_(w[p.experts] if k != "router" else w)
        x = torch.from_numpy(inp["x"])[rules.dp_slice(inp["x"].shape[0])]
        y, aux = L.moe_dispatch(p, x, cfg, rules, torch.float32)
        out[label] = (_np(y), float(aux))
    return out


def case_ring(inp, meshes):
    """make_ring_attention at W = 1, 2, 4 in the three cases."""
    from repro_torch.models.context_parallel import make_ring_attention
    q, k, v = (torch.from_numpy(inp[n]) for n in "qkv")
    out = {}
    for W, mesh in ((1, meshes["4x1"]), (2, meshes["2x2"]),
                    (4, meshes["1x4"])):
        for causal, window in inp["cases"]:
            fn = make_ring_attention(mesh, "model", causal=causal,
                                     window=window)
            with torch.no_grad():
                out[(W, causal, window)] = _np(fn(q, k, v))
    return out


def case_train(inp, meshes):
    """One make_train_step step of reduced qwen3-0.6b on (2, 2)."""
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.launch.mesh import mesh_rules
    from repro_torch.models.transformer import RunCfg
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step, train_state
    cfg = inp["cfg"]
    state = train_state(lm_params_from_jax(inp["params"], cfg))
    step = make_train_step(cfg, RunCfg(impl="naive", dtype=torch.float32),
                           AdamWConfig(), mesh_rules(meshes["2x2"]))
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    state, m = step(state, batch)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                grads=_grads(state.params),
                params={k: _np(p) for k, p in
                        state.params.named_parameters()})


def case_dispatch_grad(inp, meshes):
    """lm_loss's gradient through moe_dispatch on two (1, 2) meshes (the
    rows of a (2, 2) mesh, no data axis): each tp rank's experts."""
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models.sharding import MeshRules
    from repro_torch.models.transformer import RunCfg, lm_loss, local_experts
    cfg = inp["cfg"]
    rules = MeshRules(mesh=meshes["2x2"], fsdp=(), tp=("model",))
    run = RunCfg(impl="naive", dtype=torch.float32, moe_impl="dispatch")
    model = lm_params_from_jax(inp["params"], cfg,
                               experts=local_experts(cfg, run, rules))
    model.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    loss, m = lm_loss(model, batch, cfg, run, rules)
    loss.backward()
    return dict(loss=float(loss.detach()), aux=float(m["aux_loss"].detach()),
                experts=(model.blocks[0].moe.experts.start,
                         model.blocks[0].moe.experts.stop),
                grads=_grads(model))


def case_pipeline(inp, meshes):
    """The 2-stage GPipe loss and gradients on (pod 2, data 2)."""
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models.transformer import RunCfg
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.pipeline import make_pp_loss, make_pp_train_step
    from repro_torch.train.step import train_state
    cfg = inp["cfg"]
    mesh = meshes["pod2x2"]
    run = RunCfg(impl="naive", dtype=torch.float32)
    state = train_state(lm_params_from_jax(inp["params"], cfg))
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    loss = float(make_pp_loss(cfg, run, mesh, stages=2)(state.params, batch))
    step = make_pp_train_step(cfg, run, AdamWConfig(clip_norm=None), mesh,
                              stages=2)
    _, m = step(state, batch)
    stage = mesh.get_local_rank("pod")
    owned = {k for k, p in state.params.named_parameters()
             if p.grad is not None}
    return dict(loss=loss, step_loss=float(m["loss"]),
                grad_norm=float(m["grad_norm"]), stage=stage,
                grads=_grads(state.params, owned))


def case_compress(inp, meshes):
    """compressed_psum over 4 ranks, twice (the residual fed back)."""
    import torch.distributed as dist
    from repro_torch.optim.compression import compressed_psum
    r = dist.get_rank()
    g = {k: torch.from_numpy(v[r]) for k, v in inp["grads"].items()}
    red, ef = compressed_psum(g, None, meshes["4"], "data")
    red2, ef2 = compressed_psum(g, ef, meshes["4"], "data")
    cv = lambda d: {k: _np(v) for k, v in d.items()}
    return dict(red=cv(red), res=cv(ef.residual), red2=cv(red2),
                res2=cv(ef2.residual))


CASES = {"moe": case_moe, "ring": case_ring, "train": case_train,
         "dispatch_grad": case_dispatch_grad, "pipeline": case_pipeline,
         "compress": case_compress}


def run(rank, world, store, inp, out):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks, make_rank_mesh
    init_ranks("cpu", rank=rank, world_size=world, init_method=store)
    res = {}
    try:
        with open(inp, "rb") as f:
            cases = pickle.load(f)
        meshes = {name: make_rank_mesh(shape, axes, "cpu")
                  for name, shape, axes in (
                      ("2x2", (2, 2), ("data", "model")),
                      ("4x1", (4, 1), ("data", "model")),
                      ("1x4", (1, 4), ("data", "model")),
                      ("pod2x2", (2, 2), ("pod", "data")),
                      ("4", (4,), ("data",)))}
        for name, fn in CASES.items():
            try:
                res[name] = fn(cases[name], meshes)
            except Exception:
                # the case's test reports it; the other ranks are stopped
                res[name] = {"error": traceback.format_exc()}
                raise
    finally:
        with open(os.path.join(out, f"{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.destroy_process_group()
