"""The rank mesh across the cards of one host.

    PYTHONPATH=src python tools/mesh_cards.py [--world W] [--device cpu]

Starts one rank a card (``launch/mesh.py``: NCCL, spawned over a
``file://`` store; ``--device cpu`` runs gloo ranks, with the reduced
configs, as a rehearsal) and runs, on world ``W`` (default: the cards
the host has):

* **dispatch**: dbrx-132b, 3 of its 40 layers at full width, float32
  weights drawn from seed 0 on every rank, its experts split over a
  ``(1, W)`` mesh (``16 / W`` a card).  Rank 0 also keeps the whole
  model and runs ``moe_dense``: the dispatch prefill at capacity ``E /
  top_k`` (nothing dropped) against dense's last logits, relative to
  their max |logit| (``chip_smoke.DISPATCH_REL_TOL``'s 2.5e-4); then
  the serve through ``LMEngine(rules=)`` at the config's capacity (batch
  1, prompt 4096, 32 tokens), with dense's serve on rank 0 alone beside
  it.
* **ring**: causal attention over a sequence of ``4096 * W`` split over
  the ``W`` ranks (``make_ring_attention``; 8 KV heads of 128, G = 4),
  against rank 0's plain attention of the whole sequence (2e-5).
* **pipeline** (even ``W``): qwen3-0.6b at full width and depth in two
  GPipe stages over a ``(2, W / 2)`` ``(pod, data)`` mesh, 4 microbatches
  of 2 x 1024 tokens: the pipelined loss within 1e-5 relative of rank
  0's single-device mean of ``lm_loss`` over the microbatches, and one
  ``make_pp_train_step`` timed.
* **compress**: ``compressed_psum`` over the ``W`` ranks on the cards
  against the same call on host copies (gloo): bit for bit.
* **train**: the launcher's data-parallel run, ``--data W --model 1``
  against ``--data 1 --model 1`` on qwen3-0.6b reduced (3 steps), the
  final loss within 1e-5 relative.

Prints the card's name and power limit, then one JSON object a line
from rank 0 (``{"part": ...}``).  Holds raise (the ranks exit non-zero).
"""
import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

DISPATCH_REL_TOL = 2.5e-4
RING_TOL = 2e-5


def _say(rank, **rec):
    if rank == 0:
        print(json.dumps(rec), flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dispatch(rank, world, dev, reduced):
    import torch.distributed as dist
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.convert import is_expert_leaf
    from repro_torch.launch.mesh import make_rank_mesh, mesh_rules
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import LMEngine
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=3)
    B, P, N = 1, 4096, 32
    if reduced:
        cfg = reduced_config(cfg, n_layers=3)
        P, N = 64, 4
    rules = mesh_rules(make_rank_mesh((1, world), ("data", "model"),
                                      dev.type))
    e = cfg.moe
    run = T.RunCfg(impl="flash", dtype=torch.float32, moe_impl="dispatch")
    gen = torch.Generator(device=dev).manual_seed(0)
    full = T.init_lm(cfg, gen, device=dev)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    part = T.LM(cfg, device=dev, experts=rules.expert_slice(e.num_experts))
    with torch.no_grad():
        for name, p in part.named_parameters():
            src = full.get_parameter(name)
            sliced = is_expert_leaf(name) and p.shape != src.shape
            p.copy_(src[part.blocks[0].moe.experts] if sliced else src)
    dense = None
    if rank == 0:
        dense, _ = T.prefill(full, {"tokens": prompt}, cfg,
                             dataclasses.replace(run, moe_impl="dense"))
        eng = LMEngine(full, cfg, dataclasses.replace(run, moe_impl="dense"),
                       batch=B, max_len=P + N)
        dense_tokens = eng.generate(prompt.cpu().numpy(), N)
        dense_tm = eng.timings
    del full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        e, capacity_factor=e.num_experts / e.top_k))
    last, _ = T.prefill(part, {"tokens": prompt}, nodrop, run, rules=rules)
    eng = LMEngine(part, cfg, run, batch=B, max_len=P + N, rules=rules)
    eng.generate(prompt.cpu().numpy(), N)            # warm-up
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tokens = eng.generate(prompt.cpu().numpy(), N)
    tm = eng.timings
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
            else None)
    dist.barrier()
    if rank == 0:
        d = float((last - dense).abs().max())
        tol = DISPATCH_REL_TOL * float(dense.abs().max())
        _say(rank, part="dispatch", arch=cfg.name, layers=cfg.n_layers,
             world=world, experts_a_rank=e.num_experts // world,
             check_max_abs=d, check_tol=tol, prefill_s=tm["prefill_s"],
             decode_ms=tm["decode_s"] / tm["decode_steps"] * 1e3,
             dense_prefill_s=dense_tm["prefill_s"],
             dense_decode_ms=dense_tm["decode_s"] / dense_tm["decode_steps"]
             * 1e3, peak_device_gb_rank0=peak,
             same_first_token=bool(tokens[0, 0] == dense_tokens[0, 0]))
        if not d <= tol:
            raise AssertionError(f"dispatch vs dense {d} > {tol}")


def _ring(rank, world, dev, reduced):
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models.context_parallel import make_ring_attention
    from repro_torch.models.layers import _attn_naive, _mask_bias
    mesh = make_rank_mesh((1, world), ("data", "model"), dev.type)
    B, KVH, G, hd = 1, 8, 4, 128
    Sl = 4096
    if reduced:
        KVH, G, hd, Sl = 2, 2, 16, 64
    S = Sl * world
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(B, S, KVH, G, hd, generator=gen, device=dev)
    k = torch.randn(B, S, KVH, hd, generator=gen, device=dev)
    v = torch.randn(B, S, KVH, hd, generator=gen, device=dev)
    fn = make_ring_attention(mesh, "model", causal=True)
    with torch.no_grad():
        fn(q, k, v)
        _sync(dev)
        t = time.perf_counter()
        out = fn(q, k, v)
        _sync(dev)
        ring_s = time.perf_counter() - t
        if rank == 0:
            pos = torch.arange(S, device=dev)
            want = torch.cat([_attn_naive(
                q[:, i:i + Sl], k, v, _mask_bias(pos[i:i + Sl], pos,
                                                 causal=True, window=None))
                for i in range(0, S, Sl)], dim=1)
            d = float((out - want).abs().max())
            _say(rank, part="ring", world=world, seq=S, seq_a_rank=Sl,
                 shape=[B, S, KVH, G, hd], ring_s=ring_s, max_abs=d,
                 tol=RING_TOL)
            if not d <= RING_TOL:
                raise AssertionError(f"ring vs plain {d} > {RING_TOL}")


def _pipeline(rank, world, dev, reduced):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import SyntheticSource, to_device
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.pipeline import make_pp_loss, make_pp_train_step
    from repro_torch.train.step import train_state
    cfg = get_config("qwen3-0.6b")
    S = 1024
    if reduced:
        cfg, S = reduced_config(cfg, n_layers=4), 32
    mesh = make_rank_mesh((2, world // 2), ("pod", "data"), dev.type)
    run = T.RunCfg(impl="flash", remat="full", dtype=torch.float32)
    model = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    batch = to_device(SyntheticSource(cfg.vocab, 8, S, n_micro=4).batch(0),
                      dev)
    batch = {k: batch[k] for k in ("tokens", "targets")}
    with torch.no_grad():
        loss = float(make_pp_loss(cfg, run, mesh, stages=2)(model, batch))
        want = None
        if rank == 0:
            want = sum(float(T.lm_loss(model, {k: v[i] for k, v in
                                               batch.items()}, cfg, run)[1]
                             ["loss"]) for i in range(4)) / 4
    step = make_pp_train_step(cfg, run, AdamWConfig(), mesh, stages=2)
    state = train_state(model)
    step(state, batch)                               # warm-up
    _sync(dev)
    t = time.perf_counter()
    _, m = step(state, batch)
    _sync(dev)
    step_s = time.perf_counter() - t
    if rank == 0:
        rel = abs(loss - want) / abs(want)
        _say(rank, part="pipeline", world=world, stages=2,
             layers=cfg.n_layers, micro=4, tokens_a_micro=2 * S,
             loss=loss, single_device=want, rel=rel, step_s=step_s,
             step_loss=float(m["loss"]))
        if not rel <= 1e-5:
            raise AssertionError(f"pipeline vs single device {rel}")


def _compress(rank, world, dev):
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.optim.compression import compressed_psum
    mesh = make_rank_mesh((world,), ("data",), dev.type)
    gen = torch.Generator().manual_seed(10 + rank)
    g = {"w": torch.randn(1024, 1024, generator=gen)}
    outs = []
    for d in ((dev, "cpu") if dev.type == "cuda" else ("cpu",)):
        red, ef = compressed_psum({k: t.to(d) for k, t in g.items()}, None,
                                  mesh, "data")
        outs.append([red["w"].cpu(), ef.residual["w"].cpu()])
    equal = all(torch.equal(a, b) for a, b in zip(outs[0], outs[-1]))
    _say(rank, part="compress", world=world, bit_equal_card_vs_host=equal)
    if not equal:
        raise AssertionError("compressed_psum card vs host")


def _rank(rank, world, store, device, reduced):
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cpu":
        torch.set_num_threads(1)
    dev = init_ranks(device, rank=rank, world_size=world, init_method=store)
    try:
        parts = [("dispatch", _dispatch), ("ring", _ring)]
        if world % 2 == 0:
            parts.append(("pipeline", _pipeline))
        for name, fn in parts:
            t = time.perf_counter()
            fn(rank, world, dev, reduced)
            _say(rank, part=f"{name} wall", s=time.perf_counter() - t)
        _compress(rank, world, dev)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        print(smi.splitlines()[0] if smi else "nvidia-smi gave no output",
              flush=True)
    world = args.world or (torch.cuda.device_count() if args.device == "cuda"
                           else 4)
    reduced = args.device == "cpu"
    if args.device == "cuda":
        # built once here, not by every rank at its first launch
        from repro_torch.kernels._build import build_all
        build_all(["flash_attention", "flash_attention_bwd"])
    tmp = tempfile.mkdtemp(prefix="mesh_cards_")
    try:
        torch.multiprocessing.start_processes(
            _rank, args=(world, "file://" + os.path.join(tmp, "store"),
                         args.device, reduced),
            nprocs=world, join=True, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    from repro_torch.launch import train as launch_train
    base = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "3", "--batch",
            str(2 * world), "--device", args.device]
    outs = {}
    for label, flags in (("1x1", []), (f"{world}x1", ["--data", str(world)])):
        ck = tempfile.mkdtemp(prefix="mesh_cards_ckpt_")
        try:
            t = time.perf_counter()
            outs[label] = (launch_train.main(base + flags + ["--ckpt", ck]),
                           time.perf_counter() - t)
        finally:
            shutil.rmtree(ck, ignore_errors=True)
    a, b = (outs[k][0]["final_loss"] for k in outs)
    rel = abs(a - b) / abs(a)
    print(json.dumps({"part": "train launcher", "world": world,
                      "final_loss_1x1": a, f"final_loss_{world}x1": b,
                      "rel": rel, "wall_s": {k: v[1] for k, v in
                                             outs.items()}}), flush=True)
    if not rel <= 1e-5:
        raise AssertionError(f"launcher {world}x1 vs 1x1: {rel}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
