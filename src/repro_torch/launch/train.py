"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 100 [--reduced] [--data D] [--model M] [--device cpu]

The port of the JAX package's ``launch/train.py``, with its flags and
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).  The loop checkpoints (in JAX's format, every 20 steps and at
the last) and resumes from ``--ckpt`` automatically
(``train/trainer.py``); ``--fail-at N`` raises at step N, and running
the same command again resumes.

``--data D --model M`` above 1 x 1 train on a ``(D, M)`` rank mesh
(``models/sharding.py``): the launcher starts ``D * M`` rank processes
itself (spawned, over a ``file://`` store; one card a rank on
``cuda``, which raises where the host has fewer cards; gloo ranks on
``cpu``), or, started by ``torchrun --nproc-per-node D*M``, is one rank
of them.  ``--moe-impl dispatch`` then runs the MoE archs' experts
split over the model axis (``moe_dispatch``).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

import torch

from ..configs import get_config, reduced_config
from ..models.transformer import RunCfg
from ..train.trainer import TrainerConfig, train


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=TrainerConfig().ckpt_dir)
    ap.add_argument("--remat", default="none",
                    choices=["none", "full", "dots"])
    ap.add_argument("--moe-impl", default="dense",
                    choices=["dense", "dispatch"])
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a simulated failure at this step")
    ap.add_argument("--device", default="cuda")
    return ap


def _train(args, rules=None, device=None) -> dict:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    run = RunCfg(impl="naive", dtype=torch.float32, remat=args.remat,
                 moe_impl=args.moe_impl)
    tc = TrainerConfig(steps=args.steps, global_batch=args.batch,
                       seq_len=args.seq, n_micro=args.micro,
                       peak_lr=args.lr, ckpt_dir=args.ckpt,
                       simulate_failure_at=args.fail_at)
    return train(cfg, tc, run, rules, device=device or args.device)


def _rank(rank: int, world: int, init_method, args, out: str = "") -> dict:
    """One rank of the mesh: join the group, train; returns the metrics,
    which rank 0 also writes to ``out`` where given."""
    import torch.distributed as dist
    from .mesh import init_ranks, make_rank_mesh, mesh_rules
    if torch.device(args.device).type == "cpu" and \
            "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = init_ranks(args.device, rank=rank, world_size=world,
                     init_method=init_method)
    try:
        mesh = make_rank_mesh((args.data, args.model), ("data", "model"),
                              args.device)
        res = _train(args, mesh_rules(mesh), dev)
        if dist.get_rank() == 0 and out:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()
    return res


def main(argv=None):
    args = _parser().parse_args(argv)
    world = args.data * args.model
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # one rank under torchrun: its environment names the group
        res = _rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                    None, args)
    elif world > 1:
        from .mesh import check_cards
        check_cards(args.device, world)
        tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
        try:
            out = os.path.join(tmp, "metrics.json")
            torch.multiprocessing.start_processes(
                _rank, args=(world, "file://" + os.path.join(tmp, "store"),
                             args, out),
                nprocs=world, join=True, start_method="spawn")
            with open(out) as f:
                res = json.load(f)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    else:
        res = _train(args)
    print(f"final loss: {res['final_loss']:.4f} ({res['final_loss']!r})")
    return res


if __name__ == "__main__":
    main()
