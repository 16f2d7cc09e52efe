"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 100 [--reduced] [--device cpu]

The port of the JAX package's ``launch/train.py``, with its flags and
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).  The loop checkpoints (in JAX's format, every 20 steps and at
the last) and resumes from ``--ckpt`` automatically
(``train/trainer.py``); ``--fail-at N`` raises at step N, and running
the same command again resumes.  ``--data`` / ``--model`` above 1 ask for a device mesh, which
waits for the mesh slice (ROADMAP Queue A), as does ``--moe-impl
dispatch``.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import get_config, reduced_config
from ..models.transformer import RunCfg
from ..train.trainer import TrainerConfig, train


def main(argv=None):
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
    args = ap.parse_args(argv)

    if args.data * args.model > 1:
        raise NotImplementedError(
            f"--data {args.data} --model {args.model}: training on a device "
            "mesh waits for the mesh slice (ROADMAP Queue A: "
            "models/sharding.py, train/pipeline.py)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    run = RunCfg(impl="naive", dtype=torch.float32, remat=args.remat,
                 moe_impl=args.moe_impl)
    tc = TrainerConfig(steps=args.steps, global_batch=args.batch,
                       seq_len=args.seq, n_micro=args.micro,
                       peak_lr=args.lr, ckpt_dir=args.ckpt,
                       simulate_failure_at=args.fail_at)
    out = train(cfg, tc, run, device=args.device)
    print(f"final loss: {out['final_loss']:.4f} ({out['final_loss']!r})")
    return out


if __name__ == "__main__":
    main()
