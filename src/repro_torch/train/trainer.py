"""Training loop with checkpoint/restart.

The port of the JAX package's ``train/trainer.py``, on one device or,
with mesh ``rules``, as one rank of a mesh (``launch/train.py`` starts
the ranks):

  * **checkpoint/restart**: an ``AsyncCheckpointer`` every
    ``ckpt_every`` steps and at the last step, in JAX's format (a
    checkpoint of either package resumes in the other); on (re)start the
    trainer restores the newest complete checkpoint and the stateless
    data source seeks to that step, so a killed run resumes bit for bit.
    ``simulate_failure_at`` raises at that step to exercise the path.
  * **straggler log**: per-step wall times feed an EWMA; a step slower
    than ``straggler_factor`` times it is logged.
  * **mesh**: every rank draws the same weights from the seed (keeping
    its experts where ``moe_dispatch`` runs, ``local_experts``), reads
    the same stateless batches and takes its ``dp`` slice
    (``train/step.py``).  Checkpoints hold whole arrays, as JAX's do:
    the experts' slices are gathered over ``tp`` and rank 0 writes;
    a restore takes each rank's slice, so a checkpoint of one mesh
    resumes on another (elastic restore).

The default ``RunCfg(impl="naive", dtype=torch.float32)`` is JAX's
trainer's; ``run=RunCfg(impl="flash", ...)`` trains through
``flash_attention`` and its backward kernel, as JAX's ``train`` takes a
flash ``RunCfg``.  JAX's trainer does not call ``compressed_psum``; nor
does the port's (``optim/compression.py`` has it).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Optional

import torch

from .. import convert
from ..checkpoint import ckpt as ckpt_lib
from ..configs.base import ModelConfig
from ..core.device import resolve_device
from ..data.pipeline import SyntheticSource, to_device
from ..models.transformer import RunCfg, local_experts
from ..optim.adamw import AdamWConfig
from ..optim.schedule import warmup_cosine
from .step import init_train_state, make_train_step

__all__ = ["TrainerConfig", "train"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    n_micro: int = 1
    peak_lr: float = 3e-4
    warmup: int = 10
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    log_every: int = 10
    seed: int = 0
    straggler_factor: float = 3.0
    simulate_failure_at: Optional[int] = None


def train(cfg: ModelConfig, tc: TrainerConfig, run: Optional[RunCfg] = None,
          rules=None, log=print, device="cuda") -> dict:
    """Runs (or resumes) training on ``device`` (with ``rules``, this
    rank's card); returns final metrics: ``final_loss``, ``losses``
    (this run's), ``last_step``, ``grad_norm``.  ``run`` defaults to
    JAX's trainer's ``RunCfg(impl="naive", dtype=torch.float32)``;
    ``impl="flash"`` differentiates ``flash_attention`` (its backward
    kernel on the card).  Under ``rules`` only rank 0 logs and writes
    checkpoints; every rank returns the same metrics."""
    run = run or RunCfg(impl="naive", dtype=torch.float32)
    dev = resolve_device(device)
    experts = local_experts(cfg, run, rules)
    gather = None
    lead = True
    if rules is not None:
        import torch.distributed as dist
        from ..models.sharding import all_gather
        lead = dist.get_rank() == 0
        if experts is not None:
            gather = lambda t: all_gather(t, rules.mesh, rules.tp)
    if not lead:
        log = lambda *a, **k: None
    gen = torch.Generator(device=dev).manual_seed(tc.seed)
    state = init_train_state(cfg, gen, device=dev, experts=experts)
    opt_cfg = AdamWConfig(lr=warmup_cosine(tc.peak_lr, tc.warmup, tc.steps))
    step_fn = make_train_step(cfg, run, opt_cfg, rules)

    start_step = 0
    latest = ckpt_lib.latest_step(tc.ckpt_dir)
    if latest is not None:
        tree = ckpt_lib.restore(tc.ckpt_dir, latest,
                                like=convert.train_state_to_jax(state, cfg,
                                                                gather))
        state = convert.train_state_from_jax(tree, cfg, state, experts)
        start_step = latest
        log(f"[trainer] resumed from step {start_step}")

    source = SyntheticSource(vocab=cfg.vocab, global_batch=tc.global_batch,
                             seq_len=tc.seq_len, n_micro=tc.n_micro,
                             seed=tc.seed)
    saver = ckpt_lib.AsyncCheckpointer(tc.ckpt_dir)

    ewma = None
    losses = []
    metrics = {}
    for step in range(start_step, tc.steps):
        if tc.simulate_failure_at is not None and step == tc.simulate_failure_at:
            saver.wait()
            raise RuntimeError(f"simulated node failure at step {step}")
        batch = to_device(source.batch(step), dev)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > tc.straggler_factor * ewma and step > start_step + 2:
            log(f"[straggler] step {step} took {dt:.3f}s vs EWMA {ewma:.3f}s")
        losses.append(loss)
        if step % tc.log_every == 0:
            log(f"[trainer] step {step} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        if (step + 1) % tc.ckpt_every == 0 or step + 1 == tc.steps:
            tree = convert.train_state_to_jax(state, cfg, gather)
            if lead:
                saver.save(step + 1, tree)
    saver.wait()
    return {"final_loss": losses[-1] if losses else None,
            "losses": losses, "last_step": tc.steps,
            "grad_norm": float(metrics["grad_norm"]) if losses else None}
