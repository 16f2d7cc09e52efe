"""LM serving launcher: prefill + batched greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
        --batch 4 --prompt-len 4096 --new-tokens 32

The port of the JAX package's ``launch/serve.py``, with the same flags
and ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).  It serves from random weights drawn from a seeded generator
on the device; for an encoder-decoder arch (``seamless-m4t-medium``,
whose audio frontend is a stub) it also draws ``(batch, prompt_len,
d_model)`` frame embeddings from that generator, as JAX's launcher
does.  ``--ckpt DIR`` serves the parameters of the newest checkpoint
under ``DIR``, written by ``repro_torch.launch.train`` or by the JAX
package's trainer (the same format and paths).
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import convert
from ..checkpoint import ckpt as ckpt_lib
from ..configs import get_config, reduced_config
from ..core.device import resolve_device
from ..models.transformer import RunCfg, init_lm
from ..serve.engine import LMEngine
from ..train.step import TrainState


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_lm(cfg, gen, device=dev)
    if args.ckpt:
        # the parameters' paths alone: TrainState(params, opt=None)
        like = TrainState(convert.lm_params_to_jax(model, cfg), None)
        state = ckpt_lib.restore(args.ckpt, like=like)
        convert.load_lm_params(model, state.params, cfg)
        print(f"restored params from {args.ckpt}")
    max_len = args.prompt_len + args.new_tokens
    eng = LMEngine(model, cfg, RunCfg(dtype=torch.float32), batch=args.batch,
                   max_len=max_len)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev).cpu().numpy()
    enc = None
    if cfg.n_encoder_layers and cfg.frontend == "audio_stub":
        # the stub frontend's frame embeddings, as many as prompt tokens
        enc = torch.randn(args.batch, args.prompt_len, cfg.d_model,
                          generator=gen, device=dev)

    t0 = time.perf_counter()
    out = eng.generate(prompt, args.new_tokens, enc_embeds=enc)
    dt = time.perf_counter() - t0
    for b in range(args.batch):
        print(f"seq {b}: {out[b].tolist()}")
    print(f"{args.batch}x{args.new_tokens} tokens in {dt:.2f}s on {dev} "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s; prefill "
          f"{eng.timings['prefill_s']:.3f}s)")
    return out


if __name__ == "__main__":
    main()
