"""What JAX's op-by-op bfloat16 activations cost on the card.

    PYTHONPATH=src python tools/bf16_activation_cost.py [--reps 3]

``models/layers.py`` computes ``silu`` and ``gelu`` in bfloat16 as the
primitives of JAX's graph, each rounded to bfloat16 (``x * (1 / (1 +
exp(-x)))``; the tanh form of gelu), where ``F.silu`` and ``F.gelu``
would compute in float32 and round once.  For qwen3-4b (swiglu) and
recurrentgemma-2b (gated gelu, and gelu in the RG-LRU block) at their
published width and depth, weights stored in bfloat16, this times a
prefill of batch 4 x 4096 tokens and the mean of 8 decode steps after
it, with the layers' activations as they are ("composed") and with them
replaced by ``F.silu`` / ``F.gelu(approximate="tanh")`` ("fused"), in
the order composed, fused, composed, fused ... (``--reps`` pairs), on
CUDA events, and counts the kernels of one decode step under
``torch.profiler``.  Prints one JSON object a line, the card's name and
power limit first.
"""
import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCHS = ("qwen3-4b", "recurrentgemma-2b")
BATCH, PROMPT, STEPS = 4, 4096, 8
COMPOSED = {"silu": L.silu, "gelu": L.gelu}
FUSED = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


def timed(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def one(model, cfg, run, tokens):
    """Prefill ms, decode ms a step (mean of ``STEPS``)."""
    (_, cache), pre_ms = timed(lambda: T.prefill(
        model, {"tokens": tokens[:, :PROMPT]}, cfg, run,
        max_len=PROMPT + STEPS))
    dec = []
    for i in range(STEPS):
        (_, cache), ms = timed(lambda: T.decode_step(
            model, cache, tokens[:, PROMPT + i:PROMPT + i + 1], PROMPT + i,
            cfg, run))
        dec.append(ms)
    return pre_ms, sum(dec) / len(dec)


def decode_kernels(model, cfg, run, tokens):
    _, cache = T.prefill(model, {"tokens": tokens[:, :PROMPT]}, cfg, run,
                         max_len=PROMPT + 1)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        T.decode_step(model, cache, tokens[:, PROMPT:PROMPT + 1], PROMPT,
                      cfg, run)
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip()}), flush=True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    run = T.RunCfg(impl="flash", dtype=torch.bfloat16)
    for arch in ARCHS:
        cfg = get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        model = T.init_lm(cfg, gen, device=dev, dtype=torch.bfloat16)
        tokens = torch.randint(0, cfg.vocab, (BATCH, PROMPT + STEPS),
                               generator=gen, device=dev)
        times = {"composed": [], "fused": []}
        kernels = {}
        with torch.no_grad():
            one(model, cfg, run, tokens)                # warm-up
            for _ in range(args.reps):
                for name, fns in (("composed", COMPOSED), ("fused", FUSED)):
                    L.silu, L.gelu = fns["silu"], fns["gelu"]
                    times[name].append(one(model, cfg, run, tokens))
            for name, fns in (("composed", COMPOSED), ("fused", FUSED)):
                L.silu, L.gelu = fns["silu"], fns["gelu"]
                kernels[name] = decode_kernels(model, cfg, run, tokens)
        L.silu, L.gelu = COMPOSED["silu"], COMPOSED["gelu"]
        out = {"arch": arch, "batch": BATCH, "prompt": PROMPT,
               "decode_steps": STEPS, "reps": args.reps}
        for name, rows in times.items():
            out[name] = {"prefill_ms": [p for p, _ in rows],
                         "decode_ms_per_step": [d for _, d in rows],
                         "decode_kernels_per_step": kernels[name]}
        print(json.dumps(out), flush=True)
        del model, tokens
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
