#!/usr/bin/env python3
"""Time ``flash_attention``'s bfloat16 kernel against ablated copies of
its source, and optionally against another source of the same entry
point, on one NVIDIA GPU.

    python3 tools/flash_bf16_ablation.py [--variants a,b,...]
        [--baseline OTHER.cu] [--sass] [--reps N] [--rounds N]
        [--out FILE.json]

Each variant is ``src/repro_torch/csrc/flash_attention_bf16.cu`` with a
few lines replaced (``VARIANTS``), written under
``build/repro_torch/ablation/`` and built with the port's ``nvcc``
flags; all builds run at once.  ``--baseline`` builds another source
that defines ``flash_attention_launch_bf16`` (an earlier design of the
kernel, say) the same way.  Every build's ``[ptxas]`` lines are
``chip_smoke.print_ptxas``'s.

The kernel's holds against its plain version and its mirror are
``chip_smoke.py``'s; this tool only times.  Each build and
``scaled_dot_product_attention`` (``chip_smoke.sdpa_call``) run on the
same seeded bfloat16 inputs at the bfloat16 main paths' shapes
(``SHAPES``), timed with CUDA events (one warm-up, ``--reps``
launches) in ``--rounds`` rounds of alternating order (the card slows
as a call goes on), each reported with its median beside the smoke's
bound (4*hd operations a live pair over the bfloat16 tensor rate) and
the host time a launch.  Some variants' outputs are wrong by design
(they time what a part of the kernel costs); only the unchanged copy's
are compared with the package's build.  Prints one line a shape and
build, the card's name and power limit, and writes everything to
``--out``.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke  # noqa: E402

# name -> (text of the source, its replacement, times it occurs)
VARIANTS = {
    "kernel": (),
    # a block a q tile in place of the persistent grid
    "one-block-a-tile": (("(int)(tiles > sms ? (long)sms : tiles)",
                          "(int)tiles", 1),),
    # the consumers take no turns
    "no-pingpong": (('  asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : '
                     '"memory");\n', "", 1),
                    ('  asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : '
                     '"memory");\n', "", 1)),
    # exp2f in place of ex2.approx.ftz
    "exp2f": (('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
               "  y = exp2f(x);", 1),),
    # a third K/V stage at hd 64 and 128
    "stages3": (("static constexpr int BKV = 128, STAGES = 2;",
                 "static constexpr int BKV = 128, STAGES = 3;", 2),),
    # P = S: no softmax (wrong results)
    "no-softmax": (("float scale_log2) {\n",
                    "float scale_log2) {\n  corr[0] = corr[1] = 1.f;\n"
                    "  return;\n", 1),),
}
# (label, B, T, S, H, KVH, hd, causal, window): the bfloat16 main paths
SHAPES = (("chameleon-34b", 1, 4096, 4096, 64, 8, 128, True, None),
          ("qwen2.5-14b", 4, 4096, 4096, 40, 8, 128, True, None),
          ("qwen3-4b", 4, 4096, 4096, 32, 8, 128, True, None),
          ("recurrentgemma-2b", 4, 4096, 4096, 10, 1, 256, True, 2048),
          ("seamless encoder", 4, 4000, 4000, 16, 16, 64, False, None),
          ("seamless self", 4, 1000, 1000, 16, 16, 64, True, None),
          ("seamless cross", 4, 1000, 4000, 16, 16, 64, False, None))


def ablated(src, name, where):
    """The source of variant ``name`` written under ``where``."""
    text = src.read_text()
    for old, new, times in VARIANTS[name]:
        if text.count(old) != times:
            raise RuntimeError(f"variant {name}: {old!r} occurs "
                               f"{text.count(old)} times, not {times}")
        text = text.replace(old, new)
    out = where / f"{name}.cu"
    out.write_text(text)
    return out


def build(jobs):
    """Compile each (name, source, library path), all at once; returns
    ``{name: (path, nvcc output)}``."""
    from repro_torch.kernels import _build
    procs = {}
    for name, src, out in jobs:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    res = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        res[name] = (out, log)
    return res


def bind(torch, path):
    """``fn(q, k, v, causal, window) -> out`` through the library's
    ``flash_attention_launch_bf16``."""
    from repro_torch.kernels import flash_attention as FL
    lib = ctypes.CDLL(str(path))
    fn = lib.flash_attention_launch_bf16
    fn.argtypes = FL._ARGS
    fn.restype = ctypes.c_int

    def run(q, k, v, causal, window):
        B, T, H, hd = q.shape
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                 T, k.shape[1], H, k.shape[2], hd, int(causal),
                 0 if window is None else int(window), 1.0 / math.sqrt(hd),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{path.name}: CUDA error {err}")
        return out
    return run


def sass_histogram(path, kernel, top=25):
    """The most frequent SASS opcodes of one kernel of a library
    (``cuobjdump -sass``), or None where the tool is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300).stdout
    count, inside = collections.Counter(), False
    for ln in text.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
        elif inside:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9_.]*)", ln)
            if m:
                count[m.group(1)] += 1
    return count.most_common(top)


def host_us(torch, fn, reps=20):
    """Host microseconds a launch: ``reps`` calls enqueued back to back
    (the card runs behind, so the host clock times the enqueue)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / reps * 1e6


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass", action="store_true",
                    help="print each build's SASS opcode counts of the hd "
                         "128 causal kernel")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("flash_bf16_ablation: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FL
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)} torch={torch.__version__}"
          f" cuda={torch.version.cuda}; {smi}", flush=True)
    src = _build.CSRC / "flash_attention_bf16.cu"
    names = [v for v in args.variants.split(",") if v]
    where = _build.BUILD_DIR / "ablation"
    where.mkdir(parents=True, exist_ok=True)
    jobs = [(v, ablated(src, v, where), where / f"lib{v}.so") for v in names]
    if args.baseline:
        jobs.append(("baseline", pathlib.Path(args.baseline),
                     where / "libbaseline.so"))
    libs = build(jobs)
    for name, (_, log) in libs.items():
        smoke.print_ptxas(name, log)
    result = dict(card=smi, device=torch.cuda.get_device_name(0))
    runs = {name: bind(torch, path) for name, (path, _) in libs.items()}
    if args.sass:
        for name, (path, _) in libs.items():
            hist = sass_histogram(path,
                                  "flash_attention_bf16_kernelILi128ELb1E")
            print(f"[sass] {name} hd128 causal: {hist}", flush=True)
    builds = (["baseline"] if args.baseline else []) + names
    dev = torch.device("cuda")
    result["times"] = []
    for label, B, T, S, H, KVH, hd, causal, window in SHAPES:
        g = torch.Generator(device=dev).manual_seed(T + H)
        mk = lambda *s_: torch.randn(*s_, generator=g, device=dev).to(
            torch.bfloat16)
        q, k, v = mk(B, T, H, hd), mk(B, S, KVH, hd), mk(B, S, KVH, hd)
        kw = dict(causal=causal, window=window)
        pairs = smoke.live_pairs(np, T, S, causal, window) * B * H
        bound = 4 * hd * pairs / smoke.BF16_OPS_PER_S * 1e3
        want = FL.flash_attention(q, k, v, **kw)
        same = {name: bool(torch.equal(runs[name](q, k, v, causal, window),
                                       want))
                for name in ("kernel",) if name in runs}
        fns = {name: (lambda fn=runs[name]: fn(q, k, v, causal, window))
               for name in builds}
        fns["sdpa"] = smoke.sdpa_call(torch, q, k, v, kw)
        # rounds in alternating order: the card slows as a call goes on
        times = {name: [] for name in fns}
        for r in range(args.rounds):
            for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                times[name].append(smoke.cuda_ms(torch, fns[name],
                                                 args.reps))
        host = {name: host_us(torch, fns[name]) for name in builds}
        host["flash_attention"] = host_us(
            torch, lambda: FL.flash_attention(q, k, v, **kw))
        med = {name: statistics.median(ts) for name, ts in times.items()}
        rec = dict(shape=label, q=[B, T, H, hd], kv=[B, S, KVH, hd],
                   causal=causal, window=window, live_pairs=pairs,
                   bound_ms=bound, ms=times, median_ms=med,
                   host_us_a_launch=host, equal_to_package_build=same)
        result["times"].append(rec)
        for name, ts in times.items():
            print(f"[time] {label} {name}: median {med[name]:.4f} ms ("
                  f"{' / '.join(f'{t:.4f}' for t in ts)}); "
                  f"{bound / med[name]:.3f} of the bound {bound:.4f}, "
                  f"{med[name] / med['sdpa']:.2f}x sdpa", flush=True)
        print(f"[time] {label}: outputs equal to the package's build "
              f"{same}; host us a launch "
              f"{json.dumps({k_: round(v_, 1) for k_, v_ in host.items()})}",
              flush=True)
        del q, k, v, want, fns
        torch.cuda.empty_cache()
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(smi, flush=True)
    return 0 if all(all(r["equal_to_package_build"].values())
                    for r in result["times"]) else 1


if __name__ == "__main__":
    sys.exit(main())
