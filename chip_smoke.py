#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``src/repro_torch/csrc`` (one ``nvcc`` per
source, started together), holds each kernel against its plain PyTorch
version on the card at the main path's shapes (float64: the lattice
kernel bit for bit, also on edge cases at small rows; ``rz_round`` to
1e-9 with identical knot counts, also on edge cases of its tile
schedule, with its widest round timed at capacities 16, 48 and 128);
the kernels' float32 instances against their float32 plain versions at
the same shapes (``[kernel] ... float32``: the lattice kernels equal, NaN
for NaN; ``rz_round`` within the port registry's 1e-4, knot counts
printed); and ``flash_attention`` against its arithmetic mirror at the
float32 contract's 2e-6 (``[kernel] flash_attention mirror``, small
shapes); then drives the port's
main path through ``repro_torch.api.price_grid`` with the default
backend (the kernels):

* a 256-contract transaction-cost grid of the paper's American put at
  its depth (N=1500, PWL capacity 48);
* a 256-contract transaction-cost grid of calls and bull spreads at
  capacity 48 and N=120, where their knot counts still fit (the
  paper's bull spread needs more than 128 knots at N=1500);
* a 256-contract friction-free grid at the paper's appendix depth
  (N=40000), and the single-contract appendix price.

It checks the launch counts of that run, ask >= bid, the knot counts
against the capacity, a subset of each grid re-priced by the plain
level walk (``backend="torch"``) and small inputs against the numpy
oracle, and prints how a call's knot count grows with N.  Then the
float32 main paths, each with its launches counted from 0 (``[main]
price_notc_kernel float32``: the appendix put at the policy's default
dtype on the card; ``[main] float32 TC put``: the TC grid's rows through
``rz_backward_kernel(dtype=float32)``; ``[main] node axis float32``: both
node-axis builders on 1 x 1 and 1 x 4 of cuda:0, bit-equal), each beside
its float64 result.

Then the LSMC engine (``engine="lsmc"``, plain PyTorch: no TPU kernel
stands behind it): the two grids of Longstaff & Schwartz (2001) Table 1
(American puts, 100,000 antithetic paths, Laguerre degree 3, T=1 at N=50
and T=2 at N=100) and 64 Bermudan basket puts of 5 assets, each timed
after a warm-up with its peak device memory, and each held against the
same rows priced on the host (``[check] LSMC ... card vs host``: both
draw JAX's threefry normals, so ask and bid within 1e-9, the gap also
given in combined standard errors); the sampler's uniforms bit-equal on
the card and the host at the T=1 grid's shape, its normals within
1e-12 relative (``[check] LSMC normals card vs host``); the estimator
within 3
standard errors of the lattice kernel's price (``[check] LSMC vs
lattice``); the TC put, no-TC and LSMC grids (and the LSMC grid padded)
under ``devices=1``, ``devices=4`` (simulated on one card) and
``mesh=(cuda:0,) * 4`` (the real per-shard dispatch), held bit for bit
(``[check] layout``, with each layout's kernel launches counted from 0).

Then the node axis (``core/distributed.py::build_rz_sharded`` and
``build_notc_sharded``, the paper's §4 halo rounds): ``rz_round`` and
``lattice_round`` with ``lane0 > 0`` (and ``owned`` below the lanes) at
the shapes of a shard of the 1 x 4 axis, against their plain versions
(``[kernel] rz_round lane0``, ``[kernel] lattice_round lane0``); the
paper's 256 puts (N=1500, K=48, L=5) on meshes 1 x 1, 1 x 2 and 1 x 4
of cuda:0 (and of distinct cards where the machine has them), and 256
friction-free puts (N=40000, L=50) on 1 x 4, each held to
``price_flat`` on the same rows (1e-9, equal ``max_pieces``), with its
launches, halo bytes a round and peak memory (``[main] node axis``),
and the device's busy time over one more run of each 1 x 4 on cuda:0
(``[profile] node axis``).
Then ``python -m repro_torch.launch.price`` as a subprocess: ``--grid
--engine lsmc --devices 4``, and the node axis ``--model 4`` (``[main]
launcher``).

Then the pricing service on the card (``repro_torch.serve``): a
2048-request trace shuffled from a seed (1536 friction-free
put/call/bull-spread requests at N=1500, 256 friction-free puts at
N=40000, 256 transaction-cost puts at N=1500, K=48) through
``PricingService(max_batch=256, deadline_ms=5, capacity=48)`` driven by
``launch/serve_pricing.py::drive`` as fast as it goes, counting the
kernels' launches of that run, then at half the measured rate (``[main]
pricing service``); every quote against its bucket priced in one
``price_flat`` call (``[check] service vs price_flat``, 1e-9 and equal
``row_pieces``); the same trace through ``PricingGateway`` with two
thread replicas on cuda:0, then two spawned worker processes with a
real SIGKILL of replica 0 at its first chunk (``[main] pricing
gateway``: every quote delivered and equal to the service's); a
192-row ``StreamingBook`` through ``run_stream`` on 64 synthetic ticks,
held to a full reprice (``[main] streaming book``); and ``python -m
repro_torch.launch.serve_pricing`` as a subprocess, the service and then
the process-pool gateway with a crash (``[main] serve launcher``).

Then it serves recurrentgemma-2b at its published width (26 layers,
d_model 2560, random weights from a seeded generator on the card,
float32) through ``repro_torch.serve.engine.LMEngine``: batch 4, a
4096-token prompt, 32 greedy tokens.  It holds ``flash_attention``
(split-TF32 products on the tensor cores) against its plain version on
the inputs that the first local-attention layer receives in that
prefill (float32, max abs difference <= 2e-5), and on seeded inputs at
head_dim 128 and without the causal mask, and ``lru_scan`` against its
plain version, bit for bit, on the inputs of the first RG-LRU layer, on
seeded inputs of the same shape whose decay is slow (a in (0.9, 1), h0
nonzero; the model's random init decays so fast that its own inputs
leave the carry a_t * h_{t-1} below one ulp of h) and on edge shapes
(B = 1, T shorter than the kernel's ring chunk, W not a multiple of its
32 channels).  It prints the attention kernel's bound on the tensor
cores beside the FFMA bound of the same work, times
``scaled_dot_product_attention`` with the same window mask as a
yardstick, checks the launch counts of the serve (8
``flash_attention`` and 18 ``lru_scan`` a prefill, none in decode), and
that a prefill of 4096 tokens and a decode of token 4096 give a prefill
of 4097's last logits (the kernels' ragged last tile).  Last it
profiles one prefill and four decode steps (``torch.profiler``): device
time by kernel and the device's idle share within the profiled window.

Then the same serve, checks and profile for two more architectures at
their published width and depth, each with random float32 weights
drawn on the card and freed before the next: falcon-mamba-7b (64 mamba
layers, d_model 4096, d_state 16; batch 2, prompt 4096, 32 tokens), its
``lru_scan`` held bit for bit on the first mamba layer's captured
inputs (the flattened ``(B, T, di * ds)`` width, 131072 channels) and on
slow-decay inputs of that shape, 64 launches a prefill; and qwen3-4b
(36 attention layers, 32 query heads over 8 KV heads, head_dim 128,
qk-norm; batch 4, prompt 4096, 32 tokens), its causal
``flash_attention`` held to 2e-5 on the first layer's captured inputs
beside ``scaled_dot_product_attention(is_causal=True)`` on the same
tensors, 36 launches a prefill.  Neither launches a kernel in decode.
Then the mixture-of-experts archs at their published width, their depth
cut to fit float32 weights in the card's 80 GB (named in their lines):
dbrx-132b (3 of 40 layers; 48 query heads over 8 KV heads, 16 experts,
top-4) and llama4-scout-17b-a16e (4 of 48; 40 over 8, 16 experts,
top-1 plus the shared expert), batch 1, prompt 4096, 32 tokens, each
with its causal ``flash_attention`` held on its prefill's inputs (G = 6
and 5), one launch a layer, and the ``[check]`` line counting the
(layer, token) pairs whose top-k expert set differs between prefill(T)
+ decode and prefill(T + 1), and ``moe_dense``'s device time in that
prefill; and seamless-m4t-medium at its full width and depth (12
encoder + 12 decoder layers, 16 heads, head_dim 64): batch 4, 4000
encoder frames drawn on the card, a 1000-token prompt, 32 tokens, its
encoder's bidirectional, the decoder's causal and the cross attention
(T = 1000 over S = 4000) each held on its prefill's inputs, 36 launches
a prefill (12 of each).  TF32 is switched off for matrix products and
cuDNN before the LMs run, so every product compared is full float32.

Then bfloat16, JAX's default compute dtype: ``flash_attention``'s
bfloat16 instance (``csrc/flash_attention_bf16.cu``: wgmma fed by TMA,
a producer and two consumer warpgroups, a persistent grid) at small
shapes (``[kernel] flash_attention bfloat16 mirror``: head_dim 64, 128
and 256, causal, windowed and bidirectional, T != S both ways, T off the
128-row q tile, S shorter than a KV tile, two batch rows) against its
plain version
(2e-2, JAX's own bfloat16 kernel-test bound) and its mirror (one
bfloat16 ulp plus the mirror's slack, the differing elements counted);
chameleon-34b and qwen2.5-14b served at their published width and depth
with bfloat16 weights (batch 1 and 4, prompt 4096, 32 tokens) and
qwen3-4b beside its float32 serve on the same draws (``[main] <arch>
serve bfloat16``, ``[main] qwen3-4b bfloat16 vs float32``), each with
its bfloat16 flash kernel held on its prefill's inputs (also against
the mirror on the first 128 rows of batch row 0 and its last q tiles,
the share of its bound it reaches printed) and its ``[check]`` bound
taken from JAX's own bfloat16 gap (``tools/jax_bf16_consistency_gap.py``)
times the depth ratio; each serve's prefill and kernel time stand beside
the kernel's earlier mma.sync design's (``[main] <arch> bfloat16
prefill``).

Then training (``repro_torch.train``): ``lru_scan``'s backward kernel
against ``lru_scan_backward_plain`` bit for bit at the training shape
(2, 1024, 2560) and the forward's edge shapes, timed beside its byte
bound, with the forward timed at that shape (``[kernel] lru_scan
backward``); one ``make_train_step`` step of recurrentgemma-2b reduced to
3 layers on the card and on the CPU from the same weights (``[check]
train step card vs cpu``: the loss within 1e-5 relative, each gradient
within 1e-4 of its leaf's largest value); ``make_train_step`` at the
published width and depth (batch 2 x 1024 synthetic tokens, remat full,
AdamW's defaults: one warm-up and 3 timed steps, a profiled one;
``[main] recurrentgemma-2b train``: s/step, tokens/s, losses, peak
memory, the scan's launches a step: 36 forward, 18 backward); and
``python -m repro_torch.launch.train`` killed at step 21, resumed, and
held bit for bit to an uninterrupted run, then ``python -m
repro_torch.launch.serve --ckpt`` on its checkpoint (``[main] train
launcher``, ``[main] serve --ckpt``).  In bfloat16 (``param_dtype``
with a float32 master): the reduced step card vs CPU within twice the
CPU's own bfloat16 distance from float32 (``[check] train step bfloat16
card vs cpu``) and the full-width step (``[main] recurrentgemma-2b train
bfloat16``).

Then training through ``flash_attention``: its backward kernels
(``csrc/flash_attention_bwd.cu``, float32, and
``csrc/flash_attention_bwd_bf16.cu``, bfloat16) against
``flash_attention_backward_plain`` taken in float64 from the same tensors
and the forward kernel's own ``out`` and ``lse``, each gradient's max
abs gap over its max |g| within 2e-5 (float32) or 2e-2 (bfloat16), with
``out`` bit-equal with and without ``lse`` (``[kernel] flash_attention
backward [bfloat16] ...``: qwen3-0.6b's training shape, recurrentgemma-
2b's window, seamless-m4t-medium's encoder and cross attention, each
timed beside its bound and SDPA's backward, each walk timed from the
profiler's kernel names beside its own bound, each held to its time limit
and printed beside the earlier design's recorded time; and 21 small
shapes, eight of them at the walks' tile edges); one
``make_train_step`` step of qwen3-0.6b reduced to 3 layers (head dim 16:
the padded instances) with ``impl="flash"`` card vs CPU (``[check] train
step flash card vs cpu`` at the float32 check's bars; ``... flash
bfloat16 ...`` in the distance form, the loss token by token);
qwen3-0.6b at its published width and depth (batch 2 x 4096, remat
full) in float32 and with bfloat16 weights, 56 forward and 28 backward
flash launches a step, beside the same step with ``impl="naive"``
(``[main] qwen3-0.6b train flash [bfloat16]``); and ``python -m
repro_torch.launch.serve --arch qwen3-0.6b --reduced --device cuda``,
JAX's own example, its tokens an engine's on the same draws (``[main]
serve --reduced``).  The script prints its total time (``[time]``).

The mesh slice (``models/sharding.py``, ``launch/mesh.py``): a world-1
process group in this process (NCCL for the card's tensors, gloo for the
host's) and a 1 x 1 rank mesh.  On the weights of the dense dbrx-132b
serve above, ``moe_dispatch``: its prefill at capacity ``E / top_k``,
where nothing drops, against the dense prefill's last logits (``[check]
dbrx-132b dispatch vs dense``, ``DISPATCH_REL_TOL`` of max |logit|), then
the serve through ``LMEngine(rules=)`` at the config's capacity 1.25
with each prefill layer's dropped share of (token, expert) slots and
dense's times beside it (``[main] dbrx-132b serve dispatch``, with a
profile).  After the flash training, one qwen3-0.6b step at full width
through flash with the mesh's rules and without, bit for bit (``[main]
qwen3-0.6b train flash on the 1 x 1 mesh``), and ``compressed_psum`` on
the card against the host (``[check] compressed_psum``); ``[time] mesh
slice in all``.

Each launcher runs in a session of its own and fails the script if any
process of that session outlives it; at the end the script stops the
resource tracker that spawning the workers started and fails if a
child process is left (``[procs]``).  Whatever a failed phase left is
killed and reaped before the script exits.

The line before the last is a JSON object with each kernel's times and
bound; the last line is ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
import contextlib
import dataclasses
import importlib
import json
import re
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
TOL = 1e-9

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
FP64_OPS_PER_S = 34e12       # H100 SXM float64 outside the tensor cores
FP32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12      # H100 SXM TF32 on the tensor cores, dense
BF16_OPS_PER_S = 989e12      # H100 SXM bfloat16 on the tensor cores, dense
# the flash kernel's split TF32: three TF32 MMAs a float32 product
SPLIT_TF32_MMAS = 3
# float64 operations the lattice round needs: 5 per node and level (p*up,
# q*v, their sum, *inv_r, the max), and the intrinsic once per distinct
# spot j = 2i - lvl, counted from the expression of each kind (the exp as
# one): s0 * exp(j * sig) and the payoff with its clamp
LATTICE_STEP_OPS = 5
LATTICE_INTRINSIC_OPS = {"param": 15, "put": 5, "call": 5}
CB_STEPS = 120    # depth of the call/bull-spread grid
# the LM serves at full width: (arch, batch, prompt, new tokens).
# falcon-mamba-7b at batch 2: its scan tensors (B, T, di * ds) are 4.3 GB
# each at B = 2, T = 4096 (W = 8192 * 16 = 131072), 8.6 GB at batch 4,
# where a layer's three of them and the 29.1 GB of float32 weights would
# leave too little of the 80 GB for the kernel holds beside them
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "recurrentgemma-2b", 4, 4096, 32
MAMBA_SERVE = ("falcon-mamba-7b", 2, 4096, 32)
GQA_SERVE = ("qwen3-4b", 4, 4096, 32)
# the MoE archs at their published width, depth cut to fit the card's 80
# GB in float32 (JAX's param_count: dbrx 13.04 GB a layer + 4.93 GB of
# embeddings, llama4-scout 8.81 + 8.28; moe_dense's (E, B, S, f)
# intermediates 2.1-2.8 GB each): (arch, batch, prompt, new tokens,
# layers kept); and the encoder-decoder arch at its full width and depth
# (12 + 12 layers) on 4000 encoder frames, so that cross attention has
# T != S, neither a multiple of the kernel's 64-row tile:
# (arch, batch, prompt, new tokens, encoder frames)
MOE_SERVES = (("dbrx-132b", 1, 4096, 32, 3),
              ("llama4-scout-17b-a16e", 1, 4096, 32, 4))
# the MoE arch also served through moe_dispatch on a 1 x 1 rank mesh
DISPATCH_ARCH = "dbrx-132b"
ENCDEC_SERVE = ("seamless-m4t-medium", 4, 1000, 32, 4000)
# flash against its plain version: the bound JAX's own flash is held to.
# lru_scan rounds as its plain version does (no fused multiply-add) and
# is held to equality, within the float32 contract's 2e-6.
FLASH_TOL = 2e-5
# prefill(T) + decode(T) against prefill(T + 1), last logits: float32
# through 26 to 64 layers, sums of up to 9728 terms in other orders (flash
# kernel against naive decode attention, the scan against the one-step
# update, cuBLAS at other shapes)
CONSIST_TOL = 1e-3
# lru_scan's edge shapes (B, T, W): a ragged last ring chunk, T shorter
# than a chunk, W not a multiple of a warp's 32 channels nor 16-byte
# aligned, one batch row
LRU_EDGES = ((1, 300, 2560), (2, 20, 77), (1, 1, 33))
# flash_attention beyond the prefill's instance (hd 256, causal, window):
# (label, B, T = S, H, KVH, hd, causal, window)
FLASH_EXTRA = (("hd128", 2, 1000, 8, 2, 128, True, None),
               ("bidirectional", 1, 1000, 10, 1, 256, False, None))
# the bfloat16 serves (RunCfg's default dtype, weights stored in
# bfloat16): (arch, batch, prompt, new tokens), all layers at published
# width.  chameleon-34b's 68.59 GB of bfloat16 weights fit the card at
# batch 1; qwen2.5-14b's 29.54 GB at batch 4; qwen3-4b runs beside its
# float32 serve on the same draws
BF16_SERVES = (("chameleon-34b", 1, 4096, 32), ("qwen2.5-14b", 4, 4096, 32),
               ("qwen3-4b", 4, 4096, 32))
# prefill(T) + decode vs prefill(T + 1) in bfloat16: JAX's own relative
# gap (max |d| over max |logit|) for the same comparison on the CPU,
# fitted over depth (2 to 16 layers, prompts of 64 and 256) and width
# (d_model 64 to 1024) and taken at the published depth and width
# (tools/jax_bf16_consistency_gap.py: a * layers**alpha * (d_model/64)**beta,
# alpha -0.02..0.15, beta 0.04..0.12), times BF16_GAP_MARGIN, times the
# card's own max |logit|.  The margin: the largest relative gap scatters
# by 1.5x between configs of one size on the CPU, and the port's bfloat16
# gap is up to 1.3x JAX's there (tests/test_torch_bf16.py)
JAX_BF16_REL_GAP = {"chameleon-34b": 0.013151890282720917,
                    "qwen2.5-14b": 0.019235269344541454,
                    "qwen3-4b": 0.02130326664692797}
BF16_GAP_MARGIN = 2.0
# each bfloat16 serve's prefill seconds and flash_attention ms a launch,
# as recorded (printed beside this run's, never in the kernels' record)
# with the bfloat16 kernel's earlier design (mma.sync m16n8k16 fed by
# ldmatrix, 4 warps of 16 rows a block, a two-stage cp.async ring), on
# NVIDIA H100 80GB HBM3 at 700 W: the baseline of the wgmma design
BF16_MMA_SYNC = {"chameleon-34b": (0.588, 1.2838),
                 "qwen2.5-14b": (1.107, 3.0617),
                 "qwen3-4b": (0.479, 2.4368)}
# the bfloat16 flash kernel against its mirror on a main path's inputs:
# the first batch row's first query rows and its last (whole q tiles: the
# kernel's rows there depend on nothing else; the last walk every KV
# tile of a causal row, or of a full window)
MIRROR_ROWS = 128
# the bfloat16 kernel at small shapes: (hd, B, T, S, causal, window).  A
# window of 40 keys cuts every tile it touches.  The kernel takes a KV
# tile without a mask where it lies wholly inside the causal triangle and
# the window for all 64 rows of a consumer warpgroup, which needs a window
# of BKV + 64 keys (192; 128 at hd 256): one of 300 keys at T = 700 and
# one of 2048 at T = 2400 (T > window + 2 * the 128-row q tile) leave such
# tiles at every head_dim, one of 160 at T = 300 at hd 256 only.  T = 150,
# 230, 300, 517 and 700 are not multiples of the q tile; S = 90 and 40 are
# shorter than one KV tile (128 keys, 64 at hd 256); B = 2 with a ragged S
# holds the TMA loads' zero fill within each batch row
FLASH_BF16_CASES = tuple((hd, 1, 150, 150, c, w) for hd in (64, 128, 256)
                         for c, w in ((True, None), (True, 40),
                                      (False, None))) + tuple(
    (hd, 1, 300, 300, True, 160) for hd in (64, 128, 256)) + (
    (128, 1, 2200, 2200, True, 2048), (64, 1, 100, 230, False, None),
    (128, 1, 230, 100, False, None), (256, 1, 517, 517, True, None)) + tuple(
    (hd, 2, 700, 700, True, 300) for hd in (64, 128, 256)) + (
    (128, 1, 2400, 2400, True, 2048), (64, 2, 100, 90, False, None),
    (256, 2, 200, 40, False, None))
# the bfloat16 kernel on the inputs a full-width bfloat16 prefill of
# these archs gives it (the archs the bfloat16 serves do not cover):
# (arch, batch, prompt, encoder frames), the float32 serves' shapes:
# recurrentgemma-2b's hd 256 local attention with its 2048-key window
# over 4096 tokens, seamless-m4t-medium's encoder, decoder and cross
# attention at hd 64
BF16_PREFILLS = (("recurrentgemma-2b", 4, 4096, None),
                 ("seamless-m4t-medium", 4, 1000, 4000))
# the LSMC engine: Longstaff & Schwartz (2001), Table 1 (American puts,
# K=40, r=0.06, 100,000 antithetic paths, 50 exercise dates a year),
# and a 64-contract Bermudan basket of 5 assets
LS_SPOTS, LS_SIGMAS, LS_PATHS = (36.0, 38.0, 40.0, 42.0, 44.0), (0.2, 0.4), \
    100_000
# the paper's finite-difference American values, (s0, sigma, T) -> price
LS_TABLE1 = {
    (36.0, 0.2, 1.0): 4.478, (36.0, 0.2, 2.0): 4.840,
    (36.0, 0.4, 1.0): 7.101, (36.0, 0.4, 2.0): 8.508,
    (38.0, 0.2, 1.0): 3.250, (38.0, 0.2, 2.0): 3.745,
    (38.0, 0.4, 1.0): 6.148, (38.0, 0.4, 2.0): 7.670,
    (40.0, 0.2, 1.0): 2.314, (40.0, 0.2, 2.0): 2.885,
    (40.0, 0.4, 1.0): 5.312, (40.0, 0.4, 2.0): 6.920,
    (42.0, 0.2, 1.0): 1.617, (42.0, 0.2, 2.0): 2.212,
    (42.0, 0.4, 1.0): 4.582, (42.0, 0.4, 2.0): 6.248,
    (44.0, 0.2, 1.0): 1.110, (44.0, 0.2, 2.0): 1.690,
    (44.0, 0.4, 1.0): 3.948, (44.0, 0.4, 2.0): 5.647,
}
BASKET_STEPS, BASKET_ASSETS, BASKET_PATHS = 50, 5, 32_768
# each LSMC price on the card against the same row on the host, in units
# of sqrt(se_card^2 + se_host^2): 84 rows at 4 give a 0.5% chance of a
# false alarm for independent normal gaps (3 would give 20%)
LSMC_HOST_SE = 4.0
# a float32 walk's prices against the float64 grid's: rz_round's float32
# tolerance in the JAX package's registry
RZ32_PRICE_TOL = 1e-4


class SmokeError(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeError(what)


def processes(parent=None, session=None):
    """(pid, state, command) of every process whose parent is ``parent``
    or whose session is ``session``, as /proc lists them (zombies too)."""
    found = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue                     # ended while we looked
        state, ppid, sid = fields[0], int(fields[1]), int(fields[3])
        if ppid == parent or sid == session:
            found.append((int(d), state, cmd.strip()[:120]))
    return found


def run_alone(cmd, timeout=600):
    """Run ``cmd`` from the checkout in a session of its own, as a user
    would; once it ends, fail if any process of its session is left
    (after killing them), as at ``timeout``."""
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=dict(os.environ, PYTHONPATH=SRC),
                         cwd=ROOT, start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise SmokeError(f"{' '.join(cmd[1:3])} ran past {timeout} s")
    deadline = time.monotonic() + 1.0    # room for init to reap an orphan
    while (left := processes(session=p.pid)) and time.monotonic() < deadline:
        time.sleep(0.05)
    if left:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(p.pid, signal.SIGKILL)
    check(not left, f"{' '.join(cmd[1:3])} left processes behind: {left}")
    return subprocess.CompletedProcess(cmd, p.returncode, out, err)


def stop_children():
    """Kill and reap the worker processes a failed phase left, then the
    helper process that spawning them started."""
    import multiprocessing
    for p in multiprocessing.active_children():
        p.kill()
        p.join(10.0)
    pp = sys.modules.get("repro_torch.serve.procpool")
    if pp is not None:
        pp.stop_spawn_helper()


def cuda_ms(torch, fn, reps):
    """Mean time of ``fn`` on the card (CUDA events, one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(torch, fn):
    """One call of ``fn`` and its time on the card (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def wall(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def max_pwl_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a[:4], b[:4]))


def print_ptxas(source, log):
    """One ``[ptxas]`` line per kernel of a source: registers, stack and
    spills as ``nvcc -Xptxas=-v`` reported them."""
    entry, facts = None, []
    for ln in log.splitlines() + ["Compiling entry function 'end'"]:
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            if entry and facts:
                print(f"[ptxas] {source} {entry}: {'; '.join(facts)}",
                      flush=True)
            # the kernel's name out of the mangled one: the identifier
            # ending in _kernel that its length prefix spans (nvcc's
            # anonymous namespace is letters, digits and _ too), then its
            # template arguments
            k = next((k for k in re.finditer(
                r"(?=(\d+)([a-z]\w*?_kernel)"
                r"(?:I((?:f|13__nv_bfloat16|Li\d+E|Lb\dE)+)E)?)",
                m.group(1)) if len(k.group(2)) == int(k.group(1))), None)
            args = [] if k is None or not k.group(3) else [
                {"f": "float", "13__nv_bfloat16": "bf16", "Lb1E": "true",
                 "Lb0E": "false"}.get(a, a.strip("LiE")) for a in
                re.findall(r"f|13__nv_bfloat16|Li\d+E|Lb\dE", k.group(3))]
            entry = (m.group(1) if k is None else
                     k.group(2) + (f"<{', '.join(args)}>" if args else ""))
            facts = []
        elif entry and ("Used" in ln or "spill" in ln):
            facts.append(ln.split(":", 1)[-1].strip())
        if "warning" in ln and ("wgmma" in ln or "setmaxnreg" in ln):
            print(f"[ptxas] {source} {ln.strip()}", flush=True)


def ops_rate(torch, dtype):
    """The card's rate outside the tensor cores for ``dtype``."""
    return FP64_OPS_PER_S if dtype == torch.float64 else FP32_OPS_PER_S


def lattice_bound(torch, x, s, kind, levels):
    """Least time for one round on these inputs: 5 operations per node
    and active level, the intrinsic once per distinct spot j (about
    2 (P + levels) a row), over the rate of x's dtype (float64 or
    float32), against each lane read and written once."""
    rows, P = x.shape
    active = torch.clamp(torch.floor(s[:, 0].double()), 0, levels)
    ops = float((P * active * LATTICE_STEP_OPS
                 + torch.where(active > 0, 2 * (P + active) - 3, 0)
                 * LATTICE_INTRINSIC_OPS[kind]).sum())
    t_ops = ops / ops_rate(torch, x.dtype)
    t_bytes = ((2 * x.numel() + s.numel()) * x.element_size()
               / HBM_BYTES_PER_S)
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def lattice_inputs(torch, dev, rows, P, lvl0, kind, dtype=None):
    """Seeded node values in [0, 30) and round scalars for ``rows`` rows
    of ``P`` lanes (puts and calls of the 4-parameter family alternating;
    the 6 put/call scalars for ``kind`` other than "param"); ``lvl0`` is
    one level or one per row.  Drawn in float64, then cast to ``dtype``
    (float32: the same values, rounded)."""
    g = torch.Generator(device=dev).manual_seed(0)
    v = torch.rand(rows, P, generator=g, dtype=torch.float64, device=dev) * 30
    u = torch.rand(rows, generator=g, dtype=torch.float64, device=dev)
    fam = torch.tensor([[1.0, -1.0, 0.0, 0.0], [-1.0, 1.0, 0.0, 0.0]],
                       dtype=torch.float64, device=dev)[torch.arange(rows) % 2]
    k = 90.0 + 20.0 * u
    l0 = torch.as_tensor(lvl0, dtype=torch.float64, device=dev).expand(rows)
    sc = torch.stack([l0, 0.5 + 0.01 * u, torch.full_like(u, 0.99998),
                      80.0 + 40.0 * u, torch.full_like(u, 0.0026),
                      *fam.T, k, k], dim=1)
    if kind != "param":
        sc = sc[:, [0, 1, 2, 9, 3, 4]]
    if dtype is not None:
        v, sc = v.to(dtype), sc.to(dtype)
    return v, sc.contiguous()


def lattice_phase(torch, B, paper_notc):
    """lattice_round_param and lattice_round vs their plain version at the
    no-TC main path's shapes (P=40192 lanes, levels=50, block=256):
    lattice_round_param on the grid's 256 rows, lattice_round on the one
    row of the single-contract price; lattice_round also on 256 rows of
    calls, a check off the main path.  Then edge cases at small rows.
    Each is held to equality: the kernel repeats the plain version's
    operations in the same order for every owned lane."""
    dev = torch.device("cuda")
    block, levels = 256, paper_notc.round_depth
    P = -(-(paper_notc.n_steps + 1) // block) * block
    n = float(paper_notc.n_steps)
    entry = {"param": B.lattice_round_param, "put": B.lattice_round,
             "call": B.lattice_round}
    out = {}

    def hold(label, kind, x, s, lv, blk):
        kw = {} if kind == "param" else {"kind": kind}
        got = entry[kind](x, s, levels=lv, block=blk, **kw)
        want = B.lattice_round_plain(x, s, levels=lv, block=blk, kind=kind)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want),
              f"{label}: kernel differs from plain (max abs err {err})")
        return err

    for label, kind, rows in (("lattice_round_param", "param", 256),
                              ("lattice_round", "put", 1),
                              ("lattice_round call x256", "call", 256)):
        x, s = lattice_inputs(torch, dev, rows, P, n, kind)
        err = hold(label, kind, x, s, levels, block)
        kw = {} if kind == "param" else {"kind": kind}
        ms = cuda_ms(torch, lambda: entry[kind](x, s, levels=levels,
                                                block=block, **kw), 20)
        plain_ms = cuda_ms(torch, lambda: B.lattice_round_plain(
            x, s, levels=levels, block=block, kind=kind), 3)
        bound, bound_by = lattice_bound(torch, x, s, kind, levels)
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound, bound_by=bound_by,
                          shape=[rows, P], levels=levels, block=block)
        print(f"[kernel] {label}: rows={rows} P={P} levels={levels} "
              f"block={block} max_abs_err={err:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f}", flush=True)

    # (label, kind, rows, P, levels, block, lvl0 of the rows)
    edges = (("final short round", "param", 4, P, levels, block,
              [30.0, 1.0, 0.0, 49.0]),
             ("mixed lvl0", "param", 4, P, levels, block,
              [n, 7.0, 50.0, 100.0]),
             ("levels == block", "param", 64, 4096, 256, 256, n),
             ("block 32", "call", 64, 4096, 32, 32, n),
             ("block 1024", "param", 64, 4096, 1024, 1024, n),
             ("single block", "put", 3, 256, levels, 256,
              [255.0, 40.0, 256.0]))
    for label, kind, rows, p, lv, blk, lvl0 in edges:
        x, s = lattice_inputs(torch, dev, rows, p, lvl0, kind)
        err = hold(f"edge {label}", kind, x, s, lv, blk)
        print(f"[kernel] lattice edge {label}: kind={kind} rows={rows} P={p} "
              f"levels={lv} block={blk} lvl0={s[:, 0].tolist()[:4]} "
              f"max_abs_err={err:.3e}", flush=True)
        out[f"edge {label}"] = dict(max_abs_err=err, kind=kind,
                                    shape=[rows, p], levels=lv, block=blk)
    return out


def rz_state(torch, R, grid, capacity, rows, lanes, dtype=None):
    """The main TC grid's leaf state over ``lanes`` lanes for its first
    ``rows`` contracts, and their round scalars, computed in ``dtype``
    (default float64) from the grid's columns, as the engines do."""
    dev = torch.device("cuda")
    col = lambda a: torch.as_tensor(a[:rows], dtype=dtype or torch.float64,
                                    device=dev)
    alpha, zeta, w1, w2 = grid.payoff_param_arrays()
    params = R.rz_params(col(grid.s0), col(grid.sigma), col(grid.rate),
                         col(grid.maturity), col(grid.cost_rate),
                         n_steps=grid.n_steps)
    leaf = R.leaf_level(grid.n_steps, params, capacity, lanes)
    z = leaf.map(lambda a: a[:, None].expand(
        (a.shape[0], 2) + a.shape[1:]).contiguous())
    sc = torch.stack([torch.full_like(params["s0"], grid.n_steps + 1.0),
                      params["s0"], params["sig_sqrt_dt"], params["r"],
                      params["k"], col(alpha), col(zeta), col(w1), col(w2),
                      col(grid.strike), col(grid.strike2)], dim=1)
    return z, sc.contiguous()


def walk_rounds(torch, RS, plan, z, sc, until_lvl0):
    """Advance the leaf state through the main path's single-block
    rounds (with the kernel) until the round based at ``until_lvl0``."""
    for rnd in plan:
        if rnd.lvl0 <= until_lvl0:
            return rnd, z.map(lambda a: a[:, :, :rnd.lanes].contiguous()), sc
        z = z.map(lambda a: a[:, :, :rnd.lanes].contiguous())
        sc[:, 0] = float(rnd.lvl0)
        z, _ = RS.rz_round(z, sc, levels=rnd.depth, block=rnd.block)
    raise SmokeError("round not found")


def rz_capacity(torch, R, RS, tc_grid, capacities=(16, 48, 128)):
    """The widest put round (all 256 contracts at the leaf, N + 2 lanes,
    64 levels) timed at each capacity K.  The put's knots fit in 16, so
    every capacity gives the same knots: each result is held against the
    first on its knot counts, raw counts and the valid knots."""
    n = tc_grid.n_steps
    lanes = n + 2
    out, pool, first = {}, {}, None
    for K in capacities:
        z, sc = rz_state(torch, R, tc_grid, K, 256, lanes)
        got, pieces = RS.rz_round(z, sc, levels=64, block=lanes)
        torch.cuda.synchronize()
        if first is None:
            first = (got, pieces)
        k0 = first[0].xs.shape[-1]
        keep = (torch.arange(k0, device=got.m.device)
                < got.m[..., None])
        d = max(float(torch.where(keep, a[..., :k0] - b, 0.0).abs().max())
                for a, b in ((got.xs, first[0].xs), (got.ys, first[0].ys)))
        same = bool(torch.equal(got.m, first[0].m)
                    and torch.equal(pieces, first[1]))
        check(same and d == 0.0, f"rz_round capacity {K}: knots differ from "
              f"capacity {capacities[0]} (equal m and pieces {same}, max "
              f"abs diff {d})")
        out[K] = cuda_ms(torch, lambda: RS.rz_round(z, sc, levels=64,
                                                    block=lanes), 3)
        pool[K] = RS.wide_pool_bytes(K) / 1e6
        del z, sc, got, pieces
    print(f"[kernel] rz_round capacity: rows=256 N={n} lanes={lanes} "
          f"levels=64 " + " ".join(f"K={K} ms={ms:.3f} pool_MB={pool[K]:.1f}"
                                   for K, ms in out.items())
          + f"; K={capacities[1]}/K={capacities[0]} "
          f"{out[capacities[1]] / out[capacities[0]]:.3f}", flush=True)
    return dict(ms=out, pool_mb=pool)


def rz_step_ops(torch, mu, mc, mo):
    """float64 operations of one lane step of csrc/rz_step.cu with inputs
    of mu (lane i+1) and mc (lane i) knots and the step's w, v and z of
    mo knots each, counted from its device functions: a division, an
    exp, a min or max and a compare count one each, fabs is a free
    operand modifier, and crossings that are emitted and survivors that
    are dropped are not counted.  Tensors of counts in, operations out.

    * eval1 on n knots: the search's compares, then the end ray (3) or
      the interior piece (7: width, its test, rise, division, offset,
      product, sum);
    * envelope_core over p grid points: the slopes of each interior
      interval (7), a crossing test in each of the p + 1 intervals (14:
      parallel test 5, crossing 3, margin 2, inside 4), a max or min a
      point, and the end slopes (14, and f and g at two probes);
    * compress: 5 a candidate (validity, dedupe), 9 a survivor (segment
      slope 4, kink test 5), the output's knots taken as the survivors.
    """
    def ev(n):
        return torch.ceil(torch.log2(n + 1.0)) + torch.where(n <= 1, 3.0, 7.0)

    def core(p, ev_f, ev_g):
        return 7 * (p - 1) + 14 * (p + 1) + p + 14 + 2 * ev_f + 2 * ev_g

    def compress(cands, kept):
        return 5 * cands + 9 * kept

    one = torch.ones_like(mo)
    # w = envelope2(z[i+1], z[i], max): the merge evaluates each list at
    # the other's knots, the core runs over mu + mc points
    s1 = (mu * (1 + ev(mc)) + mc * (1 + ev(mu))
          + core(mu + mc, ev(mu), ev(mc)) + compress(mu + mc, mo))
    # v = cone(w / r): the scale, suffix and prefix minima (6 a knot), the
    # parallel test (4), a crossing test between knots (10), the cone
    # envelope at each grid point (8 and two searches) and w there; the
    # core's g probes are the envelope's end rays (3 each)
    s2 = (mo + 6 * mo + 4 + 10 * (mo - 1)
          + mo * (8 + 2 * torch.ceil(torch.log2(mo + 1.0)) + ev(mo))
          + core(mo, ev(mo), 3 * one) + compress(mo, mo))
    # z = envelope2(expense, v): a one-knot function against v
    s3 = (1 + ev(mo) + mo * (1 + ev(one)) + core(1 + mo, ev(one), ev(mo))
          + compress(1 + mo, mo))
    # the spot (with its exp), costs, expense and the scale of w's ends
    return s1 + s2 + s3 + 22


def rz_bound(torch, z, got, sc, levels, K, lane0=0):
    """Least time for one rz_round on these inputs: rz_step_ops at each
    live lane-level of the owned lanes, with each lane's input counts
    (its own and its right neighbour's) and its output count, over the
    rate of the values' dtype (float64 or float32); against each input's
    valid knots read once (with its sl, sr and m) and each output record
    written once, over the memory rate.  Lane i is tree column lane0 + i.
    Returns (ms, "operations" or "bytes", operations, bytes)."""
    R, S, lanes = z.m.shape
    mi = z.m.double()
    mu = torch.cat([mi[..., 1:], mi[..., -1:]], dim=-1)
    mo = got.m.double()
    g = lane0 + torch.arange(lanes, dtype=torch.float64, device=mi.device)
    live = torch.clamp(torch.floor(sc[:, 0, None].double() - g), 0,
                       levels)[:, None]
    ops = float((live * rz_step_ops(torch, mu, mi, mo)).sum())
    e = z.xs.element_size()
    nbytes = float(2 * e * mi.sum() + (2 * e + 4) * mi.numel()
                   + (2 * e * K + 2 * e + 4) * mo.numel() + e * sc.numel())
    t_ops = ops / ops_rate(torch, z.xs.dtype)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def rz_hold(torch, RS, label, z, sc, levels, block, **kw):
    """rz_round against its plain version (``kw``: lane0, owned): max abs
    error <= 1e-9 and equal knot counts and raw counts.  Returns the
    kernel's result, the plain version's time and the error."""
    got, pieces = RS.rz_round(z, sc, levels=levels, block=block, **kw)
    (want, wpieces), plain_ms = timed_once(torch, lambda: RS.rz_round_plain(
        z, sc, levels=levels, block=block, **kw))
    err = max_pwl_err(got, want)
    same_m = bool(torch.equal(got.m, want.m))
    same_p = bool(torch.equal(pieces, wpieces))
    check(err <= TOL and same_m and same_p,
          f"rz_round {label}: max abs err {err}, equal m {same_m}, "
          f"equal pieces {same_p}")
    return got, pieces, plain_ms, err


def rz_phase(torch, R, RS, P, tc_grid, cb_grid, capacity):
    """rz_round vs its plain version at the TC main path's shapes, all 256
    contracts of a grid per launch: the put grid's first (widest)
    single-block round at its leaf state, a later single-block round
    whose lanes carry the walk's knots, and a late round of the
    call/bull-spread grid, whose lanes carry tens of knots; and a
    16-contract multi-block halo round, a check off the main path.
    Then the tile schedule's edges on a few contracts, and the widest
    round's time at capacities 16, 48 and 128."""
    out = {}
    cases = (("single-block", tc_grid, 256, None, None),
             ("single-block-deep", tc_grid, 256, None, 800),
             ("call-bull-deep", cb_grid, 256, None, 60),
             ("halo", tc_grid, 16, 128, None))
    for label, grid, rows, block, deep in cases:
        n = grid.n_steps
        lanes = n + 2 if block is None else -(-(n + 2) // block) * block
        levels = 64
        z, sc = rz_state(torch, R, grid, capacity, rows, lanes)
        if deep is not None:
            rnd, z, sc = walk_rounds(torch, RS, P.kernel_round_plan(n), z, sc,
                                     deep)
            sc[:, 0] = float(rnd.lvl0)
            lanes, levels = rnd.lanes, rnd.depth
        blk = lanes if block is None else block
        lvl0 = int(sc[0, 0])
        got, pieces, plain_ms, err = rz_hold(torch, RS, label, z, sc, levels,
                                             blk)
        ms = cuda_ms(torch, lambda: RS.rz_round(z, sc, levels=levels,
                                                block=blk), 3)
        bound, bound_by, ops, nbytes = rz_bound(torch, z, got, sc, levels,
                                                capacity)
        knots = float(z.m[..., :min(lanes, lvl0 + 1)].double().mean())
        wide = float((z.m > RS.INLINE_KNOTS).double().mean())
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound, bound_by=bound_by, bound_ops=ops,
                          bound_bytes=nbytes, rows=rows, lanes=lanes,
                          block=blk, levels=levels, mean_knots_in=knots,
                          wide_share_in=wide, pieces=int(pieces.max()))
        print(f"[kernel] rz_round {label}: rows={rows} N={n} lvl0={lvl0} "
              f"lanes={lanes} block={blk} levels={levels} K={capacity} "
              f"max_abs_err={err:.3e} equal_m=True "
              f"pieces={int(pieces.max())} mean_knots_in={knots:.3f} "
              f"share_above_{RS.INLINE_KNOTS}_knots={wide:.4f} ms={ms:.3f} plain_ms={plain_ms:.3f} bound_ms={bound:.4f} "
              f"({bound_by}: {ops:.4e} float64 operations, {nbytes:.4e} "
              f"bytes)", flush=True)

    # the tile schedule's edges: (label, grid, rows, capacity, block, lvl0
    # to walk down to or None for the leaf, levels or None for the
    # round's depth)
    n = tc_grid.n_steps
    edges = (("lanes not a multiple of the tile", tc_grid, 8, capacity,
              None, None, 8),
             ("levels 1", tc_grid, 8, capacity, None, None, 1),
             ("lanes below the tile", tc_grid, 8, capacity, None, 100, None),
             ("levels == lvl0", tc_grid, 8, capacity, None, 64, None),
             ("two launches", tc_grid, 8, capacity, None, None,
              RS.LEVELS_PER_LAUNCH + 8),
             ("halo levels == block", tc_grid, 8, capacity, 128, None, 128),
             ("capacity 16", tc_grid, 8, 16, None, 800, None),
             ("capacity 128", cb_grid, 8, 128, None, 60, None))
    for label, grid, rows, K, block, deep, levels in edges:
        n = grid.n_steps
        lanes = n + 2 if block is None else -(-(n + 2) // block) * block
        z, sc = rz_state(torch, R, grid, K, rows, lanes)
        if deep is not None:
            rnd, z, sc = walk_rounds(torch, RS, P.kernel_round_plan(n), z, sc,
                                     deep)
            sc[:, 0] = float(rnd.lvl0)
            lanes = rnd.lanes
            levels = rnd.depth if levels is None else levels
        blk = lanes if block is None else block
        got, pieces, _, err = rz_hold(torch, RS, f"edge {label}", z, sc,
                                      levels, blk)
        tiles = len(RS.tile_plan(lanes, blk, min(levels,
                                                 RS.LEVELS_PER_LAUNCH)))
        wide = float((z.m > RS.INLINE_KNOTS).double().mean())
        out[f"edge {label}"] = dict(max_abs_err=err, rows=rows, lanes=lanes,
                                    block=blk, levels=levels, K=K,
                                    lvl0=float(sc[0, 0]), tiles=tiles,
                                    max_knots_in=int(z.m.max()),
                                    wide_share_in=wide,
                                    pieces=int(pieces.max()))
        print(f"[kernel] rz_round edge {label}: rows={rows} N={n} "
              f"lvl0={float(sc[0, 0]):.0f} lanes={lanes} block={blk} "
              f"levels={levels} K={K} tiles={tiles} max_knots_in="
              f"{int(z.m.max())} share_above_{RS.INLINE_KNOTS}_knots="
              f"{wide:.4f} max_abs_err={err:.3e} equal_m=True "
              f"pieces={int(pieces.max())}", flush=True)
    out["capacity"] = rz_capacity(torch, R, RS, tc_grid)
    return out


def live_pairs(np, T, S, causal, window):
    """(query, key) pairs the masks leave live, positions from 0."""
    t = np.arange(T)
    hi = np.minimum(t + 1, S) if causal else np.full(T, S)
    lo = np.maximum(t - window + 1, 0) if window else np.zeros(T, np.int64)
    return int(np.clip(hi - lo, 0, None).sum())


def kernel_kind(name, args, kw):
    """What a kernel call computes: ``lru_scan``; ``flash_attention``
    (causal self attention), ``flash_attention.bidirectional`` (T = S:
    an encoder) or ``flash_attention.cross`` (T != S)."""
    if name != "flash_attention" or kw.get("causal", True):
        return name
    q, k = args[0], args[1]
    return name + (".cross" if q.shape[1] != k.shape[1] else ".bidirectional")


def capture_kernel_inputs(ops, fn, keep=True):
    """Run ``fn()``, count the calls of ``ops.flash_attention`` and
    ``ops.lru_scan`` in it by :func:`kernel_kind`, and (``keep``) keep
    copies of the first inputs of each kind.  Returns ``(fn(), seen,
    calls)``."""
    seen, calls = {}, {}
    orig = {name: getattr(ops, name) for name in ("flash_attention",
                                                   "lru_scan")}

    def wrap(name):
        def call(*args, **kw):
            kind = kernel_kind(name, args, kw)
            calls[kind] = calls.get(kind, 0) + 1
            if keep and kind not in seen:
                seen[kind] = ([a.clone() for a in args], dict(kw))
            return orig[name](*args, **kw)
        return call
    for name in orig:
        setattr(ops, name, wrap(name))
    try:
        out = fn()
    finally:
        for name, f in orig.items():
            setattr(ops, name, f)
    return out, seen, calls


def capture_routes(L, fn):
    """Run ``fn()`` and keep each MoE layer call's top-k expert sets
    (``layers.moe_route``'s indices, sorted), in call order."""
    routes = []
    orig = L.moe_route

    def call(*args, **kw):
        out = orig(*args, **kw)
        routes.append(out[2].sort(dim=-1).values)
        return out
    L.moe_route = call
    try:
        out = fn()
    finally:
        L.moe_route = orig
    return out, routes


def lru_hold(torch, LS, seen, label):
    """``lru_scan`` against its plain version, bit for bit, on the inputs
    the first scanning layer of a full-width prefill gave it (taken out of
    ``seen``), timed there; then on seeded inputs of the same shape whose
    decay is slow.  Returns the kernel's record."""
    (a, b, h0), _ = seen.pop("lru_scan")
    errs = {}

    def hold(what, xs):
        got = LS.lru_scan(*xs)
        want = LS.lru_scan_plain(*xs)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, want))
        errs[what] = max(float((x - y).abs().max()) for x, y in zip(got, want))
        carry = float((want[0] - xs[1]).abs().max())
        print(f"[kernel] lru_scan {label}{what}: a,b {tuple(xs[0].shape)} "
              f"equal to plain {same}, max abs err {errs[what]:.3e}, max "
              f"|h_t - b_t| {carry:.3e}", flush=True)
        check(same, f"lru_scan {label}{what}: kernel differs from plain "
              f"(max abs err {errs[what]})")

    hold("prefill inputs", (a, b, h0))
    ms = cuda_ms(torch, lambda: LS.lru_scan(a, b, h0), 20)
    plain_ms = cuda_ms(torch, lambda: LS.lru_scan_plain(a, b, h0), 2)
    shape, n, n_h = tuple(a.shape), a.numel(), h0.numel()
    dev = a.device
    del a, b, h0
    # the captured a of a random init decays fast (recurrentgemma's is
    # about exp(-16)): h_t is b_t to within an ulp, so a kernel that
    # dropped the carry would pass on them.  Slow decay, as trained gates
    # have, makes the carry dominate.
    g = torch.Generator(device=dev).manual_seed(7)
    slow = (0.9 + 0.1 * torch.rand(shape, generator=g, device=dev),
            torch.randn(shape, generator=g, device=dev),
            torch.randn((shape[0], shape[2]), generator=g, device=dev))
    hold("slow decay", slow)
    del slow
    t_bytes = (3 * n + 2 * n_h) * 4 / HBM_BYTES_PER_S
    t_ops = 2 * n / FP32_OPS_PER_S
    rec = dict(max_abs_err=max(errs.values()), errs=errs, ms=ms,
               plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=None, shape=list(shape))
    print(f"[kernel] lru_scan{' ' + label.strip() if label else ''}: a,b "
          f"{shape} max_abs_err={rec['max_abs_err']:.3e} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={rec['bound_ms']:.4f}",
          flush=True)
    return rec


def mirror_spans(FL, T, hd):
    """The query rows the bfloat16 mirror holds on a main path's inputs:
    the first ``MIRROR_ROWS`` and the q tiles from ``MIRROR_ROWS`` before
    the end (those walk the most KV tiles: a whole causal row, or a full
    window), as ``(r0, r1)`` spans."""
    bq = FL.KERNEL_TILES_BF16[hd][0]
    spans = [(0, min(MIRROR_ROWS, T))]
    r0 = max(spans[0][1], (T - MIRROR_ROWS) // bq * bq)
    if r0 < T:
        spans.append((r0, T))
    return spans


def flash_mirror_rows(torch, FL, q, k, v, got, kw):
    """The bfloat16 kernel's output on a main path's inputs against its
    mirror, on the first batch row's :func:`mirror_spans` (the kernel's
    rows there depend on nothing else), elementwise within
    ``mirror_bound_bf16``.  Returns ``(max abs difference, elements that
    differ, elements, max difference over bound, spans)``."""
    spans = mirror_spans(FL, q.shape[1], q.shape[3])
    d_max, differ, n, of_bound = 0.0, 0, 0, 0.0
    for r0, r1 in spans:
        mirror, slack = FL.flash_attention_mirror(
            q[:1], k[:1], v[:1], with_slack=True, rows=(r0, r1), **kw)
        mine = got[:1, r0:r1]
        d = (mine.float() - mirror.float()).abs()
        bound = FL.mirror_bound_bf16(mine, mirror, slack)
        d_max, differ = max(d_max, float(d.max())), differ + int((d > 0).sum())
        n, of_bound = n + d.numel(), max(of_bound, float((d / bound).max()))
    return d_max, differ, n, of_bound, spans


def sdpa_call(torch, q, k, v, kw):
    """The library's attention on the inputs of ``flash_attention(q, k, v,
    **kw)``: a call of ``scaled_dot_product_attention`` with heads first,
    the KV head repeated for every query head and the same mask (its
    output is (B, H, T, hd))."""
    import torch.nn.functional as F
    T, H, S = q.shape[1], q.shape[2], k.shape[1]
    qs = q.transpose(1, 2)
    ks = k.transpose(1, 2).repeat_interleave(H // k.shape[2], dim=1)
    vs = v.transpose(1, 2).repeat_interleave(H // k.shape[2], dim=1)
    if kw["window"] is None:
        return lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=kw["causal"])
    pos_q = torch.arange(T, device=q.device)[:, None]
    pos_k = torch.arange(S, device=q.device)[None, :]
    mask = pos_q - pos_k < kw["window"]
    if kw["causal"]:
        mask &= pos_q >= pos_k
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)


def flash_hold(torch, np, FL, seen, label, kind="flash_attention"):
    """``flash_attention`` against its plain version on the inputs the
    first attention call of ``kind`` (:func:`kernel_kind`) in a
    full-width prefill gave it (taken out of ``seen``), timed there
    beside ``scaled_dot_product_attention`` on the same tensors with the
    same mask.  Float32 inputs run the split-TF32 instance (held to
    ``FLASH_TOL``), bfloat16 ones the bfloat16 instance (held to the
    plain version at ``BF16_PLAIN_TOL`` and to its mirror on the rows of
    :func:`mirror_spans` within its bound).  Returns the kernel's
    record."""
    (q, k, v), kw = seen.pop(kind)
    B, T, H, hd = q.shape
    S = k.shape[1]
    bf16 = q.dtype == torch.bfloat16
    tol = FL.BF16_PLAIN_TOL if bf16 else FLASH_TOL
    got = FL.flash_attention(q, k, v, **kw)
    want = FL.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(err <= tol, f"flash_attention {label.strip() or 'prefill'}: "
          f"kernel vs plain max abs err {err} > {tol}")
    del want
    mirror = flash_mirror_rows(torch, FL, q, k, v, got, kw) if bf16 else None
    if mirror is not None:
        check(mirror[3] <= 1.0, f"flash_attention {label.strip()}: kernel vs "
              f"mirror {mirror[0]} beyond its bound ({mirror[3]:.3f} of it)")
    ms = cuda_ms(torch, lambda: FL.flash_attention(q, k, v, **kw), 5)
    plain_ms = cuda_ms(torch, lambda: FL.flash_attention_plain(q, k, v, **kw),
                       2)
    sdpa = sdpa_call(torch, q, k, v, kw)
    lib_err = float((sdpa().transpose(1, 2).float() - got.float())
                    .abs().max())
    lib_ms = cuda_ms(torch, sdpa, 5)
    del sdpa, got
    pairs = live_pairs(np, T, S, kw["causal"], kw["window"]) * B * H
    # the kernel's products: 4*hd operations a live pair, three TF32 MMAs
    # each (split TF32) for float32 inputs, one bfloat16 MMA for
    # bfloat16 ones; the FFMA bound of the same pairs beside the first
    if bf16:
        t_ops = 4 * hd * pairs / BF16_OPS_PER_S
        rate = "bfloat16 on the tensor cores"
    else:
        t_ops = SPLIT_TF32_MMAS * 4 * hd * pairs / TF32_OPS_PER_S
        rate = "split TF32 on the tensor cores"
    t_ffma = 4 * hd * pairs / FP32_OPS_PER_S
    t_bytes = 2 * (q.numel() + k.numel()) * q.element_size() / HBM_BYTES_PER_S
    rec = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_share=max(t_ops, t_bytes) * 1e3 / ms,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=lib_ms, library_max_abs_diff=lib_err, live_pairs=pairs,
        q_shape=list(q.shape), kv_shape=list(k.shape), causal=kw["causal"],
        window=kw["window"], dtype=str(q.dtype).removeprefix("torch."))
    if bf16:
        rec.update(mirror_max_abs=mirror[0], mirror_differing=mirror[1],
                   mirror_compared=mirror[2], mirror_of_bound=mirror[3],
                   mirror_rows=[list(sp) for sp in mirror[4]])
        extra = (f" vs mirror (batch row 0, rows "
                 f"{', '.join(f'{a}-{b - 1}' for a, b in mirror[4])}) "
                 f"{mirror[0]:.3e}, {mirror[1]} of {mirror[2]} "
                 f"elements differ, {mirror[3]:.3f} of its bound;")
    else:
        rec["ffma_bound_ms"] = t_ffma * 1e3
        extra = f" ffma_bound_ms={t_ffma * 1e3:.4f}"
    print(f"[kernel] flash_attention{' ' + label.strip() if label else ''}: "
          f"q {tuple(q.shape)} k,v {tuple(k.shape)} {rec['dtype']} "
          f"causal={kw['causal']} window={kw['window']} live_pairs={pairs} "
          f"max_abs_err={err:.3e} (tol {tol:g}) ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={rec['bound_ms']:.4f} ({rate}; "
          f"{rec['bound_share']:.3f} of it reached){extra} sdpa_ms="
          f"{lib_ms:.4f} (sdpa vs kernel {lib_err:.3e})",
          flush=True)
    return rec


def rg_kernel_phase(torch, np, FL, LS, seen):
    """recurrentgemma-2b's holds: both kernels on the prefill's inputs
    (``lru_hold``, ``flash_hold``), ``lru_scan`` on edge shapes and
    ``flash_attention`` beyond the prefill's instance (``FLASH_EXTRA``)."""
    out = {"lru_scan": lru_hold(torch, LS, seen, ""),
           "flash_attention": flash_hold(torch, np, FL, seen, "")}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    for Bx, Tx, Wx in LRU_EDGES:
        xs = (torch.rand(Bx, Tx, Wx, generator=g, device=dev),
              torch.randn(Bx, Tx, Wx, generator=g, device=dev),
              torch.randn(Bx, Wx, generator=g, device=dev))
        got, want = LS.lru_scan(*xs), LS.lru_scan_plain(*xs)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, want))
        label = f"edge B={Bx} T={Tx} W={Wx}"
        out["lru_scan"]["errs"][label] = max(
            float((x - y).abs().max()) for x, y in zip(got, want))
        print(f"[kernel] lru_scan {label}: equal to plain {same}", flush=True)
        check(same, f"lru_scan {label}: kernel differs from plain")
    out["lru_scan"]["max_abs_err"] = max(out["lru_scan"]["errs"].values())
    extra = out["flash_attention"]["extra"] = {}
    g = torch.Generator(device=dev).manual_seed(11)
    for label, Bx, Tx, Hx, KVHx, hdx, causal, window in FLASH_EXTRA:
        qx = torch.randn(Bx, Tx, Hx, hdx, generator=g, device=dev)
        kx = torch.randn(Bx, Tx, KVHx, hdx, generator=g, device=dev)
        vx = torch.randn(Bx, Tx, KVHx, hdx, generator=g, device=dev)
        kwx = dict(causal=causal, window=window)
        got = FL.flash_attention(qx, kx, vx, **kwx)
        want = FL.flash_attention_plain(qx, kx, vx, **kwx)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= FLASH_TOL, f"flash_attention {label}: kernel vs plain "
              f"max abs err {err}")
        ms = cuda_ms(torch, lambda: FL.flash_attention(qx, kx, vx, **kwx), 5)
        pairs = live_pairs(np, Tx, Tx, causal, window) * Bx * Hx
        bound = SPLIT_TF32_MMAS * 4 * hdx * pairs / TF32_OPS_PER_S * 1e3
        extra[label] = dict(max_abs_err=err, ms=ms, bound_ms=bound,
                            q_shape=list(qx.shape), kv_shape=list(kx.shape),
                            causal=causal, window=window)
        print(f"[kernel] flash_attention {label}: q {tuple(qx.shape)} k,v "
              f"{tuple(kx.shape)} causal={causal} window={window} "
              f"max_abs_err={err:.3e} ms={ms:.4f} bound_ms={bound:.4f}",
              flush=True)
    return out


def profile_window(torch, fn):
    """Device time by kernel name over ``fn()`` from ``torch.profiler``,
    and the same window's host-clock time (which the tracing inflates)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    by_name, n_kernels = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e6)
    return wall_s, n_kernels, sorted(by_name.items(), key=lambda kv: -kv[1])


def lm_profile(torch, T_, model, cfg, run, feed, prompt_len, timings,
               n_dec=4, rules=None):
    """Where a full-width prefill and ``n_dec`` decode steps spend device
    time, and the device's idle share: 1 - device busy time over the
    host-clock time of the same profiled window.  The tracing slows the
    host, so the share is an upper bound on the unprofiled serve's; that
    serve's own host-clock time is printed beside it."""
    state = {}

    def do_prefill():
        state["last"], state["cache"] = T_.prefill(
            model, feed(prompt_len), cfg, run, max_len=prompt_len + n_dec,
            rules=rules)

    def do_decode():
        tok = torch.argmax(state["last"], dim=-1)[:, None]
        for i in range(n_dec):
            logits, _ = T_.decode_step(model, state["cache"], tok,
                                       prompt_len + i, cfg, run, rules)
            tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
    out = {}
    for label, fn, steps, unprofiled_s in (
            ("prefill", do_prefill, 1, timings["prefill_s"]),
            ("decode", do_decode, n_dec,
             timings["decode_s"] / timings["decode_steps"])):
        wall_s, n_kernels, kernels = profile_window(torch, fn)
        busy_s = sum(t for _, t in kernels) / steps
        top = [(name[:70], t / steps) for name, t in kernels[:6]]
        profiled_s = wall_s / steps
        idle = 1.0 - busy_s / profiled_s if busy_s else None
        out[label] = dict(device_busy_s=busy_s, profiled_wall_s=profiled_s,
                          unprofiled_s=unprofiled_s, idle_share=idle,
                          kernels=n_kernels / steps, top_kernels_s=top)
        share = ", ".join(f"{n} {t * 1e3:.3f} ms" for n, t in top)
        print(f"[profile] {cfg.name}"
              f"{' ' + run.moe_impl if rules is not None else ''} {label} (per "
              f"{'step' if steps > 1 else 'call'}): "
              f"{n_kernels / steps:.0f} kernels, device busy "
              f"{busy_s * 1e3:.3f} ms of {profiled_s * 1e3:.3f} ms under the "
              f"profiler (idle share "
              f"{'not measured' if idle is None else f'{idle:.3f}'}; "
              f"unprofiled serve {unprofiled_s * 1e3:.3f} ms); "
              f"top kernels: {share}", flush=True)
    state.clear()
    return out


def moe_timer(torch, L):
    """A ``layers.moe_dense`` that brackets each call with CUDA events;
    ``done()`` restores it and gives the calls' summed device-clock
    seconds."""
    orig, marks = L.moe_dense, []

    def call(*args, **kw):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = orig(*args, **kw)
        b.record()
        marks.append((a, b))
        return out

    def done():
        L.moe_dense = orig
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in marks) / 1e3
    L.moe_dense = call
    return done


def route_flips(torch, pre, dec, full):
    """(layer, token) pairs whose top-k expert set differs between
    prefill(T) + decode(T) and prefill(T + 1), and their number."""
    flips = 0
    for a, b, c in zip(pre, dec, full):
        flips += int((torch.cat([a, b], dim=1) != c).any(-1).sum())
    return flips, sum(int(c.shape[0] * c.shape[1]) for c in full)


def lm_phase(torch, np, mod, all_launches, arch, batch, prompt_len, n_new,
             holds, n_layers=None, enc_frames=None, dtype=None, then=None):
    """One architecture at its published width (and depth, or the first
    ``n_layers`` layers), its weights stored and computed in ``dtype``
    (``RunCfg(dtype=)``; float32 unless given): the prefill/decode
    consistency check (capturing
    the kernels' inputs; for an MoE arch also each layer's top-k expert
    sets, and ``moe_dense``'s device time in prefill), ``holds(seen)``
    holding each kernel against its plain version on them, then the
    serve through ``LMEngine.generate`` with its launch counts, and a
    profiled prefill and four decode steps.  An encoder-decoder arch
    reads ``enc_frames`` frame embeddings drawn on the card.  Returns
    ``(kernel records, launches by kind, serve record)``, the record
    holding the served tokens and the checked prefill's last logits (a
    host tensor, ``last_logits``); the model is freed before it
    returns.  ``then(model, cfg, prompt, dense)``, where given, runs on
    the same weights after the serve (``dense``: its prefill and decode
    times and the checked prefill's last logits); its result is the
    record's ``then``."""
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bfloat16 products sum in float32, as JAX's preferred_element_type
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    T_, cfgs, ops = mod("models.transformer"), mod("configs"), \
        mod("kernels.ops")
    L = mod("models.layers")
    FL, LS = mod("kernels.flash_attention"), mod("kernels.lru_scan")
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    full_cfg = cfgs.get_config(arch)
    cfg = (dataclasses.replace(full_cfg, n_layers=n_layers) if n_layers
           else full_cfg)
    depth = (f"{cfg.n_layers} of {full_cfg.n_layers} layers" if n_layers
             else f"{cfg.n_layers} layers")
    if cfg.n_encoder_layers:
        depth += f" + {cfg.n_encoder_layers} encoder layers"
    run = T_.RunCfg(impl="flash", dtype=dtype)
    dname = str(dtype).removeprefix("torch.")
    fa_key = "flash_attention.bfloat16" if bf16 else "flash_attention"
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    model, init_s = wall(torch, lambda: T_.init_lm(cfg, gen, device=dev,
                                                   dtype=dtype))
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len + 1),
                           generator=gen, device=dev)
    enc = (torch.randn(batch, enc_frames, cfg.d_model, generator=gen,
                       device=dev) if cfg.n_encoder_layers else None)

    def feed(n):
        out = {"tokens": prompt[:, :n]}
        if enc is not None:
            out["enc_embeds"] = enc
        return out
    elem = torch.tensor([], dtype=dtype).element_size()
    print(f"[lm] {arch}: {depth}, d_model {cfg.d_model}, {n_params} "
          f"parameters ({n_params * elem / 1e9:.3f} GB {dname}), initialised "
          f"on the card in {init_s:.2f} s (peak {init_peak_gb:.3f} GB)"
          + (f"; {enc_frames} encoder frames a sequence" if enc is not None
             else ""), flush=True)

    # prefill(T) + decode(T) against prefill(T + 1): T + 1 rows leave the
    # kernels' last tile (attention) and ring chunk (scan) ragged
    routes = {}

    def routed(label, fn):
        if cfg.moe is None:
            return fn()
        out, routes[label] = capture_routes(L, fn)
        return out
    ((last, cache), seen, _), pre_s = wall(torch, lambda: routed(
        "pre", lambda: capture_kernel_inputs(ops, lambda: T_.prefill(
            model, feed(prompt_len), cfg, run, max_len=prompt_len + 1))))
    dec, _ = routed("dec", lambda: T_.decode_step(
        model, cache, prompt[:, prompt_len:], prompt_len, cfg, run))
    del cache
    timer = moe_timer(torch, L) if cfg.moe is not None else None
    full, full_s = wall(torch, lambda: routed("full", lambda: T_.prefill(
        model, feed(prompt_len + 1), cfg, run)[0]))
    moe_s = timer() if timer else None
    d = float((dec[:, 0] - full).abs().max())
    top = float(full.abs().max())
    # float32: CONSIST_TOL; bfloat16: JAX's own relative gap fitted to
    # the published size, times the margin, times this run's max |logit|
    tol = (JAX_BF16_REL_GAP[arch] * BF16_GAP_MARGIN * top
           if bf16 else CONSIST_TOL)
    finite = bool(torch.isfinite(full).all() and torch.isfinite(dec).all())
    flips = (route_flips(torch, routes["pre"], routes["dec"], routes["full"])
             if routes else None)
    routes.clear()
    print(f"[check] {arch}{' bfloat16' if bf16 else ''} prefill "
          f"{prompt_len} ({pre_s:.3f} s) + decode "
          f"of token {prompt_len} vs prefill {prompt_len + 1} ({full_s:.3f} "
          f"s): max |d| logits {d:.3e} (tol {tol:.4g}"
          + (f" = JAX's relative gap fitted to this size "
             f"{JAX_BF16_REL_GAP[arch]:.4g} x margin {BF16_GAP_MARGIN} x "
             f"max |logit|"
             if bf16 else "") + f"), logits "
          f"{tuple(full.shape)} finite {finite}, max |logit| {top:.3f}"
          + (f"; top-{cfg.moe.top_k} expert sets differing between the two "
             f"runs: {flips[0]} of {flips[1]} (layer, token) pairs; "
             f"moe_dense {moe_s:.3f} s of the prefill ({moe_s / full_s:.3f})"
             if flips else ""), flush=True)
    check(finite and tuple(full.shape) == (batch, cfg.vocab),
          f"{arch} logits finite and of shape (B, V)")
    check(d <= tol, f"{arch} {dname} prefill/decode consistency {d} > {tol}"
          + (f" ({flips[0]} routing flips)" if flips else ""))
    del dec, full

    kern = holds(seen)
    del seen

    # the serve, through the engine a user calls
    eng = mod("serve.engine").LMEngine(model, cfg, run, batch=batch,
                                       max_len=prompt_len + n_new)
    prompt_np = prompt[:, :prompt_len].cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(all_launches)
    (out, _, calls), gen_s = wall(torch, lambda: capture_kernel_inputs(
        ops, lambda: eng.generate(prompt_np, n_new, enc_embeds=enc),
        keep=False))
    launches = {fa_key: FL.LAUNCHES[fa_key],
                "lru_scan": LS.LAUNCHES["lru_scan"]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tm = eng.timings
    kinds = [cfg.block_kind(i) for i in range(cfg.n_layers)] + [
        cfg.block_kind(i) for i in range(cfg.n_encoder_layers)]
    cross = cfg.n_layers if cfg.n_encoder_layers else 0
    want = {fa_key: sum(k in ("attn", "local") for k in kinds) + cross,
            "lru_scan": sum(k in ("rglru", "mamba") for k in kinds)}
    decode_ms = tm["decode_s"] / tm["decode_steps"] * 1e3
    tok_s = batch * n_new / gen_s
    print(f"[main] {arch} serve{' bfloat16' if bf16 else ''} ({depth}"
          f"{', weights ' + dname if bf16 else ''}): batch {batch}, prompt "
          f"{prompt_len}, {n_new} new tokens in {gen_s:.3f} s: prefill "
          f"{tm['prefill_s']:.3f} s, decode {decode_ms:.3f} ms/token, "
          f"{tok_s:.2f} tokens/s ({batch * n_new} generated), "
          f"{batch * (prompt_len + n_new) / gen_s:.1f} prompt+generated "
          f"tokens/s; launches {json.dumps(launches)} by kind "
          f"{json.dumps(calls)}; peak device memory {peak_gb:.3f} GB",
          flush=True)
    check(launches == want, f"{arch} launches {launches}, want {want} (one "
          "prefill, none in decode)")
    check(sum(n for k, n in calls.items() if k.startswith("flash")) ==
          launches[fa_key], f"{arch} calls by kind {calls}")
    check(peak_gb < 80.0, f"{arch} peak memory {peak_gb} GB")
    check(out.shape == (batch, n_new) and (out >= 0).all()
          and (out < cfg.vocab).all(), f"{arch} generated tokens")
    top2 = torch.topk(last, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1] > CONSIST_TOL).cpu().numpy()
    first = torch.argmax(last, dim=-1).cpu().numpy()
    check((out[sure, 0] == first[sure]).all(),
          f"{arch} first served token vs the checked prefill's argmax")
    prof = lm_profile(torch, T_, model, cfg, run, feed, prompt_len, tm)
    last_logits = last.float().cpu()
    del eng
    after = None
    if then is not None:
        torch.cuda.empty_cache()
        after = then(model, cfg, prompt, dict(
            prefill_s=tm["prefill_s"], decode_ms=decode_ms, last_logits=last))
    del model, last, enc
    torch.cuda.empty_cache()
    return kern, calls, dict(
        dtype=dname, tokens=out.tolist(), last_logits=last_logits,
        init_peak_gb=init_peak_gb, consistency_tol=tol,
        profile=prof, layers=cfg.n_layers, published_layers=full_cfg.n_layers,
        encoder_layers=cfg.n_encoder_layers, encoder_frames=enc_frames,
        batch=batch, prompt=prompt_len, new_tokens=n_new, params=n_params,
        init_s=init_s, prefill_s=tm["prefill_s"],
        decode_ms_per_token=decode_ms, tokens_per_s=tok_s, generate_s=gen_s,
        peak_device_gb=peak_gb, consistency_max_abs=d, check_prefill_s=pre_s,
        check_prefill_plus_one_s=full_s, launches=launches,
        routing_flips=None if flips is None else list(flips),
        moe_dense_s=moe_s, then=after)


def pricing_grids(api, cfgs, np):
    """The main path's three grids: 256 of the paper's American puts at
    its depth (the paper's bull spread needs more than 128 knots at
    N=1500: see the [knots] line); calls and bull spreads at full width
    and capacity, cut in depth; the friction-free grid at the appendix
    depth."""
    put_cfg, notc_cfg = cfgs.PAPER_PUT, cfgs.PAPER_NOTC
    tc_grid = api.ScenarioGrid.cartesian(
        s0=tuple(np.linspace(90.0, 110.0, 32)), sigma=put_cfg.sigma,
        rate=put_cfg.rate, maturity=put_cfg.maturity,
        cost_rate=(0.005, 0.01), payoff=put_cfg.payoff,
        strike=(95.0, 100.0, 105.0, 110.0), n_steps=put_cfg.n_steps)
    cb_grid = api.ScenarioGrid.cartesian(
        s0=tuple(np.linspace(90.0, 110.0, 32)), sigma=put_cfg.sigma,
        rate=put_cfg.rate, maturity=put_cfg.maturity,
        cost_rate=(0.005, 0.01), payoff=("call", "bull_spread"),
        strike=(95.0, 105.0), n_steps=CB_STEPS)
    notc_grid = api.ScenarioGrid.cartesian(
        s0=tuple(np.linspace(80.0, 120.0, 32)), sigma=notc_cfg.sigma,
        rate=notc_cfg.rate, maturity=notc_cfg.maturity,
        payoff=("put", "call"), strike=(90.0, 95.0, 100.0, 105.0),
        n_steps=notc_cfg.n_steps)
    return tc_grid, cb_grid, notc_grid


def lsmc_ls_grid(api, maturity, n_steps):
    """Longstaff & Schwartz (2001), Table 1: American puts, K=40, r=0.06,
    s0 in {36, ..., 44} x sigma in {0.2, 0.4}, 50 exercise dates a year
    (every step of the tree's clock)."""
    return api.ScenarioGrid.cartesian(
        s0=LS_SPOTS, sigma=LS_SIGMAS, rate=0.06, maturity=maturity,
        payoff="put", strike=40.0, n_steps=n_steps)


def zero_counts(all_launches):
    for counts in all_launches:
        for key in counts:
            counts[key] = 0


def launch_counts(all_launches):
    return {k: v for counts in all_launches for k, v in counts.items()}


def lsmc_normals_check(torch, np, grid, n_paths, rows=2):
    """The sampler on the card against the host at a grid's full shape
    (its first ``rows`` rows): the keys and uniforms are integer
    arithmetic and must be equal bit for bit; the normals differ by the
    two devices' ``erfinv``."""
    import repro_torch.core.lsmc as LSM
    n_sim = sum(1 for t in (grid.exercise_steps or range(grid.n_steps + 1))
                if t > 0)
    shape = (n_paths // 2, n_sim, grid.n_assets)
    keys = LSM.path_keys(0, grid.n_scenarios)[:rows]
    dev = torch.device("cuda")
    (u_card, z_card), card_s = wall(torch, lambda: (
        LSM.uniforms(keys.to(dev), shape), LSM.normals(keys.to(dev), shape)))
    u_host, z_host = LSM.uniforms(keys, shape), LSM.normals(keys, shape)
    same_u = bool(torch.equal(u_card.cpu(), u_host))
    d = float((z_card.cpu() - z_host).abs().max())
    print(f"[check] LSMC normals card vs host: keys of seed 0, {rows} rows "
          f"of {shape} (the Longstaff-Schwartz T=1 grid's): uniforms equal "
          f"{same_u}, normals max |d| {d:.3e} (card {card_s * 1e3:.2f} ms "
          "for both)", flush=True)
    check(same_u, "LSMC uniforms: card differs from host")
    check(d <= 1e-12 * float(z_host.abs().max()),
          f"LSMC normals card vs host {d}")
    return dict(rows=rows, shape=list(shape), uniforms_equal=same_u,
                normals_max_abs=d, card_s=card_s)


def lsmc_phase(torch, np, api, all_launches):
    """The LSMC engine's main lines, each after a warm-up: the two
    Longstaff-Schwartz grids and 64 Bermudan basket puts; then the
    estimator against the lattice kernel's price (3 standard errors)."""
    ls_cfg = api.ExecutionConfig(engine="lsmc", n_paths=LS_PATHS,
                                 basis="laguerre", degree=3)
    out = {}
    jobs = [(f"Longstaff-Schwartz puts T={T:g}", lsmc_ls_grid(api, T, N),
             ls_cfg) for T, N in ((1.0, 50), (2.0, 100))]
    basket = api.ScenarioGrid.cartesian(
        s0=tuple(np.linspace(90.0, 110.0, 8)), sigma=(0.2, 0.3), rate=0.05,
        maturity=1.0, payoff="put", strike=(95.0, 100.0, 105.0, 110.0),
        n_steps=BASKET_STEPS, n_assets=BASKET_ASSETS,
        exercise_steps=tuple(range(5, BASKET_STEPS + 1, 5)))
    jobs.append(("basket", basket, api.ExecutionConfig(
        engine="lsmc", n_paths=BASKET_PATHS)))
    for label, grid, cfg in jobs:
        api.price_grid(grid, execution=cfg)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(all_launches)
        res, s = wall(torch, lambda: api.price_grid(grid, execution=cfg))
        launches = launch_counts(all_launches)
        peak = torch.cuda.max_memory_allocated() / 1e9
        n = grid.n_scenarios
        dates = sum(1 for t in (grid.exercise_steps
                                or range(grid.n_steps + 1)) if t > 0)
        se = float(res.stderr.max())
        rec = dict(contracts=n, n_steps=grid.n_steps, n_assets=grid.n_assets,
                   paths=cfg.n_paths, dates=dates, wall_s=s,
                   contracts_per_s=n / s,
                   path_dates_per_s=n * cfg.n_paths * dates / s,
                   max_stderr=se, peak_device_gb=peak, launches=launches,
                   prices=res.ask.ravel().tolist())
        out[label] = rec
        line = (f"[main] LSMC {label}: {n} contracts, N={grid.n_steps}, "
                f"d={grid.n_assets}, {cfg.n_paths} paths x {dates} dates"
                f"{', antithetic, laguerre 3' if 'Longstaff' in label else ''}"
                f": {s:.3f} s after a warm-up, {n / s:.2f} contracts/s, "
                f"{n * cfg.n_paths * dates / s:.4e} paths*dates/s, max "
                f"stderr {se:.5f}, peak device memory {peak:.3f} GB, kernel "
                f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
        # where the time goes: device busy over the profiled window
        wall_p, n_k, kernels = profile_window(
            torch, lambda: api.price_grid(grid, execution=cfg))
        busy = sum(t for _, t in kernels)
        rec["profile"] = dict(wall_s=wall_p, device_busy_s=busy,
                              idle_share=1.0 - busy / wall_p, kernels=n_k,
                              top_kernels_s=[(k[:60], t)
                                             for k, t in kernels[:5]])
        print(f"[profile] LSMC {label}: {n_k} kernels, device busy "
              f"{busy * 1e3:.3f} ms of {wall_p * 1e3:.3f} ms under the "
              f"profiler (idle share {1.0 - busy / wall_p:.3f}); top "
              "kernels: " + ", ".join(f"{k[:60]} {t * 1e3:.3f} ms"
                                      for k, t in kernels[:5]), flush=True)
        if "Longstaff" in label:
            table = np.array([LS_TABLE1[(s0, sig, grid.maturity[0])]
                              for s0, sig in zip(grid.s0, grid.sigma)])
            dev = res.ask.ravel() - table
            rec["vs_ls_table1_fd"] = dev.tolist()
            line += (f"; vs LS (2001) Table 1 finite-difference values: max "
                     f"|d| {np.abs(dev).max():.4f}, prices "
                     f"{[round(x, 4) for x in res.ask.ravel().tolist()]}")
        print(line, flush=True)
        check(np.isfinite(res.ask).all() and (res.ask >= 0).all()
              and np.array_equal(res.ask, res.bid), f"LSMC {label} prices")
        check(np.isfinite(res.stderr).all() and (res.stderr >= 0).all()
              and se > 0, f"LSMC {label} stderr")
        check(res.ask.shape == grid.shape and res.engine == "lsmc",
              f"LSMC {label} shape and engine")
        # the card's sampler and chunks at full size against the same rows
        # priced on the host: both draw JAX's threefry paths, so the prices
        # agree to the float64 tolerance (erfinv and the Gram products
        # round apart by ulps); the gap in combined SEs is kept beside it
        host = api.price_grid(grid, execution=dataclasses.replace(
            cfg, device="cpu"))
        spread = np.sqrt(res.stderr ** 2 + host.stderr ** 2)
        gap = np.abs(res.ask - host.ask) / spread
        d_host = float(max(np.abs(res.ask - host.ask).max(),
                           np.abs(res.bid - host.bid).max()))
        rec["vs_host_gap_se"] = gap.ravel().tolist()
        rec["vs_host_max_abs"] = d_host
        print(f"[check] LSMC {label} card vs host: {n} contracts, "
              f"{cfg.n_paths} paths each, max |card - host| ask, bid "
              f"{d_host:.3e} (tol {TOL:g}) = {gap.max():.2e} combined SE "
              f"(limit {LSMC_HOST_SE:g})", flush=True)
        check(np.isfinite(host.ask).all() and (gap <= LSMC_HOST_SE).all(),
              f"LSMC {label} card within {LSMC_HOST_SE:g} combined SE of "
              "the host")
        check(d_host <= TOL, f"LSMC {label} card vs host ask/bid {d_host}")
    out["normals"] = lsmc_normals_check(torch, np, jobs[0][1], LS_PATHS)
    # the estimator against the lattice at the bar of tests/test_lsmc.py
    one = dict(s0=100.0, sigma=0.2, rate=0.1, maturity=0.25, payoff="put",
               strike=100.0, n_steps=200)
    mc = api.price_grid(execution=api.ExecutionConfig(
        engine="lsmc", n_paths=8192, mc_seed=0), **one)
    lat = api.price_grid(execution=api.ExecutionConfig(engine="notc"), **one)
    p, o, se = float(mc.ask.ravel()[0]), float(lat.ask.ravel()[0]), \
        float(mc.stderr.ravel()[0])
    print(f"[check] LSMC vs lattice: put s0=100 sigma=0.2 r=0.1 T=0.25 "
          f"N=200, 8192 paths, seed 0: lsmc {p:.6f} se {se:.6f}, no-TC "
          f"kernel {o:.6f}: |d| = {abs(p - o) / se:.2f} SE (limit 3)",
          flush=True)
    check(se > 0 and abs(p - o) <= 3.0 * se, "LSMC within 3 SE of lattice")
    out["vs_lattice"] = dict(lsmc=p, stderr=se, lattice=o,
                             gap_se=abs(p - o) / se)
    return out


def layout_phase(torch, np, api, tc_grid, notc_grid, notc_cfg, capacity,
                 all_launches):
    """Each grid under devices=1, devices=4 (simulated on one card) and
    mesh=(cuda:0,)*4 (the real per-shard dispatch), held bit for bit:
    ask, bid, row_pieces and stderr.  The launches of each layout's run
    are counted from 0."""
    cuda0 = torch.device("cuda", 0)
    ls = lsmc_ls_grid(api, 1.0, 50)
    ls_cfg = dict(engine="lsmc", n_paths=LS_PATHS, basis="laguerre",
                  degree=3)
    # (label, grid, price_grid kwargs, execution fields, the kernel its
    # layouts must launch, the label whose devices=1 result it is held to)
    cases = (("TC put grid", tc_grid, dict(capacity=capacity), {},
              "rz_round", None),
             ("no-TC grid", notc_grid, dict(levels=notc_cfg.round_depth,
                                            block=256), {},
              "lattice_round_param", None),
             ("LS T=1 grid", ls, {}, ls_cfg, None, None),
             ("LS T=1 grid pad_to(16)", ls.pad_to(16), {}, ls_cfg, None,
              "LS T=1 grid"))
    out, bases = {}, {}
    for label, grid, kw, ex, kernel, held_to in cases:
        base = bases.get(held_to)
        rows = {}
        for layout, lk in (("devices=1", dict(devices=1)),
                           ("devices=4", dict(devices=4)),
                           ("mesh=(cuda:0,)*4", dict(mesh=(cuda0,) * 4))):
            mesh = lk.pop("mesh", None)
            cfg = api.ExecutionConfig(**ex, **lk)
            zero_counts(all_launches)
            res, s = wall(torch, lambda: api.price_grid(
                grid, execution=cfg, mesh=mesh, **kw))
            launches = launch_counts(all_launches)
            if base is None:
                base = bases[label] = res
            n = base.grid.n_scenarios
            eq = {f: (getattr(base, f) is None and getattr(res, f) is None)
                  or bool(np.array_equal(getattr(base, f).ravel(),
                                         getattr(res, f).ravel()[:n]))
                  for f in ("ask", "bid", "row_pieces", "stderr")}
            si = res.shard_info
            info = None if si is None else dict(
                rows=list(si.per_shard_rows),
                pieces=list(si.per_shard_pieces),
                measured_work=list(si.measured_work),
                work_spread=si.plan.work_spread, simulated=si.simulated)
            rows[layout] = dict(wall_s=s, equal=eq, shard_info=info,
                                launches=launches)
            print(f"[check] layout {label} {layout}: {s:.3f} s, array_equal "
                  f"{json.dumps(eq)}, shard_info "
                  f"{json.dumps(info)}, launches "
                  f"{json.dumps({k: v for k, v in launches.items() if v})}",
                  flush=True)
            check(all(eq.values()), f"layout {label} {layout}: {eq}")
            if kernel is not None:
                check(launches[kernel] > 0,
                      f"layout {label} {layout}: {kernel} not launched")
            check(layout == "devices=1" or (
                info is not None and info["simulated"] == (
                    layout == "devices=4")), f"layout {label} {layout}: "
                  "shard_info")
        out[label] = rows
    return out


# the node axis (core/distributed.py): PAPER_PUT's 256 puts on meshes
# 1 x W of cuda:0 (and of distinct cards where the machine has them),
# PAPER_NOTC's 256 puts on 1 x 4
NODE_WIDTHS, NODE_NOTC_WIDTH = (1, 2, 4), 4


def node_rz_state(torch, R, put, s0, lanes, lane0, dtype=None):
    """PAPER_PUT's fused leaf over a shard buffer of ``lanes`` lanes from
    tree column ``lane0``, for the spots ``s0``, and its round scalars at
    the first round (lvl0 = N + 1), computed in ``dtype`` (default
    float64)."""
    dev = torch.device("cuda")
    n = len(s0)
    dtype = dtype or torch.float64
    t = lambda x: torch.full((n,), float(x), dtype=dtype, device=dev)
    params = R.rz_params(torch.as_tensor(s0, dtype=dtype, device=dev),
                         t(put.sigma),
                         t(put.rate), t(put.maturity), t(put.cost_rate),
                         n_steps=put.n_steps)
    leaf = R.leaf_level(put.n_steps, params, put.capacity, lanes, lane0)
    z = leaf.map(lambda a: a[:, None].expand(
        (n, 2) + a.shape[1:]).contiguous())
    sc = torch.stack([t(put.n_steps + 1), params["s0"],
                      params["sig_sqrt_dt"], params["r"], params["k"],
                      t(1.0), t(-1.0), t(0.0), t(0.0), t(put.strike),
                      t(put.strike)], dim=1)
    return z, sc.contiguous()


def node_kernel_holds(torch, np, B, RS, R, D, put, notc):
    """Both kernels with lane0 > 0 and (rz_round) owned < lanes against
    their plain versions, at the shapes of shard 1 of the 1 x 4 node axis:
    rz_round on PAPER_PUT's [S | H] buffer at the leaf, lattice_round on
    PAPER_NOTC's buffer padded to the block."""
    out = {}
    n = put.contracts
    plan = D.plan_rounds(put.n_steps, NODE_NOTC_WIDTH, put.round_depth)
    S, H = plan["shard_lanes"], plan["halo"]
    z, sc = node_rz_state(torch, R, put, np.linspace(90.0, 110.0, n), S + H,
                          S)
    kw = dict(lane0=S, owned=S)
    got, pieces, plain_ms, err = rz_hold(torch, RS, "lane0", z, sc, H, S + H,
                                         **kw)
    ms = cuda_ms(torch, lambda: RS.rz_round(z, sc, levels=H, block=S + H,
                                            **kw), 20)
    bound, bound_by, ops, nbytes = rz_bound(torch, z, got, sc, H,
                                            put.capacity, lane0=S)
    out["rz_round lane0"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound, bound_by=bound_by, rows=n,
                                 lanes=S + H, levels=H, lane0=S, owned=S,
                                 pieces=int(pieces.max()))
    print(f"[kernel] rz_round lane0: rows={n} N={put.n_steps} lanes={S + H} "
          f"lane0={S} owned={S} levels={H} K={put.capacity} max_abs_err="
          f"{err:.3e} equal_m=True pieces={int(pieces.max())} ms={ms:.4f} "
          f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f} ({bound_by}: "
          f"{ops:.4e} float64 operations, {nbytes:.4e} bytes)", flush=True)

    block = B.DEFAULT_BLOCK
    plan = D.plan_rounds(notc.n_steps - 1, NODE_NOTC_WIDTH, notc.round_depth)
    S, H = plan["shard_lanes"], plan["halo"]
    P = -(-(S + H) // block) * block
    x, s = lattice_inputs(torch, torch.device("cuda"), n, P,
                          float(notc.n_steps), "put")
    got = B.lattice_round(x, s, levels=H, block=block, lane0=S)
    (want, plain_ms) = timed_once(torch, lambda: B.lattice_round_plain(
        x, s, levels=H, block=block, kind="put", lane0=S))
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"lattice_round lane0: kernel differs from "
          f"plain (max abs err {err})")
    ms = cuda_ms(torch, lambda: B.lattice_round(x, s, levels=H, block=block,
                                                lane0=S), 20)
    bound, bound_by = lattice_bound(torch, x, s, "put", H)
    out["lattice_round lane0"] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms, bound_ms=bound,
                                      bound_by=bound_by, rows=n, P=P,
                                      levels=H, block=block, lane0=S)
    print(f"[kernel] lattice_round lane0: rows={n} P={P} lane0={S} "
          f"levels={H} block={block} max_abs_err={err:.3e} ms={ms:.4f} "
          f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f}", flush=True)
    return out


def node_meshes(torch, D, width):
    """(label, mesh): 1 x width of cuda:0, then of distinct cards where
    the machine has that many."""
    cuda0 = torch.device("cuda", 0)
    out = [(f"1 x {width} on cuda:0",
            D.DeviceMesh([[cuda0] * width], ("data", "model")))]
    if 1 < width <= torch.cuda.device_count():
        devs = [torch.device("cuda", i) for i in range(width)]
        out.append((f"1 x {width} on cuda:0-{width - 1}",
                     D.DeviceMesh([devs], ("data", "model"))))
    return out


def node_axis_phase(torch, np, mod, cfgs, all_launches):
    """The node axis at full width, through build_rz_sharded and
    build_notc_sharded: PAPER_PUT (256 puts, spots 90-110, N=1500, K=48,
    L=5) on meshes 1 x {1, 2, 4}, PAPER_NOTC (256 puts, N=40000, L=50) on
    1 x 4; each held to price_flat on the same rows (1e-9, equal
    max_pieces), with its launches counted from 0."""
    api, D, pay = mod("api"), mod("core.distributed"), mod("core.payoff")
    B, RS, R = mod("kernels.binomial_step"), mod("kernels.rz_step"), \
        mod("core.rz")
    put, notc = cfgs.PAPER_PUT, cfgs.PAPER_NOTC
    out = node_kernel_holds(torch, np, B, RS, R, D, put, notc)
    n = put.contracts
    s0 = np.linspace(90.0, 110.0, n)
    col = lambda x: np.full(n, float(x))

    def flat(cfg, **kw):
        return api.price_flat(s0=s0, sigma=cfg.sigma, rate=cfg.rate,
                              maturity=cfg.maturity, cost_rate=cfg.cost_rate,
                              payoff="put", strike=cfg.strike,
                              n_steps=cfg.n_steps, **kw)

    def profiled(label, fn):
        """Device time by kernel over one more run of ``fn``, on the
        widest mesh of cuda:0."""
        wall_p, n_k, kernels = profile_window(torch, fn)
        busy = sum(t for _, t in kernels)
        print(f"[profile] node axis {label}: {n_k} kernels, device busy "
              f"{busy * 1e3:.3f} ms of {wall_p * 1e3:.3f} ms under the "
              f"profiler (idle share {1.0 - busy / wall_p:.3f}); top "
              "kernels: " + ", ".join(f"{k[:60]} {t * 1e3:.3f} ms"
                                      for k, t in kernels[:4]), flush=True)
        return dict(wall_s=wall_p, device_busy_s=busy, kernels=n_k,
                    idle_share=1.0 - busy / wall_p,
                    top_kernels_s=[(k[:60], t) for k, t in kernels[:4]])

    ref = flat(put, capacity=put.capacity)
    for width in NODE_WIDTHS:
        plan = D.plan_rounds(put.n_steps, width, put.round_depth)
        for label, mesh in node_meshes(torch, D, width):
            f = D.build_rz_sharded(mesh, n_steps=put.n_steps,
                                   payoff=pay.american_put(put.strike),
                                   capacity=put.capacity,
                                   round_depth=put.round_depth)
            torch.cuda.reset_peak_memory_stats()
            zero_counts(all_launches)
            (ask, bid, pieces), s = wall(torch, lambda: f(
                s0, col(put.sigma), col(put.rate), col(put.maturity),
                col(put.cost_rate)))
            launches = {k: v for k, v in launch_counts(all_launches).items()
                        if v}
            peak = torch.cuda.max_memory_allocated() / 1e9
            d = max(float(np.abs(ask.numpy() - ref.ask).max()),
                    float(np.abs(bid.numpy() - ref.bid).max()))
            halo = width * n * 2 * plan["halo"] * (16 * put.capacity + 20)
            rec = dict(wall_s=s, launches=launches, plan=plan,
                       halo_bytes_a_round=halo, peak_device_gb=peak,
                       max_abs_vs_price_flat=d, max_pieces=pieces,
                       price_flat_max_pieces=ref.max_pieces)
            out[f"TC put {label}"] = rec
            print(f"[main] node axis TC put: {n} contracts N={put.n_steps} "
                  f"K={put.capacity} L={put.round_depth} mesh {label}: "
                  f"{s:.3f} s, {plan['rounds']} halo rounds + "
                  f"{plan['tail_levels']} tail levels, launches "
                  f"{json.dumps(launches)}, halo {halo} bytes a round, peak "
                  f"device memory {peak:.3f} GB; vs price_flat max |d| "
                  f"{d:.3e}, max_pieces {pieces} ({ref.max_pieces})",
                  flush=True)
            check(d <= TOL and pieces == ref.max_pieces,
                  f"node axis TC put {label}: max |d| {d}, max_pieces "
                  f"{pieces} vs {ref.max_pieces}")
            check(launches.get("rz_round", 0) > 0,
                  f"node axis TC put {label}: rz_round not launched")
            if width == NODE_WIDTHS[-1] and label.endswith("on cuda:0"):
                rec["profile"] = profiled(f"TC put {label}", lambda: f(
                    s0, col(put.sigma), col(put.rate), col(put.maturity),
                    col(put.cost_rate)))

    ref = flat(notc, levels=notc.round_depth, block=256)
    plan = D.plan_rounds(notc.n_steps - 1, NODE_NOTC_WIDTH, notc.round_depth)
    for label, mesh in node_meshes(torch, D, NODE_NOTC_WIDTH):
        f = D.build_notc_sharded(mesh, n_steps=notc.n_steps,
                                 strike=notc.strike, kind="put",
                                 round_depth=notc.round_depth)
        torch.cuda.reset_peak_memory_stats()
        zero_counts(all_launches)
        price, s = wall(torch, lambda: f(s0, col(notc.sigma), col(notc.rate),
                                         col(notc.maturity)))
        launches = {k: v for k, v in launch_counts(all_launches).items() if v}
        peak = torch.cuda.max_memory_allocated() / 1e9
        d = float(np.abs(price.numpy() - ref.ask).max())
        halo = NODE_NOTC_WIDTH * n * plan["halo"] * 8
        out[f"no-TC {label}"] = dict(wall_s=s, launches=launches, plan=plan,
                                     halo_bytes_a_round=halo,
                                     peak_device_gb=peak,
                                     max_abs_vs_price_flat=d)
        print(f"[main] node axis no-TC: {n} puts N={notc.n_steps} "
              f"L={notc.round_depth} mesh {label}: {s:.3f} s, "
              f"{plan['rounds']} halo rounds + {plan['tail_levels']} tail "
              f"levels, launches {json.dumps(launches)}, halo {halo} bytes "
              f"a round, peak device memory {peak:.3f} GB; vs price_flat "
              f"max |d| {d:.3e}", flush=True)
        check(d <= TOL and np.isfinite(price.numpy()).all(),
              f"node axis no-TC {label}: max |d| {d}")
        check(launches.get("lattice_round", 0) > 0,
              f"node axis no-TC {label}: lattice_round not launched")
        if label.endswith("on cuda:0"):
            out[f"no-TC {label}"]["profile"] = profiled(
                f"no-TC {label}", lambda: f(s0, col(notc.sigma),
                                            col(notc.rate),
                                            col(notc.maturity)))
    return out


# the float32 instances: the rows the plain rz version is held on at the
# widest round (it takes tens of seconds there whatever the rows)
RZ32_PLAIN_ROWS = 16
# flash_attention against its arithmetic mirror (a Python tile loop, so
# small shapes): (head_dim, T, S, causal, window) at B = 1, G = 4 query
# heads over one KV head: T = S = 150 (the last q and KV tiles ragged),
# and cross attention's T != S both ways, bidirectional
FLASH_MIRROR_CASES = tuple((hd, 150, 150, c, w) for hd in (64, 128, 256)
                           for c, w in ((True, None), (True, 40),
                                        (False, None))) + tuple(
    (hd, t, s, False, None) for hd in (64, 128)
    for t, s in ((100, 230), (230, 100)))


def same_or_both_nan(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def float32_kernel_phase(torch, np, B, RS, R, D, PW, contracts, tc_grid, notc,
                         put):
    """The float32 instances of the pricing kernels against their float32
    plain versions at the float64 lines' shapes: lattice_round_param on
    the no-TC grid's 256 rows (equal, NaN for NaN: at N=40000 the float32
    spot overflows at the far lanes and the 4-parameter payoff's 0 * inf
    is NaN, in the plain version and the TPU kernel alike), lattice_round
    on the single price's row and on a node-axis shard (lane0), rz_round
    at the widest put round (the kernel on 256 rows, the plain version on
    RZ32_PLAIN_ROWS of them) and on a node-axis shard, the functions'
    values at 81 holdings in [-4, 4] within the registry's float32
    tolerance (knot counts printed, not required: float32 ties may round
    the other way)."""
    dev, f32 = torch.device("cuda"), torch.float32
    out = {}
    block, levels = 256, notc.round_depth
    P = -(-(notc.n_steps + 1) // block) * block
    plan = D.plan_rounds(notc.n_steps - 1, NODE_NOTC_WIDTH, notc.round_depth)
    S, H = plan["shard_lanes"], plan["halo"]
    PS = -(-(S + H) // block) * block
    for label, kind, rows, p, lv, lane0 in (
            ("lattice_round_param", "param", 256, P, levels, 0),
            ("lattice_round", "put", 1, P, levels, 0),
            ("lattice_round lane0", "put", 256, PS, H, S)):
        x, sc = lattice_inputs(torch, dev, rows, p, float(notc.n_steps), kind,
                               f32)
        kw = {} if kind == "param" else {"kind": kind}
        fn = B.lattice_round_param if kind == "param" else B.lattice_round
        got = fn(x, sc, levels=lv, block=block, lane0=lane0, **kw)
        want, plain_ms = timed_once(torch, lambda: B.lattice_round_plain(
            x, sc, levels=lv, block=block, kind=kind, lane0=lane0))
        fin = torch.isfinite(got) & torch.isfinite(want)
        err = float((got - want)[fin].abs().max())
        nan = int(want.isnan().sum())
        check(same_or_both_nan(got, want),
              f"{label} float32: kernel differs from plain (max abs err "
              f"{err} on finite lanes)")
        ms = cuda_ms(torch, lambda: fn(x, sc, levels=lv, block=block,
                                       lane0=lane0, **kw), 20)
        bound, bound_by = lattice_bound(torch, x, sc, kind, lv)
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound, bound_by=bound_by, rows=rows, P=p,
                          levels=lv, block=block, lane0=lane0,
                          nan_lanes=nan)
        print(f"[kernel] {label} float32: rows={rows} P={p} levels={lv} "
              f"block={block} lane0={lane0} equal=True (NaN for NaN: {nan} "
              f"lanes) max_abs_err={err:.3e} ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} bound_ms={bound:.4f} ({bound_by}, float32 "
              f"at 67 TFLOP/s)", flush=True)

    tol = contracts["rz_round"].tolerance(f32)
    n = tc_grid.n_steps
    cases = (("rz_round", rz_state(torch, R, tc_grid, put.capacity, 256, n + 2,
                                   f32), 64, n + 2, {}),)
    plan = D.plan_rounds(put.n_steps, NODE_NOTC_WIDTH, put.round_depth)
    S, H = plan["shard_lanes"], plan["halo"]
    cases += (("rz_round lane0", node_rz_state(
        torch, R, put, np.linspace(90.0, 110.0, put.contracts), S + H, S, f32),
        H, S + H, dict(lane0=S, owned=S)),)
    for label, (z, sc), lv, blk, kw in cases:
        got, pieces = RS.rz_round(z, sc, levels=lv, block=blk, **kw)
        rows = RZ32_PLAIN_ROWS if label == "rz_round" else z.m.shape[0]
        zp = z.map(lambda a: a[:rows].contiguous())
        (want, wpieces), plain_ms = timed_once(torch, lambda: RS.rz_round_plain(
            zp, sc[:rows].contiguous(), levels=lv, block=blk, **kw))
        ys = torch.linspace(-4.0, 4.0, 81, dtype=f32, device=dev)
        vals = lambda f: PW._eval1(f, ys.expand(f.sl.shape + ys.shape))
        err = float((vals(got.map(lambda a: a[:rows])) - vals(want))
                    .abs().max())
        same_m = bool(torch.equal(got.m[:rows], want.m))
        same_p = bool(torch.equal(pieces[:rows], wpieces))
        check(err <= tol, f"{label} float32: values max abs err {err} > "
              f"{tol}")
        ms = cuda_ms(torch, lambda: RS.rz_round(z, sc, levels=lv, block=blk,
                                                **kw), 3)
        bound, bound_by, ops, nbytes = rz_bound(torch, z, got, sc, lv,
                                                put.capacity,
                                                lane0=kw.get("lane0", 0))
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          plain_rows=rows, bound_ms=bound, bound_by=bound_by,
                          rows=z.m.shape[0], lanes=blk, levels=lv,
                          equal_m=same_m, equal_pieces=same_p,
                          pieces=int(pieces.max()), K=put.capacity)
        print(f"[kernel] {label} float32: rows={z.m.shape[0]} N={put.n_steps} "
              f"lanes={blk} levels={lv} K={put.capacity} {kw} max_abs_err="
              f"{err:.3e} (values, <= {tol:g} on {rows} rows) equal_m={same_m} "
              f"equal_pieces={same_p} pieces={int(pieces.max())} ms={ms:.4f} "
              f"plain_ms={plain_ms:.3f} ({rows} rows) bound_ms={bound:.4f} "
              f"({bound_by}: {ops:.4e} float32 operations, {nbytes:.4e} "
              "bytes)", flush=True)
    return out


def flash_mirror_phase(torch, np, FL, contracts):
    """flash_attention against its arithmetic mirror at the float32
    contract's tolerance (the registry's 2e-6), at head_dim 64, 128 and
    256, causal, windowed and bidirectional, the last tiles ragged, and
    bidirectional with T != S both ways (cross attention); each
    line also gives the distance from the mirror whose MMAs round to
    nearest in two steps, and from the plain version (held to 2e-5 in
    the serve phases)."""
    tol = contracts["flash_attention"].tolerance(torch.float32)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for hd, T, S, causal, window in FLASH_MIRROR_CASES:
        q = torch.randn(1, T, 4, hd, generator=g, device=dev)
        k = torch.randn(1, S, 1, hd, generator=g, device=dev)
        v = torch.randn(1, S, 1, hd, generator=g, device=dev)
        kw = dict(causal=causal, window=window)
        got = FL.flash_attention(q, k, v, **kw)
        mirror = FL.flash_attention_mirror(q, k, v, **kw)
        nearest = FL.flash_attention_mirror(q, k, v, tensor_core=False, **kw)
        plain = FL.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        d = {name: float((got - ref).abs().max()) for name, ref in
             (("mirror", mirror), ("nearest", nearest), ("plain", plain))}
        label = f"hd{hd} {'causal' if causal else 'bidirectional'}" + (
            f" window {window}" if window else "") + (
            f" T={T} S={S}" if T != S else "")
        out[label] = d
        print(f"[kernel] flash_attention mirror {label}: q (1, {T}, 4, {hd}) "
              f"k,v (1, {S}, 1, {hd}) max_abs_err vs mirror {d['mirror']:.3e} (<= {tol:g}), vs "
              f"round-to-nearest mirror {d['nearest']:.3e}, vs plain "
              f"{d['plain']:.3e}", flush=True)
        check(d["mirror"] <= tol, f"flash_attention {label}: kernel vs mirror "
              f"{d['mirror']} > {tol}")
    return out


def flash_bf16_phase(torch, np, FL):
    """flash_attention's bfloat16 instance against its plain version (at
    ``BF16_PLAIN_TOL``, JAX's own bfloat16 kernel-test bound) and against
    its mirror (elementwise within ``mirror_bound_bf16``: one bfloat16
    ulp of the output plus the mirror's slack), at head_dim 64, 128 and
    256, causal, windowed (40, 160, 300 and 2048 keys: see
    ``FLASH_BF16_CASES`` for which leave tiles wholly inside the window)
    and bidirectional, the last tiles ragged, T != S both ways, S shorter
    than a KV tile, two batch rows; each line counts the elements that
    differ from the mirror."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for hd, B, T, S, causal, window in FLASH_BF16_CASES:
        mk = lambda *s_: torch.randn(*s_, generator=g, device=dev).to(
            torch.bfloat16)
        q, k, v = mk(B, T, 4, hd), mk(B, S, 2, hd), mk(B, S, 2, hd)
        kw = dict(causal=causal, window=window)
        got = FL.flash_attention(q, k, v, **kw)
        mirror, slack = FL.flash_attention_mirror(q, k, v, with_slack=True,
                                                  **kw)
        plain = FL.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        d = (got.float() - mirror.float()).abs()
        of_bound = float((d / FL.mirror_bound_bf16(got, mirror, slack)).max())
        dp = float((got.float() - plain.float()).abs().max())
        label = f"hd{hd} {'causal' if causal else 'bidirectional'}" + (
            f" window {window}" if window else "") + (
            f" T={T} S={S}" if T != S else f" T={T}") + (
            f" B={B}" if B > 1 else "")
        out[label] = dict(vs_mirror=float(d.max()), differing=int(
            (d > 0).sum()), elements=d.numel(), of_bound=of_bound,
            vs_plain=dp)
        print(f"[kernel] flash_attention bfloat16 mirror {label}: q ({B}, "
              f"{T}, 4, {hd}) k,v ({B}, {S}, 2, {hd}) vs mirror max "
              f"{d.max():.3e}, "
              f"{int((d > 0).sum())} of {d.numel()} elements differ, "
              f"{of_bound:.3f} of the bound; vs plain {dp:.3e} (<= "
              f"{FL.BF16_PLAIN_TOL:g})", flush=True)
        check(of_bound <= 1.0, f"flash_attention bfloat16 {label}: kernel vs "
              f"mirror beyond its bound ({of_bound:.3f})")
        check(dp <= FL.BF16_PLAIN_TOL, f"flash_attention bfloat16 {label}: "
              f"kernel vs plain {dp}")
    return out


def bf16_prefill_phase(torch, np, mod, all_launches):
    """``BF16_PREFILLS``: each arch at its published width and depth,
    weights stored in bfloat16, through one ``prefill`` with
    ``RunCfg(impl="flash")`` at bfloat16 (the default dtype), its
    bfloat16 flash launches counted from 0; then each kind of attention
    call it made held by ``flash_hold`` on that call's inputs.  Returns
    ``{arch: (records by kind, launches, calls by kind)}``."""
    T_, cfgs, ops = mod("models.transformer"), mod("configs"), \
        mod("kernels.ops")
    FL = mod("kernels.flash_attention")
    bf = torch.bfloat16
    dev = torch.device("cuda")
    labels = {"flash_attention": "self", "flash_attention.bidirectional":
              "encoder", "flash_attention.cross": "cross"}
    out = {}
    for arch, batch, prompt_len, frames in BF16_PREFILLS:
        torch.cuda.empty_cache()
        cfg = cfgs.get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        model = T_.init_lm(cfg, gen, device=dev, dtype=bf)
        feed = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len),
                                        generator=gen, device=dev)}
        if frames:
            feed["enc_embeds"] = torch.randn(batch, frames, cfg.d_model,
                                             generator=gen, device=dev)
        run = T_.RunCfg(impl="flash", dtype=bf)
        zero_counts(all_launches)
        ((logits, _), seen, calls), pre_s = wall(
            torch, lambda: capture_kernel_inputs(ops, lambda: T_.prefill(
                model, feed, cfg, run)))
        n = FL.LAUNCHES["flash_attention.bfloat16"]
        kinds = [cfg.block_kind(i) for i in range(cfg.n_layers)] + [
            cfg.block_kind(i) for i in range(cfg.n_encoder_layers)]
        want = sum(k in ("attn", "local") for k in kinds) + (
            cfg.n_layers if cfg.n_encoder_layers else 0)
        finite = bool(torch.isfinite(logits).all())
        print(f"[main] {arch} prefill bfloat16 ({cfg.n_layers} layers"
              + (f" + {cfg.n_encoder_layers} encoder layers, {frames} "
                 f"frames" if frames else "") + f", weights bfloat16): "
              f"batch {batch}, prompt {prompt_len} in {pre_s:.3f} s; "
              f"logits {tuple(logits.shape)} finite {finite}; bfloat16 "
              f"flash launches {n} (want {want}) by kind {json.dumps(calls)}",
              flush=True)
        check(finite and tuple(logits.shape) == (batch, cfg.vocab),
              f"{arch} bfloat16 prefill logits")
        check(n == want == sum(c for k, c in calls.items()
                               if k.startswith("flash")),
              f"{arch} bfloat16 prefill "
              f"launches {n}, calls {calls}, want {want}")
        del model, logits, feed
        torch.cuda.empty_cache()
        recs = {kind: flash_hold(torch, np, FL, seen,
                                 f"{arch} bfloat16 {labels[kind]} ", kind)
                for kind in list(seen) if kind in labels}
        out[arch] = (recs, n, calls)
        del seen
    return out


def bf16_serve_phase(torch, np, mod, all_launches, f32_qwen3):
    """The bfloat16 serves (``BF16_SERVES``): each arch at its published
    width and depth, weights stored in bfloat16, through ``lm_phase`` with
    its causal flash_attention held on its prefill's inputs (bfloat16
    instance); qwen3-4b's last logits and greedy tokens beside its float32
    serve's on the same draws (reported, not gated)."""
    FL = mod("kernels.flash_attention")
    out = {}
    for arch, b, p, n in BF16_SERVES:
        out[arch] = lm_phase(
            torch, np, mod, all_launches, arch, b, p, n,
            lambda seen, arch=arch: {"flash_attention": flash_hold(
                torch, np, FL, seen, arch + " bfloat16 ")},
            dtype=torch.bfloat16)
        rec, kern = out[arch][2], out[arch][0]["flash_attention"]
        was_s, was_ms = BF16_MMA_SYNC[arch]
        rec["recorded_mma_sync_design"] = dict(prefill_s=was_s,
                                               kernel_ms=was_ms)
        print(f"[main] {arch} bfloat16 prefill {rec['prefill_s']:.3f} s, "
              f"flash_attention {kern['ms']:.4f} ms a launch (this run); "
              f"recorded with the kernel's earlier mma.sync design, not "
              f"measured here: {was_s:.3f} s, {was_ms:.4f} ms (NVIDIA H100 "
              f"80GB HBM3, 700 W)", flush=True)
    rec = out["qwen3-4b"][2]
    d = float((rec["last_logits"] - f32_qwen3["last_logits"]).abs().max())
    same = np.array(rec["tokens"]) == np.array(f32_qwen3["tokens"])
    rec["vs_float32"] = dict(max_abs_last_logits=d,
                             tokens_agreeing=int(same.sum()),
                             tokens=same.size,
                             leading_tokens_agreeing=[
                                 int(np.cumprod(row).sum()) for row in same])
    print(f"[main] qwen3-4b bfloat16 vs float32 serve (same draws): max |d| "
          f"last prefill logits {d:.3e} (max |logit| "
          f"{float(f32_qwen3['last_logits'].abs().max()):.3f}); greedy "
          f"tokens agreeing {int(same.sum())} of {same.size}, leading run "
          f"a sequence {rec['vs_float32']['leading_tokens_agreeing']}",
          flush=True)
    return out


def float32_main_phase(torch, np, mod, cfgs, ops, R, tc_grid, tc,
                       notc_price, pricing_launches):
    """The float32 main paths, each with its launches counted from 0:
    PAPER_NOTC's put through price_notc_kernel at the policy's default
    (float32 on the card), the TC grid's 256 PAPER_PUT rows through
    rz_backward_kernel(dtype=float32) at K=48 (and, where they overflow,
    at the smallest capacity of 64 and 128 that holds), and the node axis
    in float32, each mesh held bit for bit to its 1 x 1 run."""
    f32 = torch.float32
    D, pay, api = mod("core.distributed"), mod("core.payoff"), mod("api")
    notc, put = cfgs.PAPER_NOTC, cfgs.PAPER_PUT
    out = {}
    model = mod("core.lattice").LatticeModel(
        s0=notc.s0, sigma=notc.sigma, rate=notc.rate, maturity=notc.maturity,
        n_steps=notc.n_steps)
    zero_counts(pricing_launches)
    p32, s32 = wall(torch, lambda: ops.price_notc_kernel(
        model, notc.strike, levels=notc.round_depth))
    launches = {k: v for k, v in launch_counts(pricing_launches).items() if v}
    call32 = ops.price_notc_kernel(model, notc.strike, kind="call",
                                   levels=notc.round_depth)
    out["price_notc_kernel"] = dict(price=p32, price_float64=notc_price,
                                    diff=p32 - notc_price, wall_s=s32,
                                    launches=launches, call=call32)
    print(f"[main] price_notc_kernel float32 N={notc.n_steps}: {p32:.10f} in "
          f"{s32:.3f} s, launches {json.dumps(launches)}; float64 "
          f"{notc_price:.10f}, float32 - float64 = {p32 - notc_price:.3e}; "
          f"the call in float32: {call32} (spots past 3.4e38 are inf)",
          flush=True)
    check(np.isfinite(p32) and launches.get("lattice_round.float32", 0) > 0
          and not launches.get("lattice_round"),
          "price_notc_kernel float32: not through lattice_round's float32 "
          "instance")

    f = tc_grid.flat()
    dev = torch.device("cuda")
    col = lambda a: torch.as_tensor(np.ravel(a), dtype=f32, device=dev)
    alpha, zeta, w1, w2 = f.payoff_param_arrays()
    args = [col(a) for a in (f.s0, f.sigma, f.rate, f.maturity, f.cost_rate)]
    payv = [col(a) for a in (alpha, zeta, w1, w2, f.strike, f.strike2)]
    for K in (put.capacity, 64, 128):
        zero_counts(pricing_launches)
        (ask, bid, pc), s = wall(torch, lambda: R.rz_backward_kernel(
            *args, payv, n_steps=tc_grid.n_steps, capacity=K, dtype=f32))
        launches = {k: v for k, v in launch_counts(pricing_launches).items()
                    if v}
        top = int(pc.max())
        d = max(float(np.abs(ask.double().cpu().numpy() - tc.ask.ravel()).max()),
                float(np.abs(bid.double().cpu().numpy() - tc.bid.ravel()).max()))
        fits = top <= K
        out[f"TC put K={K}"] = dict(wall_s=s, launches=launches,
                                    max_pieces=top, fits=fits,
                                    max_abs_vs_float64=d)
        print(f"[main] float32 TC put: {tc_grid.n_scenarios} contracts "
              f"N={tc_grid.n_steps} K={K}: {s:.3f} s, launches "
              f"{json.dumps(launches)}, max_pieces={top}, max |ask, bid - "
              f"float64 grid| {d:.3e}" + ("" if fits else
                                         f": OverflowError (needed {top} > "
                                         f"K={K}; the values are truncated "
                                         "records, not prices)"), flush=True)
        check(launches.get("rz_round.float32", 0) > 0
              and not launches.get("rz_round"),
              "float32 TC put: not through rz_round's float32 instance")
        if fits:
            check(np.isfinite(d) and d <= RZ32_PRICE_TOL,
                  f"float32 TC put: {d} from the float64 grid")
            break

    s0 = np.linspace(90.0, 110.0, put.contracts)
    cnst = lambda x: np.full(put.contracts, float(x))
    ref = api.price_flat(s0=s0, sigma=put.sigma, rate=put.rate,
                         maturity=put.maturity, cost_rate=put.cost_rate,
                         payoff="put", strike=put.strike, n_steps=put.n_steps,
                         capacity=put.capacity)
    ref_nt = api.price_flat(s0=s0, sigma=notc.sigma, rate=notc.rate,
                            maturity=notc.maturity, cost_rate=0.0,
                            payoff="put", strike=notc.strike,
                            n_steps=notc.n_steps, levels=notc.round_depth,
                            block=256)
    cuda0 = torch.device("cuda", 0)
    for engine in ("TC put", "no-TC"):
        first = None
        for width in (1, NODE_NOTC_WIDTH):
            mesh = D.DeviceMesh([[cuda0] * width], ("data", "model"))
            if engine == "TC put":
                fn = D.build_rz_sharded(mesh, n_steps=put.n_steps,
                                        payoff=pay.american_put(put.strike),
                                        capacity=put.capacity,
                                        round_depth=put.round_depth,
                                        dtype=f32)
                run = lambda: fn(s0, cnst(put.sigma), cnst(put.rate),
                                 cnst(put.maturity), cnst(put.cost_rate))[:2]
                want = (ref.ask, ref.bid)
            else:
                fn = D.build_notc_sharded(mesh, n_steps=notc.n_steps,
                                          strike=notc.strike, kind="put",
                                          round_depth=notc.round_depth,
                                          dtype=f32)
                run = lambda: (fn(s0, cnst(notc.sigma), cnst(notc.rate),
                                  cnst(notc.maturity)),)
                want = (ref_nt.ask,)
            zero_counts(pricing_launches)
            res, s = wall(torch, run)
            launches = {k: v for k, v in launch_counts(pricing_launches).items()
                        if v}
            same = first is None or all(torch.equal(a, b)
                                        for a, b in zip(res, first))
            first = res if first is None else first
            d = max(float(np.abs(a.double().numpy() - w).max())
                    for a, w in zip(res, want))
            out[f"node axis {engine} 1 x {width}"] = dict(
                wall_s=s, launches=launches, equal_to_1x1=same,
                max_abs_vs_float64=d)
            print(f"[main] node axis float32 {engine}: mesh 1 x {width} on "
                  f"cuda:0: {s:.3f} s, launches {json.dumps(launches)}, "
                  f"bit-equal to 1 x 1 {same}; vs float64 price_flat max |d| "
                  f"{d:.3e}", flush=True)
            check(same, f"node axis float32 {engine} 1 x {width} differs "
                  "from 1 x 1")
            check(any(k.endswith(".float32") for k in launches)
                  and not any(k in launches for k in ("rz_round",
                                                      "lattice_round")),
                  f"node axis float32 {engine}: not through the float32 "
                  "instances")
    return out


def launcher_phase():
    """The launcher a user runs, as a subprocess on the card: grid mode
    with the LSMC engine and four shards (simulated on one card); then
    the non-grid mode on the node axis, 1 x 4 (cuda:0 repeated on a
    one-card machine)."""
    out = {}
    for key, cmd, mesh_prefix, rows_with in (
            ("grid lsmc", ["--grid", "--engine", "lsmc", "--devices", "4",
                           "--n-steps", "50", "--paths", "16384",
                           "--exercise-dates", "10,20,30,40,50",
                           "--n-assets", "3", "--s0", "90,100,110",
                           "--lambdas", "0,0.01"],
             ("[simulated mesh", "[device mesh"), ("se=", 6)),
            ("node axis", ["--n-steps", "1500", "--contracts", "8",
                           "--model", "4", "--round-depth", "5"],
             ("[mesh: 1 x 4 on cuda",), ("bid=", 8))):
        cmd = [sys.executable, "-m", "repro_torch.launch.price"] + cmd
        t = time.perf_counter()
        r = run_alone(cmd)
        s = time.perf_counter() - t
        lines = r.stdout.strip().splitlines()
        mesh = [ln for ln in lines if ln.startswith(mesh_prefix)]
        knots = [ln for ln in lines if ln.startswith("max PWL knots")]
        print(f"[main] launcher: {' '.join(cmd[1:])}: exit {r.returncode} in "
              f"{s:.1f} s (process start, import and run); "
              f"{mesh[0] if mesh else 'no mesh line'}; "
              f"{(knots[0] + '; ') if knots else ''}"
              f"{lines[-1] if lines else ''}", flush=True)
        check(r.returncode == 0, f"launcher exit {r.returncode}: "
              f"{r.stderr[-2000:]}")
        check(len(mesh) == 1 and sum(rows_with[0] in ln for ln in lines)
              == rows_with[1], f"launcher {key} output: one mesh line and "
              f"{rows_with[1]} rows with {rows_with[0]}")
        out[key] = dict(returncode=r.returncode, wall_s=s, mesh_line=mesh[0])
    return out


# the pricing service: PricingService(max_batch=256, deadline_ms=5,
# capacity=48) and the gateway on a 2048-request trace of the shape of
# launch/serve_pricing.py::synth_trace at the paper's depths
SERVE_MAX_BATCH, SERVE_DEADLINE_MS, SERVE_SEED = 256, 5.0, 0
SERVE_MIX = (("notc", 1536), ("notc_deep", 256), ("tc_put", 256))
# the streaming book: 8 underlyings x 24 rows at PAPER_PUT's N=1500 and
# K=48; the cost rates cycle with the payoff families, so the cost rows
# are the puts (cost calls and bull spreads outgrow any capacity with N:
# a N=120 cost call needed 142 knots after a tick) and the calls and
# bull spreads are friction-free
BOOK_UNDERLYINGS, BOOK_ROWS, BOOK_COSTS, BOOK_TICKS = 8, 24, (0.01, 0.0,
                                                              0.0), 64


def service_trace(np, PriceRequest, cfgs):
    """2048 single-contract requests, shuffled from a seed: spots 90-110
    in 9 steps, sigma {0.15, 0.2, 0.3}, rate 0.1, maturity {0.25, 0.5},
    strikes {95, 100, 105}; 1536 friction-free put/call/bull-spread
    requests at PAPER_PUT's N=1500, 256 friction-free puts at
    PAPER_NOTC's N=40000 and 256 transaction-cost puts at PAPER_PUT
    (N=1500, cost {0.005, 0.01}).  Cost calls and bull spreads overflow
    K=48 at N=1500 (ROADMAP Queue C), so the cost requests are puts."""
    rng = np.random.default_rng(SERVE_SEED)
    n_put, n_notc = cfgs.PAPER_PUT.n_steps, cfgs.PAPER_NOTC.n_steps
    reqs = []
    for kind, count in SERVE_MIX:
        for _ in range(count):
            reqs.append(PriceRequest(
                s0=float(rng.choice(np.linspace(90.0, 110.0, 9))),
                sigma=float(rng.choice((0.15, 0.2, 0.3))), rate=0.1,
                maturity=float(rng.choice((0.25, 0.5))),
                cost_rate=(float(rng.choice((0.005, 0.01)))
                           if kind == "tc_put" else 0.0),
                payoff=(str(rng.choice(("put", "call", "bull_spread")))
                        if kind == "notc" else "put"),
                strike=float(rng.choice((95.0, 100.0, 105.0))),
                n_steps=n_notc if kind == "notc_deep" else n_put))
    return [reqs[i] for i in rng.permutation(len(reqs))]


def quotes_in_order(quotes):
    """{rid: quote} as a list in submission order (rids count up)."""
    return [quotes[rid] for rid in sorted(quotes)]


def same_quotes(a, b):
    return all(x.ask == y.ask and x.bid == y.bid
               and x.max_pieces == y.max_pieces for x, y in zip(a, b)) \
        and len(a) == len(b)


def card_memory_by_pid(pids):
    """MiB each process holds on the card, CUDA context included, as
    nvidia-smi lists compute processes (None where it does not)."""
    try:
        r = subprocess.run(["nvidia-smi",
                            "--query-compute-apps=pid,used_memory",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return {pid: None for pid in pids}
    used = {}
    for line in r.stdout.strip().splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            used[int(parts[0])] = parts[1]
    return {pid: used.get(pid) for pid in pids}


def serving_phase(torch, np, mod, cfgs, all_launches):
    """The pricing service, the gateway (thread and process replicas) and
    the streaming book on the card, each held to the service's quotes or
    to price_flat; returns the summary."""
    api = mod("api")
    PriceRequest = mod("serve.engine").PriceRequest
    PricingService = mod("serve.scheduler").PricingService
    sp = mod("launch.serve_pricing")
    capacity = cfgs.PAPER_PUT.capacity
    trace = service_trace(np, PriceRequest, cfgs)
    check(len(trace) == 2048, "service trace size")
    out = {}

    def service():
        return PricingService(max_batch=SERVE_MAX_BATCH,
                              deadline_ms=SERVE_DEADLINE_MS,
                              capacity=capacity)

    # 1. as fast as it goes, counting the launches of this run only
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(all_launches)
    svc = service()
    t = time.perf_counter()
    quotes = quotes_in_order(sp.drive(svc, trace, qps=0))
    torch.cuda.synchronize()
    s = time.perf_counter() - t
    launches = launch_counts(all_launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    m = svc.metrics()
    rate = len(trace) / s
    out["service"] = dict(
        requests=len(trace), wall_s=s, requests_per_s=rate,
        batches=m["batches"], engine_batches=m["engine_batches"],
        pad_waste=m["pad_waste"], cache_hits=m["cache_hits"],
        compile_misses=m["compile_misses"], engine_s=m["engine_seconds"],
        p50_ms=m["p50_latency_ms"], p99_ms=m["p99_latency_ms"],
        launches=launches, peak_device_gb=peak)
    print(f"[main] pricing service: {len(trace)} requests (1536 no-TC "
          f"N={cfgs.PAPER_PUT.n_steps}, 256 no-TC N={cfgs.PAPER_NOTC.n_steps}"
          f", 256 TC puts N={cfgs.PAPER_PUT.n_steps} K={capacity}), max "
          f"batch {SERVE_MAX_BATCH}, deadline {SERVE_DEADLINE_MS:g} ms, qps "
          f"0: {s:.3f} s, {rate:.1f} requests/s, {m['batches']} batches "
          f"{json.dumps(m['engine_batches'])}, pad waste "
          f"{m['pad_waste']:.4f}, result-cache hits {m['cache_hits']}, "
          f"launch shapes {m['compile_misses']}, engine "
          f"{m['engine_seconds']:.3f} s, p50/p99 {m['p50_latency_ms']:.2f} / "
          f"{m['p99_latency_ms']:.2f} ms, kernel launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}, peak "
          f"device memory {peak:.3f} GB", flush=True)
    check(m["completed"] == len(trace) and all(q is not None for q in quotes),
          "service delivered every quote")
    for name in ("lattice_round_param", "rz_round"):
        check(launches[name] > 0, f"{name} was not launched by the service")
    # 2. the same trace at half the measured rate
    svc2 = service()
    half = rate / 2.0
    t = time.perf_counter()
    quotes2 = quotes_in_order(sp.drive(svc2, trace, qps=half))
    s2 = time.perf_counter() - t
    m2 = svc2.metrics()
    out["service_half_rate"] = dict(
        qps=half, wall_s=s2, batches=m2["batches"],
        p50_ms=m2["p50_latency_ms"], p99_ms=m2["p99_latency_ms"])
    print(f"[main] pricing service at half that rate ({half:.1f} qps): "
          f"{s2:.3f} s, {m2['batches']} batches, p50/p99 "
          f"{m2['p50_latency_ms']:.2f} / {m2['p99_latency_ms']:.2f} ms",
          flush=True)
    check(same_quotes(quotes, quotes2), "service quotes at half rate")
    # the trace repeats contracts, so the LRU answers about half of it;
    # the same qps-0 run with the LRU off sends every request to an engine
    svc3 = PricingService(max_batch=SERVE_MAX_BATCH,
                          deadline_ms=SERVE_DEADLINE_MS, capacity=capacity,
                          result_cache_size=0)
    t = time.perf_counter()
    quotes3 = quotes_in_order(sp.drive(svc3, trace, qps=0))
    torch.cuda.synchronize()
    s3 = time.perf_counter() - t
    m3 = svc3.metrics()
    out["service_no_cache"] = dict(
        wall_s=s3, requests_per_s=len(trace) / s3, batches=m3["batches"],
        engine_batches=m3["engine_batches"], pad_waste=m3["pad_waste"],
        cache_hits=m3["cache_hits"], engine_s=m3["engine_seconds"],
        p50_ms=m3["p50_latency_ms"], p99_ms=m3["p99_latency_ms"])
    print(f"[main] pricing service, result cache off, qps 0: {s3:.3f} s, "
          f"{len(trace) / s3:.1f} requests/s, {m3['batches']} batches "
          f"{json.dumps(m3['engine_batches'])}, pad waste "
          f"{m3['pad_waste']:.4f}, result-cache hits {m3['cache_hits']}, "
          f"engine {m3['engine_seconds']:.3f} s, p50/p99 "
          f"{m3['p50_latency_ms']:.2f} / {m3['p99_latency_ms']:.2f} ms",
          flush=True)
    check(m3["cache_hits"] == 0 and same_quotes(quotes, quotes3),
          "service quotes with the result cache off")
    # where the time goes: the qps-0 run again under the profiler
    wall_p, n_k, kernels = profile_window(
        torch, lambda: sp.drive(service(), trace, qps=0))
    busy = sum(t for _, t in kernels)
    out["service_profile"] = dict(
        wall_s=wall_p, device_busy_s=busy, idle_share=1.0 - busy / wall_p,
        kernels=n_k, top_kernels_s=[(k[:60], t) for k, t in kernels[:4]])
    print(f"[profile] pricing service qps 0: {n_k} kernels, device busy "
          f"{busy * 1e3:.3f} ms of {wall_p * 1e3:.3f} ms under the profiler "
          f"(idle share {1.0 - busy / wall_p:.3f}); top kernels: "
          + ", ".join(f"{k[:60]} {t * 1e3:.3f} ms" for k, t in kernels[:4]),
          flush=True)

    # every quote against its bucket priced in one price_flat call
    buckets = {}
    for i, r in enumerate(trace):
        buckets.setdefault((r.n_steps, r.cost_rate > 0), []).append(i)
    d, pieces_equal = 0.0, True
    for (n_steps, _), idx in sorted(buckets.items()):
        col = lambda f: np.array([getattr(trace[i], f) for i in idx])
        want = api.price_flat(
            s0=col("s0"), sigma=col("sigma"), rate=col("rate"),
            maturity=col("maturity"), cost_rate=col("cost_rate"),
            payoff=tuple(col("payoff")), strike=col("strike"),
            n_steps=n_steps, capacity=capacity)
        got = [quotes[i] for i in idx]
        d = max(d, float(np.abs(np.array([q.ask for q in got])
                                - want.ask).max()),
                float(np.abs(np.array([q.bid for q in got])
                             - want.bid).max()))
        pieces_equal &= [q.max_pieces for q in got] == \
            want.row_pieces.astype(int).tolist()
    out["vs_price_flat"] = dict(max_abs=d, row_pieces_equal=pieces_equal)
    print(f"[check] service vs price_flat: {len(trace)} quotes against "
          f"{len(buckets)} buckets each priced in one price_flat call: max "
          f"|d| ask/bid {d:.3e} (limit {TOL:g}), equal row_pieces "
          f"{pieces_equal}", flush=True)
    check(d <= TOL and pieces_equal, "service vs price_flat")

    # the gateway: two thread replicas on cuda:0 through the launcher's
    # drive_gateway, then two processes with a real SIGKILL of replica 0
    # at its first chunk, built here so the workers' memory is read
    # before the gateway closes them
    import asyncio
    gw_mod, rep_mod = mod("serve.gateway"), mod("serve.replica")
    pp = mod("serve.procpool")

    def process_gateway():
        wu = pp.warmup_chunk(n_steps=cfgs.PAPER_PUT.n_steps,
                             backend="kernel", capacity=capacity)
        rp = pp.ReplicaPool("process", device="cuda", warmup=wu)
        workers = [pp.ProcessReplica("replica-0", device="cuda", warmup=wu,
                                     faults={0: "sigkill"}), rp.factory(1)]

        def respawn(i):
            workers.append(rp.factory(i))
            return workers[-1]

        async def run():
            async with gw_mod.PricingGateway(
                    replicas=list(workers), max_batch=SERVE_MAX_BATCH,
                    deadline_ms=SERVE_DEADLINE_MS, capacity=capacity,
                    default_n_steps=cfgs.PAPER_PUT.n_steps, restart_s=1.0,
                    replica_factory=respawn) as gw:
                rids = [await gw.submit(r) for r in trace]
                got = {rid: await gw.result(rid) for rid in rids}
                mem = {w.name: dict(w.memory(), warmup_s=w.warmup_seconds)
                       for w in workers if w.alive}
                return got, gw.metrics(), mem

        got, gm, mem = asyncio.run(run())
        used = card_memory_by_pid([v["pid"] for v in mem.values()])
        for v in mem.values():
            v["nvidia_smi_mib"] = used[v["pid"]]
        return got, gm, mem

    for kind in ("thread", "process"):
        t = time.perf_counter()
        if kind == "thread":
            got, gm = sp.drive_gateway(
                trace, replicas=2, crash_at=None, max_batch=SERVE_MAX_BATCH,
                deadline_ms=SERVE_DEADLINE_MS, capacity=capacity,
                backend="kernel", n_steps=cfgs.PAPER_PUT.n_steps,
                pool_kind="thread", device="cuda")
            mem = None
        else:
            got, gm, mem = process_gateway()
        s = time.perf_counter() - t
        got = quotes_in_order(got)
        equal = same_quotes(got, quotes)
        out[f"gateway_{kind}"] = dict(
            wall_s=s, requests_per_s=len(trace) / s,
            p50_ms=gm["p50_latency_ms"], p99_ms=gm["p99_latency_ms"],
            batches=gm["batches"], healthy=gm["healthy_replicas"],
            crashes=gm["replica_crashes"], requeues=gm["requeues"],
            restarts=gm["replica_restarts"], completed=gm["completed"],
            failed=gm["failed"], equal_to_service=equal, worker_memory=mem)
        line = (f"[main] pricing gateway, 2 {kind} replicas on cuda:0: "
                f"{len(trace)} requests in {s:.3f} s (process start and "
                f"warm-up included), {len(trace) / s:.1f} requests/s, "
                f"{gm['batches']} batches, p50/p99 {gm['p50_latency_ms']:.2f}"
                f" / {gm['p99_latency_ms']:.2f} ms, healthy replicas "
                f"{gm['healthy_replicas']}, crashes={gm['replica_crashes']} "
                f"requeues={gm['requeues']} restarts="
                f"{gm['replica_restarts']}, delivered {gm['completed']}/"
                f"{len(trace)}, equal to the service's quotes {equal}")
        if mem is not None:
            line += ("; workers (warm-up s in the worker; device memory "
                     "peak allocated / reserved MB; nvidia-smi MiB with the "
                     "CUDA context): " + ", ".join(
                         f"{k} pid {v['pid']}: {v['warmup_s']:.2f} s, "
                         f"{v['peak_allocated'] / 1e6:.1f} / "
                         f"{v['reserved'] / 1e6:.1f} MB, "
                         f"{v['nvidia_smi_mib'] or 'not listed'}"
                         for k, v in mem.items()))
        print(line, flush=True)
        check(gm["completed"] == len(trace) and gm["failed"] == 0 and equal,
              f"gateway ({kind}) delivered every quote, equal")
        if kind == "process":
            check(gm["replica_crashes"] == 1 and gm["requeues"] >= 1,
                  "gateway process pool recovered one SIGKILL")

    # the streaming book through the gateway's run_stream
    st = mod("serve.streaming")
    book = st.StreamingBook.mixed(
        n_underlyings=BOOK_UNDERLYINGS, per_underlying=BOOK_ROWS,
        n_steps=(cfgs.PAPER_PUT.n_steps,), cost_rates=BOOK_COSTS,
        capacity=capacity)
    check(set(book.payoff[book.cost_rate > 0]) == {"put"},
          "the book's cost rows are puts")
    book.full_reprice()
    ticks = st.synth_ticks(BOOK_TICKS, n_underlyings=BOOK_UNDERLYINGS,
                           seed=SERVE_SEED)

    async def stream():
        async with gw_mod.PricingGateway(
                replicas=[rep_mod.LocalReplica(f"r{i}", device="cuda:0")
                          for i in range(2)],
                max_batch=SERVE_MAX_BATCH, deadline_ms=SERVE_DEADLINE_MS,
                capacity=capacity) as gw:
            return await gw.run_stream(book, ticks)

    t = time.perf_counter()
    summary = asyncio.run(stream())
    s = time.perf_counter() - t
    ref = book.copy()
    ref.full_reprice()
    d = max(float(np.abs(book.ask - ref.ask).max()),
            float(np.abs(book.bid - ref.bid).max()))
    same = bool(np.array_equal(book.row_pieces, ref.row_pieces))
    out["streaming"] = dict(rows=book.n_rows, wall_s=s,
                            ticks_per_s=summary["ticks"] / s,
                            vs_full_reprice_max_abs=d,
                            row_pieces_equal=same, **summary)
    print(f"[main] streaming book: {book.n_rows} rows ({BOOK_UNDERLYINGS} "
          f"underlyings; cost puts, friction-free calls and bull spreads; "
          f"N={cfgs.PAPER_PUT.n_steps}, K={capacity}), {summary['ticks']}"
          f" ticks in {s:.3f} s, {summary['ticks'] / s:.2f} ticks/s, "
          f"{summary['rows_requoted']} rows requoted, staleness p50/p99 "
          f"{summary['staleness_p50_ms']:.2f} / "
          f"{summary['staleness_p99_ms']:.2f} ms; incremental vs full "
          f"reprice max |d| {d:.3e}, equal row_pieces {same}", flush=True)
    check(d <= TOL and same and book.max_pieces <= capacity,
          "streaming book vs full reprice")
    return out


def serve_launcher_phase():
    """``python -m repro_torch.launch.serve_pricing`` as a user runs it:
    the service at N=1500, then the gateway with two process replicas
    and a real SIGKILL of replica 0 at its first chunk."""
    base = [sys.executable, "-m", "repro_torch.launch.serve_pricing",
            "--n-steps", "1500", "--max-batch", "256", "--qps", "0"]
    out = []
    for extra in (["--requests", "1024"],
                  ["--gateway", "--pool", "process", "--replicas", "2",
                   "--crash-at", "0", "--requests", "256"]):
        cmd = base + extra
        t = time.perf_counter()
        r = run_alone(cmd)
        s = time.perf_counter() - t
        lines = r.stdout.strip().splitlines()
        keep = [ln.strip() for ln in lines
                if "requests/s" in ln or "failover" in ln]
        print(f"[main] serve launcher: {' '.join(cmd[1:])}: exit "
              f"{r.returncode} in {s:.1f} s; " + "; ".join(keep), flush=True)
        check(r.returncode == 0, f"serve launcher exit {r.returncode}: "
              f"{r.stderr[-2000:]}")
        if "--crash-at" in extra:
            check(any("crashes=1" in ln for ln in lines),
                  "serve launcher: one crash recovered")
        out.append(dict(cmd=cmd[1:], returncode=r.returncode, wall_s=s,
                        lines=keep))
    return out


# training: the full-width step's shape (batch 2 x 1024 tokens,
# remat full, one microbatch, AdamW's defaults, 3 timed steps after one
# warm-up), the reduced arch held card vs CPU, and the launchers'
# restart.  A step's gradients against the CPU's: float32 sums in other
# orders on two devices.
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "recurrentgemma-2b", 2, \
    1024, 3
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
# bfloat16 card vs CPU: within this many times the CPU's own bfloat16
# distance from float32 (tests/test_torch_bf16.py's GAP_FACTOR)
BF16_GAP_FACTOR = 2.0
# the scan's backward beside its forward: the training shape and the
# forward's edge shapes (LRU_EDGES)
LRU_TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 2560)
# training through flash_attention and its backward kernel: qwen3-0.6b at
# its published width and depth (its float32 weights, gradients and AdamW
# moments are about 12 GB, the batch's logits and their gradient about 10
# GB), batch 2 x 4096, remat full, the rest as the recurrentgemma-2b step;
# its reduced config (head dim 16) held card vs CPU
FLASH_TRAIN_ARCH, FLASH_TRAIN_BATCH, FLASH_TRAIN_SEQ = "qwen3-0.6b", 2, 4096
# the backward kernel against its plain version in float64: (label, B, T,
# S, H, KVH, hd, causal, window), the slice's shape first (timed, with the
# forward), recurrentgemma-2b's local window and seamless-m4t-medium's
# encoder and cross attention (timed beside SDPA's backward); then small
# shapes: T off the tiles, S under one tile, G in {1, 2, 5}, head dims 16,
# 24 and 32 through the padding, a row of one query
FLASH_BWD_MAIN = (
    ("qwen3-0.6b train", 2, 4096, 4096, 16, 8, 128, True, None),
    ("recurrentgemma-2b window", 4, 4096, 4096, 10, 1, 256, True, 2048),
    ("seamless-m4t-medium encoder", 4, 4000, 4000, 16, 16, 64, False, None),
    ("seamless-m4t-medium cross", 4, 1000, 4000, 16, 16, 64, False, None))
FLASH_BWD_SMALL = (
    (2, 150, 150, 4, 2, 64, True, None), (1, 150, 150, 4, 2, 128, True, 40),
    (2, 100, 100, 10, 2, 256, True, 70), (1, 120, 120, 5, 1, 64, False, None),
    (2, 100, 230, 4, 2, 64, False, None), (1, 230, 100, 8, 2, 128, False, None),
    (1, 300, 300, 5, 1, 256, True, 160), (2, 129, 129, 2, 1, 128, True, None),
    (1, 1, 9, 2, 1, 64, False, None), (1, 70, 70, 2, 1, 16, True, None),
    (1, 70, 70, 4, 2, 24, True, 30), (2, 90, 40, 4, 4, 32, False, None),
    (1, 517, 517, 4, 4, 128, True, None),
    # the walks' tile edges: T and S one off the dK/dV key tile (64) and
    # the dQ q tile (64 in float32, 128 in bfloat16), a window edge that
    # cuts a key tile, G = 8, cross attention with S off the key tile
    (2, 63, 63, 4, 2, 128, True, None), (1, 65, 65, 4, 1, 256, True, None),
    (1, 127, 127, 4, 2, 64, True, 50), (1, 129, 129, 2, 2, 256, False, None),
    (1, 300, 300, 4, 2, 128, True, 96), (1, 200, 200, 8, 1, 128, True, None),
    (2, 128, 200, 4, 2, 64, False, None), (1, 130, 70, 2, 1, 256, False, None))
# each main shape's backward ms a call as recorded with the backward's
# earlier design (mma.sync in both dtypes, a grid axis over output columns
# that formed S and dP again for each, synchronous loads), on NVIDIA H100
# 80GB HBM3 at 700 W (printed beside this run's, never in the kernels'
# record): (float32, bfloat16)
FLASH_BWD_EARLIER = {"qwen3-0.6b train": (16.9693, 4.1760),
                     "recurrentgemma-2b window": (77.9864, 17.2924),
                     "seamless-m4t-medium encoder": (22.9331, 6.0799),
                     "seamless-m4t-medium cross": (5.9678, 1.6623)}
# this design's limits at the main shapes, ms a call (float32, bfloat16):
# float32 at most 12.0 ms at qwen3-0.6b's shape and 40 ms at
# recurrentgemma-2b's window, no slower than the earlier design at the
# seamless shapes; bfloat16 at most 1.25 ms at qwen3-0.6b's and half the
# earlier design's time at the other three
FLASH_BWD_LIMIT_MS = {
    "qwen3-0.6b train": (12.0, 1.25),
    "recurrentgemma-2b window": (40.0, 17.2924 / 2),
    "seamless-m4t-medium encoder": (22.9331, 6.0799 / 2),
    "seamless-m4t-medium cross": (5.9678, 1.6623 / 2)}
# operations a live (query, key) pair in each walk of the backward: the
# dK/dV walk forms S^T, dP^T, dV and dK, the dQ walk S, dP and dQ
FLASH_BWD_WALK_OPS = {"dkv": 8, "dq": 6}


def lru_backward_phase(torch, LS):
    """``lru_scan_backward`` against ``lru_scan_backward_plain`` bit for
    bit at the training shape and the edge shapes, on seeded inputs of
    slow decay with nonzero ``h0`` and ``dh_last``; timed at the training
    shape beside its byte bound (a, dh_seq, h_seq read, da, db written,
    and the (B, W) rows), and the forward timed at the same shape.
    Returns ``{"lru_scan_backward": rec, "lru_scan.train": rec}``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    recs, errs = {}, {}
    for B_, T_, W_ in (LRU_TRAIN_SHAPE,) + LRU_EDGES:
        a = 0.9 + 0.1 * torch.rand(B_, T_, W_, generator=g, device=dev)
        h0 = torch.randn(B_, W_, generator=g, device=dev)
        b = torch.randn(B_, T_, W_, generator=g, device=dev)
        h_seq, _ = LS.lru_scan_plain(a, b, h0)
        dh_seq = torch.randn(B_, T_, W_, generator=g, device=dev)
        dh_last = torch.randn(B_, W_, generator=g, device=dev)
        xs = (a, h0, h_seq, dh_seq, dh_last)
        got = LS.lru_scan_backward(*xs)
        want = LS.lru_scan_backward_plain(*xs)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, want))
        label = f"B={B_} T={T_} W={W_}"
        errs[label] = max(float((x - y).abs().max()) for x, y in
                          zip(got, want))
        print(f"[kernel] lru_scan backward {label}: da, db, dh0 equal to "
              f"plain {same}, max abs err {errs[label]:.3e}", flush=True)
        check(same, f"lru_scan backward {label}: kernel differs from plain "
              f"(max abs err {errs[label]})")
        if (B_, T_, W_) != LRU_TRAIN_SHAPE:
            continue
        n, n_h = a.numel(), h0.numel()
        for name, fn, plain, nbytes in (
                ("lru_scan_backward", lambda: LS.lru_scan_backward(*xs),
                 lambda: LS.lru_scan_backward_plain(*xs),
                 (5 * n + 3 * n_h) * 4),
                ("lru_scan.train", lambda: LS.lru_scan(a, b, h0),
                 lambda: LS.lru_scan_plain(a, b, h0), (3 * n + 2 * n_h) * 4)):
            ms = cuda_ms(torch, fn, 20)
            plain_ms = cuda_ms(torch, plain, 2)
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = (3 if name == "lru_scan_backward" else 2) * n / \
                FP32_OPS_PER_S
            recs[name] = dict(
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None, shape=[B_, T_, W_], bytes=nbytes)
            print(f"[kernel] {name.replace('.train', ' (training shape)')}:"
                  f" a {(B_, T_, W_)} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={recs[name]['bound_ms']:.4f} ({nbytes / 1e6:.1f}"
                  f" MB over 3.35 TB/s)", flush=True)
        del xs, got, want, a, b, h0, h_seq, dh_seq, dh_last
    recs["lru_scan_backward"]["errs"] = errs
    recs["lru_scan_backward"]["max_abs_err"] = max(errs.values())
    recs["lru_scan.train"]["max_abs_err"] = 0.0
    torch.cuda.empty_cache()
    return recs


def sdpa_backward_call(torch, q, k, v, dout, kw):
    """The library's attention backward on the inputs of
    ``flash_attention(q, k, v, **kw)``: ``scaled_dot_product_attention``
    with heads first, the KV head repeated for every query head (the
    repeated tensors are the leaves, so no reduction over the heads is
    timed) and the same mask, its gradients for ``dout``."""
    import torch.nn.functional as F
    T, H, S = q.shape[1], q.shape[2], k.shape[1]
    G = H // k.shape[2]
    qs = q.transpose(1, 2).detach().requires_grad_()
    ks = k.transpose(1, 2).repeat_interleave(G, dim=1).requires_grad_()
    vs = v.transpose(1, 2).repeat_interleave(G, dim=1).requires_grad_()
    if kw["window"] is None:
        out = F.scaled_dot_product_attention(qs, ks, vs,
                                             is_causal=kw["causal"])
    else:
        pos_q = torch.arange(T, device=q.device)[:, None]
        pos_k = torch.arange(S, device=q.device)[None, :]
        mask = pos_q - pos_k < kw["window"]
        if kw["causal"]:
            mask &= pos_q >= pos_k
        out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    do = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                       retain_graph=True)


def median_ms(torch, fn, reps=20, rounds=3):
    """The median over ``rounds`` of ``cuda_ms(fn, reps)``."""
    return sorted(cuda_ms(torch, fn, reps) for _ in range(rounds))[
        rounds // 2]


def bwd_walk_times(torch, fn, pairs, hd, bf16, reps=3):
    """Each of the backward's launches timed by its kernel's name in a
    profile of ``reps`` calls of ``fn`` (device ms, the mean of its
    launches): the dK/dV walk (``dkv_kernel``), the dQ walk
    (``dq_kernel``) and D (``delta_kernel``), the walks each beside its own
    bound (``FLASH_BWD_WALK_OPS`` * hd operations a live pair on the
    instance's tensor-core rate)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # late in the full run a profile of these few calls at times reported
    # none of their kernels: the window is padded by half a second at each
    # end and taken again, up to four times, while a kernel is missing
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.5)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.5)
        # the mean of each kernel's launches (a dropped event leaves it)
        times = {"dkv": [], "dq": [], "delta": []}
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                for key, got in times.items():
                    if f"{key}_kernel" in evt.name:
                        got.append(evt.time_range.elapsed_us() / 1e3)
        if all(times.values()):
            break
    rate = BF16_OPS_PER_S if bf16 else TF32_OPS_PER_S / SPLIT_TF32_MMAS
    out = {}
    for key, got in times.items():
        ms = sum(got) / len(got) if got else None
        out[key] = dict(ms=ms, launches=len(got))
        if key in FLASH_BWD_WALK_OPS:
            bound = FLASH_BWD_WALK_OPS[key] * hd * pairs / rate * 1e3
            out[key].update(bound_ms=bound,
                            bound_share=bound / ms if ms else None)
    return out


def walk_text(key, w):
    """One walk of ``bwd_walk_times`` for a ``[kernel]`` line."""
    if w["ms"] is None:
        return f"{key} not captured by the profiler"
    text = f"{key} {w['ms']:.4f}"
    if key in FLASH_BWD_WALK_OPS:
        text += (f" (bound {w['bound_ms']:.4f} at {FLASH_BWD_WALK_OPS[key]}"
                 f"*hd a pair, {w['bound_share']:.3f} of it)")
    return text


def flash_backward_phase(torch, np, FL):
    """``flash_attention``'s backward kernel, float32 and bfloat16, on
    seeded inputs from the forward kernel's own ``out`` and ``lse``,
    against ``flash_attention_backward_plain`` taken in float64 from the
    same tensors (each gradient's max abs gap over its max |g|, within
    ``BWD_F32_TOL`` or ``BWD_BF16_TOL``), at ``FLASH_BWD_MAIN`` and
    ``FLASH_BWD_SMALL``; ``out`` bit-equal with and without ``lse`` at each.
    The main shapes are timed beside the plain version (float32 formulas),
    the bound (10*hd operations a live pair: S again, dP, dV, dK, dQ) and
    SDPA's backward; at the slice's shape the forward with ``lse`` is timed
    too.  Returns ``{dtype: {label: record}}``."""
    dev = torch.device("cuda")
    recs = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        tol = FL.BWD_BF16_TOL if bf16 else FL.BWD_F32_TOL
        tag = " bfloat16" if bf16 else ""
        out_recs = recs[str(dtype).removeprefix("torch.")] = {}
        g = torch.Generator(device=dev).manual_seed(21)
        for case in FLASH_BWD_MAIN + FLASH_BWD_SMALL:
            main = isinstance(case[0], str)
            label = case[0] if main else "small"
            B_, T_, S_, H_, KVH_, hd, causal, window = case[1:] if main \
                else case
            mk = lambda *sh: torch.randn(*sh, generator=g, device=dev).to(
                dtype)
            q, k, v = mk(B_, T_, H_, hd), mk(B_, S_, KVH_, hd), \
                mk(B_, S_, KVH_, hd)
            dout = mk(B_, T_, H_, hd)
            kw = dict(causal=causal, window=window)
            out, lse = FL.flash_attention_with_lse(q, k, v, **kw)
            same = torch.equal(out, FL.flash_attention(q, k, v, **kw))
            got = FL.flash_attention_backward(q, k, v, out, lse, dout, **kw)
            want = FL.flash_attention_backward_plain(
                *(x.double() for x in (q, k, v, out, lse, dout)), **kw)
            torch.cuda.synchronize()
            gaps = {n: (float((x.double() - w).abs().max()),
                        float(w.abs().max()))
                    for n, x, w in zip(("dq", "dk", "dv"), got, want)}
            del want, got
            rel = max(d / max(m, 1e-30) for d, m in gaps.values())
            shape = (f"q {(B_, T_, H_, hd)} k,v {(B_, S_, KVH_, hd)} "
                     f"causal={causal} window={window}")
            line = (f"[kernel] flash_attention backward{tag} {label}: {shape}"
                    + "".join(f"; {n} max abs gap {d:.3e} of max |g| {m:.3e}"
                              f" ({d / max(m, 1e-30):.2e})"
                              for n, (d, m) in gaps.items())
                    + f" (bound {tol:g} of max |g|); out with and without "
                      f"lse bit-equal {same}")
            check(rel <= tol, f"flash_attention backward{tag} {shape}: "
                  f"{gaps} beyond {tol} of max |g|")
            check(same, f"flash_attention{tag} {shape}: out differs with lse")
            rec = dict(shape=[B_, T_, S_, H_, KVH_, hd], causal=causal,
                       window=window, gaps=gaps, max_rel_err=rel,
                       max_abs_err=max(d for d, _ in gaps.values()),
                       out_bit_equal_with_lse=same)
            if main:
                bwd = lambda: FL.flash_attention_backward(q, k, v, out, lse,
                                                          dout, **kw)
                # the median of three rounds of 20 calls, the library's
                # alike: the card's speed drifts within a run by a few
                # percent, and over 5 calls the first call's host work (the
                # wrapper, the tensor maps) showed in a call's time
                ms = median_ms(torch, bwd)
                plain_ms = cuda_ms(torch, lambda: FL.flash_attention_backward_plain(
                    q, k, v, out, lse, dout, **kw), 1)
                sdpa = sdpa_backward_call(torch, q, k, v, dout, kw)
                lib_ms = median_ms(torch, sdpa)
                del sdpa
                pairs = live_pairs(np, T_, S_, causal, window) * B_ * H_
                ops = 10 * hd * pairs
                t_ops = ops / BF16_OPS_PER_S if bf16 else \
                    SPLIT_TF32_MMAS * ops / TF32_OPS_PER_S
                # q, out, dout read and dq written; k, v read, dk, dv
                # written; lse read
                nbytes = 4 * (q.numel() + k.numel()) * q.element_size() \
                    + 4 * lse.numel()
                t_bytes = nbytes / HBM_BYTES_PER_S
                bound = max(t_ops, t_bytes) * 1e3
                rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound, bound_share=bound / ms,
                           bound_by="operations" if t_ops >= t_bytes
                           else "bytes", live_pairs=pairs, ops=ops,
                           bytes=nbytes)
                walks = bwd_walk_times(torch, bwd, pairs, hd, bf16)
                earlier = FLASH_BWD_EARLIER[label][bf16]
                limit = FLASH_BWD_LIMIT_MS[label][bf16]
                rec.update(walks=walks, sdpa_ratio=ms / lib_ms,
                           limit_ms=limit,
                           recorded_earlier_design_ms=earlier)
                line += (f"; live_pairs={pairs} ms={ms:.4f} plain_ms="
                         f"{plain_ms:.4f} bound_ms={bound:.4f} ("
                         + ("bfloat16 on the tensor cores" if bf16 else
                            "split TF32 on the tensor cores")
                         + f"; {bound / ms:.3f} of it reached) "
                         f"sdpa_backward_ms={lib_ms:.4f} ({ms / lib_ms:.2f}x "
                         f"its time); walks (profiler, device ms a call): "
                         + ", ".join(walk_text(k, w)
                                     for k, w in walks.items())
                         + f"; limit {limit:.4f} ms; recorded with the "
                           f"earlier design, not measured here: "
                           f"{earlier:.4f} ms (NVIDIA H100 80GB HBM3, 700 W)")
                if label == FLASH_BWD_MAIN[0][0]:
                    # the forward at the training shape, against its plain
                    # version at the flash holds' bounds
                    f_tol = FL.BF16_PLAIN_TOL if bf16 else FLASH_TOL
                    f_err = float((out.float() - FL.flash_attention_plain(
                        q, k, v, **kw).float()).abs().max())
                    check(f_err <= f_tol, f"flash_attention{tag} {shape}: "
                          f"kernel vs plain {f_err} > {f_tol}")
                    fwd = lambda: FL.flash_attention_with_lse(q, k, v, **kw)
                    f_ms = cuda_ms(torch, fwd, 5)
                    f_plain = cuda_ms(torch, lambda: FL.flash_attention_plain(
                        q, k, v, return_lse=True, **kw), 1)
                    f_lib = cuda_ms(torch, sdpa_call(torch, q, k, v, kw), 5)
                    f_ops = 4 * hd * pairs
                    f_bound = max(f_ops / BF16_OPS_PER_S if bf16 else
                                  SPLIT_TF32_MMAS * f_ops / TF32_OPS_PER_S,
                                  2 * (q.numel() + k.numel())
                                  * q.element_size() / HBM_BYTES_PER_S) * 1e3
                    rec["forward"] = dict(
                        ms=f_ms, plain_ms=f_plain, library_ms=f_lib,
                        bound_ms=f_bound, bound_share=f_bound / f_ms,
                        bound_by="operations", max_abs_err=f_err)
                    line += (f"; forward with lse max_abs_err={f_err:.3e} "
                             f"(tol {f_tol:g}) ms={f_ms:.4f} plain_ms="
                             f"{f_plain:.4f} bound_ms={f_bound:.4f} "
                             f"({f_bound / f_ms:.3f} of it) sdpa_ms="
                             f"{f_lib:.4f}")
                out_recs[label] = rec
            else:
                out_recs.setdefault("small", []).append(rec)
            print(line, flush=True)
            if main:
                check(rec["ms"] <= rec["limit_ms"],
                      f"flash_attention backward{tag} {label}: "
                      f"{rec['ms']:.4f} ms > its limit {rec['limit_ms']} ms")
            del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return recs


def serve_reduced_phase(torch, np, mod):
    """``python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced
    --device cuda``, the JAX package's own docstring example
    (``src/repro/launch/serve.py:3``) on the card: the reduced config's
    head dim 16 runs flash's padded instance in prefill.  Its tokens must
    be an engine's on the launcher's draws (the same seeded generator on
    the card), run here, whose prefill launches flash once a layer."""
    T_, cfgs = mod("models.transformer"), mod("configs")
    FL = mod("kernels.flash_attention")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           FLASH_TRAIN_ARCH, "--reduced", "--device", "cuda"]
    t = time.perf_counter()
    r = run_alone(cmd)
    s = time.perf_counter() - t
    check(r.returncode == 0, f"serve --reduced exit {r.returncode}: "
          f"{r.stderr[-2000:]}")
    served = np.array([json.loads(ln.split(":", 1)[1]) for ln in
                       r.stdout.splitlines() if ln.startswith("seq ")])
    cfg = cfgs.reduced_config(cfgs.get_config(FLASH_TRAIN_ARCH))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = T_.init_lm(cfg, gen, device=dev)
    prompt = torch.randint(0, cfg.vocab, (2, 16), generator=gen, device=dev)
    n = FL.LAUNCHES["flash_attention"]
    with torch.inference_mode():
        want = mod("serve.engine").LMEngine(
            model, cfg, T_.RunCfg(dtype=torch.float32), batch=2,
            max_len=24).generate(prompt.cpu().numpy(), 8)
    launched = FL.LAUNCHES["flash_attention"] - n
    same = served.shape == want.shape and bool((served == want).all())
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    print(f"[main] serve --reduced: {' '.join(cmd[1:])}: exit "
          f"{r.returncode} in {s:.1f} s ({tail}); head dim "
          f"{cfg.resolved_head_dim} (the kernel's {FL.instance_head_dim(cfg.resolved_head_dim)} "
          f"instance, zero-padded); served tokens {served.shape} equal an "
          f"engine's on the launcher's draws {same}; flash launches in that "
          f"engine's prefill {launched}", flush=True)
    check(same and launched == cfg.n_layers, f"serve --reduced: tokens "
          f"equal {same}, flash launches {launched}")
    return dict(returncode=r.returncode, wall_s=s, tokens_equal=same,
                head_dim=cfg.resolved_head_dim, flash_launches=launched)


def kernel_counts(mod):
    """Every kernel's launch count of the LM path, one dict."""
    return {**mod("kernels.lru_scan").LAUNCHES,
            **mod("kernels.flash_attention").LAUNCHES}


def train_check_phase(torch, mod, arch=TRAIN_ARCH, impl="naive"):
    """One ``make_train_step`` step of ``arch`` reduced to 3 layers on the
    card (the kernels, forward and backward) and on the CPU (the plain
    versions), from the same weights and batch (two microbatches):
    recurrentgemma-2b (two RG-LRU, one local attention) with
    ``impl="naive"``, or qwen3-0.6b (head dim 16: flash's padded
    instances) with ``impl="flash"``.  The loss within 1e-5 relative;
    every gradient (the clipped one AdamW read) within 1e-4 of its leaf's
    largest value."""
    T_, cfgs = mod("models.transformer"), mod("configs")
    data = mod("data.pipeline")
    step_mod, opt = mod("train.step"), mod("optim.adamw")
    cfg = cfgs.reduced_config(cfgs.get_config(arch), n_layers=3)
    run = T_.RunCfg(impl=impl, dtype=torch.float32)
    batch = data.SyntheticSource(cfg.vocab, 4, 100, n_micro=2).batch(0)
    out = {}
    for dev in ("cpu", "cuda"):
        model = T_.init_lm(cfg, torch.Generator().manual_seed(1),
                           device="cpu").to(dev)
        step = step_mod.make_train_step(cfg, run, opt.AdamWConfig())
        before = kernel_counts(mod)
        _, m = step(step_mod.train_state(model), data.to_device(batch, dev))
        out[dev] = (float(m["loss"]), {k: p.grad.cpu() for k, p in
                                       model.named_parameters()},
                    {k: v - before[k] for k, v in kernel_counts(mod).items()
                     if v != before[k]})
    (want, gw, _), (got, gg, n) = out["cpu"], out["cuda"]
    rel = abs(got - want) / abs(want)
    gaps = grad_gaps(gg, gw)
    worst = max(gaps, key=gaps.get)
    flash = " flash" if impl == "flash" else ""
    print(f"[check] train step{flash} card vs cpu: {arch} reduced to "
          f"{cfg.n_layers} layers ({cfg.block_pattern}, head dim "
          f"{cfg.resolved_head_dim}), batch 2 x 2 "
          f"microbatches x 100 tokens: loss {got:.7f} vs {want:.7f} (rel "
          f"{rel:.3e}, tol {TRAIN_LOSS_RTOL}); largest gradient gap "
          f"{gaps[worst]:.3e} of its leaf's max |g| ({worst}; tol "
          f"{TRAIN_GRAD_TOL}) over {len(gaps)} leaves; card launches "
          f"{json.dumps(n)}", flush=True)
    check(rel <= TRAIN_LOSS_RTOL, f"train step{flash} loss card vs cpu {rel}")
    check(gaps[worst] <= TRAIN_GRAD_TOL, f"train step{flash} gradient {worst} "
          f"card vs cpu {gaps[worst]}")
    kinds = ("flash_attention", "flash_attention_backward") if flash else \
        ("lru_scan", "lru_scan_backward")
    check(n == {k: 2 * 3 if flash else 4 for k in kinds},
          f"train step{flash} launches {n}: want {kinds} "
          f"{'6 each (3 layers x 2 microbatches)' if flash else '4 each'}")
    return dict(loss_rel=rel, grad_gap=gaps[worst], grad_gap_leaf=worst,
                launches=n)


def grad_gaps(got, want):
    """Each leaf's max |got - want| over its largest |want|."""
    return {k: float((got[k].float() - w.float()).abs().max())
            / max(float(w.float().abs().max()), 1e-12)
            for k, w in want.items()}


def token_nll(torch, mod, model, tokens, targets, cfg, run):
    """Each token's cross entropy of a decoder-only model before the
    mean that ``lm_loss`` takes, as ``lm_loss`` computes it (its blocks,
    the head's logits in ``run.dtype``, the log-sum-exp in float32)."""
    T_, L = mod("models.transformer"), mod("models.layers")
    with torch.no_grad():
        x = T_.embed_tokens(model, tokens, run.dtype)
        for blk in model.blocks:
            x, _ = T_._train_block(blk, x, cfg, run, True, None)
        logits = T_._logits(model, L.rmsnorm(model.final_norm, x,
                                             cfg.norm_eps), run.dtype)
        true = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - true).float().cpu()


def train_check_bf16_phase(torch, mod, arch=TRAIN_ARCH, impl="naive"):
    """The same reduced step (``arch``, ``impl``) with
    ``param_dtype=bfloat16`` weights (drawn
    in float32 and rounded), ``master_fp32`` and bfloat16 compute, on the
    card and on the CPU, one microbatch (so each parameter's ``.grad``
    holds the bfloat16 gradient AdamW read).  The bound is the float32
    check's form scaled to bfloat16 the way the CPU tests scale theirs
    (tests/test_torch_bf16.py): the CPU's own bfloat16 distance from
    float32 on the same rounded weights (the port's float32 step on the
    CPU), times ``BF16_GAP_FACTOR``; the loss's reference distance
    floored at 2**-16 of it.  A card that computed in float32 would pass
    those, so the prefill's logits before the step must be bfloat16
    values, as the head rounds them.

    With ``impl="flash"`` the loss is held token by token instead: each
    token's cross entropy on the weights before the step (the largest
    card-vs-CPU gap within ``BF16_GAP_FACTOR`` times the largest CPU
    bfloat16-vs-float32 gap).  The mean of 400 tokens' rounding errors
    cancels by chance: on the CPU alone two bfloat16 losses of the same
    reduced qwen3-0.6b step (flash and naive attention) differ by 7.1e-4
    while either one's distance from float32 is 1.1e-4 or 8.2e-4, so a
    bound of twice one such distance holds nothing steady."""
    T_, cfgs = mod("models.transformer"), mod("configs")
    data = mod("data.pipeline")
    step_mod, opt = mod("train.step"), mod("optim.adamw")
    cfg = cfgs.reduced_config(cfgs.get_config(arch), n_layers=3)
    bf = torch.bfloat16
    batch = data.SyntheticSource(cfg.vocab, 4, 100, n_micro=1).batch(0)
    out = {}
    for key, dev, dtype in (("cpu", "cpu", bf), ("cuda", "cuda", bf),
                            ("cpu float32", "cpu", torch.float32)):
        model = T_.init_lm(cfg, torch.Generator().manual_seed(1),
                           device="cpu", dtype=bf).to(dev, dtype)
        run = T_.RunCfg(impl=impl, dtype=dtype)
        ocfg = opt.AdamWConfig(master_fp32=dtype == bf)
        if dev == "cuda":
            with torch.no_grad():
                logits, _ = T_.prefill(model, {"tokens": data.to_device(
                    batch, dev)["tokens"][0]}, cfg, run)
        on_dev = data.to_device(batch, dev)
        nll = token_nll(torch, mod, model, on_dev["tokens"][0],
                        on_dev["targets"][0], cfg, run) if impl == "flash" \
            else None
        before = kernel_counts(mod)
        if dtype == bf:
            step = step_mod.make_train_step(cfg, run, ocfg)
            _, m = step(step_mod.train_state(model, ocfg),
                        data.to_device(batch, dev))
            loss = float(m["loss"])
        else:       # the float32 reference: its unclipped gradients
            model.requires_grad_(True)
            loss, _ = T_.lm_loss(model, {k: v[0] for k, v in
                                         data.to_device(batch, dev).items()},
                                 cfg, run)
            loss.backward()
            loss = float(loss.detach())
        out[key] = (loss, {k: p.grad.cpu() for k, p in
                           model.named_parameters()},
                    {k: v - before[k] for k, v in kernel_counts(mod).items()
                     if v != before[k]}, nll)
    (want, gw, _, nw), (got, gg, n, ng), (ref, gr, _, nr) = (
        out["cpu"], out["cuda"], out["cpu float32"])
    # the card's prefill logits, which the head rounds to bfloat16: a
    # float32 path's would not be bfloat16 values.  Their bits are not
    # counted against the CPU's: cuBLAS's bfloat16 products sum in other
    # orders, and through a few layers the card's logits differ in about
    # as many bits as the float32 path's (PERF.md)
    rounded = torch.equal(logits, logits.to(bf).float())
    loss_tol = BF16_GAP_FACTOR * max(abs(want - ref), 2.0 ** -16 * abs(want))
    if nw is not None:       # flash: token by token
        tok_gap = float((ng - nw).abs().max())
        tok_tol = BF16_GAP_FACTOR * float((nw - nr).abs().max())
    cpu_gaps, gaps = grad_gaps(gw, gr), grad_gaps(gg, gw)
    grad_tol = BF16_GAP_FACTOR * max(cpu_gaps.values())
    worst = max(gaps, key=gaps.get)
    flash = " flash" if impl == "flash" else ""
    print(f"[check] train step{flash} bfloat16 card vs cpu: {arch} reduced "
          f"to {cfg.n_layers} layers (head dim {cfg.resolved_head_dim}), "
          f"param_dtype bfloat16, master_fp32, "
          f"batch 4 x 100 tokens: loss {got:.7f} vs {want:.7f} (|d| "
          f"{abs(got - want):.3e}, " + (
              f"tol {loss_tol:.3e} = {BF16_GAP_FACTOR} x the CPU's "
              f"bfloat16-vs-float32 {abs(want - ref):.3e}, floored); "
              if nw is None else
              f"the CPU's bfloat16-vs-float32 {abs(want - ref):.3e}; held "
              f"token by token: largest token gap {tok_gap:.3e}, tol "
              f"{tok_tol:.3e} = {BF16_GAP_FACTOR} x the CPU's largest "
              f"bfloat16-vs-float32 {tok_tol / BF16_GAP_FACTOR:.3e}); ") +
          f"largest gradient gap {gaps[worst]:.3e} of its leaf's max |g| "
          f"({worst}; tol {grad_tol:.3e} = {BF16_GAP_FACTOR} x the CPU's "
          f"bfloat16-vs-float32 {max(cpu_gaps.values()):.3e}) over "
          f"{len(gaps)} leaves; prefill logits bfloat16 values {rounded}; "
          f"card launches {json.dumps(n)}", flush=True)
    check(all(p.dtype == bf for p in gg.values()), "bfloat16 gradients")
    check(rounded, "bfloat16 train check: prefill logits not bfloat16 values")
    if nw is None:
        check(abs(got - want) <= loss_tol, f"bfloat16 train step loss card "
              f"vs cpu {abs(got - want)} > {loss_tol}")
    else:
        check(tok_gap <= tok_tol, f"bfloat16 train step{flash} token losses "
              f"card vs cpu {tok_gap} > {tok_tol}")
    check(gaps[worst] <= grad_tol, f"bfloat16 train step gradient {worst} "
          f"card vs cpu {gaps[worst]} > {grad_tol}")
    kinds = ("flash_attention.bfloat16", "flash_attention_backward.bfloat16") \
        if flash else ("lru_scan", "lru_scan_backward")
    check(n == {k: 3 if flash else 2 for k in kinds},
          f"bfloat16 train step{flash} launches {n}: want {kinds} "
          f"{'3 each' if flash else '2 each'}")
    return dict(loss_abs=abs(got - want),
                loss_tol=loss_tol if nw is None else None,
                token_loss_gap=None if nw is None else tok_gap,
                token_loss_tol=None if nw is None else tok_tol,
                grad_gap=gaps[worst], grad_tol=grad_tol, grad_gap_leaf=worst,
                logits_bfloat16=rounded,
                launches=n)


def train_state_and_step(torch, mod, cfg, run, ocfg, bf16, dev):
    """A fresh full-width train state (seed 0) and its step function."""
    step_mod = mod("train.step")
    state, init_s = wall(torch, lambda: step_mod.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        param_dtype=torch.bfloat16 if bf16 else None, opt_cfg=ocfg))
    return state, step_mod.make_train_step(cfg, run, ocfg), init_s


def naive_beside(torch, mod, cfg, run, ocfg, bf16, dev, src):
    """The same step with ``impl="naive"`` from the same weights (seed 0)
    and first batch, once (the smoke's time is kept to the earlier
    slices'): its loss, its time (a first step: it pays the naive
    attention's first calls) and the peak memory; ``fits=False`` where
    the (B, H, T, S) scores do not fit the card."""
    import dataclasses
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    holder = {}
    try:
        holder["state"], step_fn, _ = train_state_and_step(
            torch, mod, cfg, dataclasses.replace(run, impl="naive"), ocfg,
            bf16, dev)
        data = mod("data.pipeline")
        (holder["state"], m), t = wall(torch, lambda: step_fn(
            holder["state"], data.to_device(src.batch(0), dev)))
        out = dict(first_loss=float(m["loss"]), step_s=t,
                   peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    except torch.cuda.OutOfMemoryError as exc:
        out = dict(fits=False, error=str(exc).splitlines()[0][:200])
    holder.clear()
    torch.cuda.empty_cache()
    return out


def train_main_phase(torch, mod, all_launches, dtype=None, arch=TRAIN_ARCH,
                     impl="naive", batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """``make_train_step`` on ``arch`` at its published width and depth:
    batch x seq synthetic tokens (``SyntheticSource``), remat full, one
    microbatch, AdamW's defaults: recurrentgemma-2b (batch 2 x 1024)
    through the scan kernels forward and backward with attention naive,
    as JAX's trainer, or qwen3-0.6b (batch 2 x 4096) through
    ``flash_attention`` and its backward kernel (``impl="flash"``).  One
    warm-up step, ``TRAIN_STEPS`` timed steps with the launches counted
    from 0, then one profiled step for the device's idle share; for
    ``impl="flash"`` then the same step with ``impl="naive"`` beside it
    (:func:`naive_beside`), its first loss held to the flash step's
    within ``TRAIN_LOSS_RTOL`` in float32.  Writes no checkpoint.
    ``dtype=bfloat16``: ``init_train_state(param_dtype=bfloat16)`` with
    ``master_fp32`` and bfloat16 compute (the scan stays float32, as in
    JAX)."""
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    T_, cfgs = mod("models.transformer"), mod("configs")
    data, opt = mod("data.pipeline"), mod("optim.adamw")
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = cfgs.get_config(arch)
    run = T_.RunCfg(impl=impl, remat="full", dtype=dtype)
    ocfg = opt.AdamWConfig(master_fp32=bf16)
    state, step_fn, init_s = train_state_and_step(torch, mod, cfg, run, ocfg,
                                                  bf16, dev)
    n_params = sum(p.numel() for p in state.params.parameters())
    src = data.SyntheticSource(cfg.vocab, batch, seq)
    flash = " flash" if impl == "flash" else ""
    label = f"{arch} train{flash}{' bfloat16' if bf16 else ''}"
    state_gb = (n_params * (2 + 3 * 4) if bf16 else 3 * n_params * 4) / 1e9
    print(f"[lm] {label}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, {n_params} parameters, "
          + (f"bfloat16 params + float32 master, m, v {state_gb:.2f} GB"
             if bf16 else f"params + m + v {state_gb:.2f} GB float32")
          + f", initialised in {init_s:.2f} s", flush=True)
    holder = {"state": state}
    del state

    def one(i):
        holder["state"], m = step_fn(holder["state"],
                                     data.to_device(src.batch(i), dev))
        return m
    m, warm_s = wall(torch, lambda: one(0))
    first_loss = float(m["loss"])
    zero_counts(all_launches)
    times, losses, norms = [], [], []
    for i in range(1, TRAIN_STEPS + 1):
        m, s = wall(torch, lambda i=i: one(i))
        times.append(s)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = kernel_counts(mod)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall_s, n_kernels, kernels = profile_window(
        torch, lambda: one(TRAIN_STEPS + 1))
    busy = sum(t for _, t in kernels)
    idle = 1.0 - busy / wall_s if busy else None
    step_s = sum(times) / len(times)
    tok_s = batch * seq / step_s
    n_rec = sum(cfg.block_kind(i) in ("rglru", "mamba")
                for i in range(cfg.n_layers))
    n_attn = sum(cfg.block_kind(i) in ("attn", "local")
                 for i in range(cfg.n_layers))
    per = {k: v / TRAIN_STEPS for k, v in launches.items()}
    top = ", ".join(f"{n[:50]} {t * 1e3:.1f} ms" for n, t in kernels[:5])
    kept = {p.dtype for p in holder["state"].params.parameters()}
    holder.clear()
    torch.cuda.empty_cache()
    beside = (naive_beside(torch, mod, cfg, run, ocfg, bf16, dev, src)
              if flash else None)
    print(f"[main] {label} ({cfg.n_layers} layers, full width): "
          f"batch {batch} x {seq} tokens, remat full, AdamW "
          f"defaults{', master_fp32' if bf16 else ''}: {step_s:.3f} s/step (steps {', '.join(f'{t:.3f}' for t in times)}; "
          f"warm-up {warm_s:.3f} s), {tok_s:.1f} tokens/s; losses "
          f"{losses}, grad_norm {norms}; peak device memory {peak_gb:.3f} "
          f"GB; launches a step "
          f"{json.dumps({k: v for k, v in per.items() if v})}", flush=True)
    if beside is not None:
        rel = (abs(beside["first_loss"] - first_loss) / abs(first_loss)
               if "first_loss" in beside else None)
        print(f"[main] {label} beside impl=naive: " + (
            f"{beside['step_s']:.3f} s for its first step, peak device "
            f"memory {beside['peak_device_gb']:.3f} GB; "
            f"first step's loss {beside['first_loss']:.7f} vs flash "
            f"{first_loss:.7f} (rel {rel:.3e}"
            + (f", tol {TRAIN_LOSS_RTOL})" if not bf16 else
               ", bfloat16: not held here, the reduced check holds it)")
            if rel is not None else
            f"does not fit the card ({beside['error']})"), flush=True)
        if rel is not None and not bf16:
            check(rel <= TRAIN_LOSS_RTOL, f"{label}: first loss flash "
                  f"{first_loss} vs naive {beside['first_loss']}")
    print(f"[profile] {label} step: {n_kernels} kernels, device "
          f"busy {busy:.3f} s of {wall_s:.3f} s under the profiler (idle "
          f"share {'not measured' if idle is None else f'{idle:.3f}'}); top "
          f"kernels: {top}", flush=True)
    check(all(np.isfinite(x) for x in losses + norms + [first_loss]),
          "train losses and grad norms finite")
    check(peak_gb < 80.0, f"train peak memory {peak_gb} GB")
    sfx = ".bfloat16" if bf16 else ""
    want = {"flash_attention" + sfx: 2 * n_attn,
            "flash_attention_backward" + sfx: n_attn} if flash else {
        "lru_scan": 2 * n_rec, "lru_scan_backward": n_rec}
    want = {k: want.get(k, 0) for k in per}
    check(per == want, f"{label} launches a step {per}: want {want} (remat "
          f"full runs each forward twice)")
    check(kept == {dtype}, f"{label}: parameters stored in {kept}")
    return dict(dtype=str(dtype).removeprefix("torch."), arch=arch,
                impl=impl, batch=batch, seq=seq,
                step_s=step_s, steps_s=times, warmup_s=warm_s,
                tokens_per_s=tok_s, losses=losses, grad_norms=norms,
                first_loss=first_loss,
                peak_device_gb=peak_gb, launches=launches,
                launches_per_step=per, idle_share=idle,
                profiled_wall_s=wall_s, device_busy_s=busy,
                kernels_in_step=n_kernels, params=n_params, init_s=init_s,
                top_kernels=kernels[:8], naive=beside)


def train_launcher_phase(torch, mod):
    """``python -m repro_torch.launch.train`` as a user runs it on the
    card: reduced recurrentgemma-2b, 24 steps (a checkpoint at step 20 and
    at the last), killed at step 21 (``--fail-at``), then run again to
    resume from step 20; its
    final loss must equal an uninterrupted run's bit for bit, and the two
    runs' checkpoints the same weights.  Then ``python -m
    repro_torch.launch.serve --ckpt`` serves the resumed run's
    checkpoint: its tokens must be an engine's on those weights, whose
    logits equal the uninterrupted run's model's."""
    import tempfile

    import numpy as np
    T_, cfgs, conv = mod("models.transformer"), mod("configs"), \
        mod("convert")
    ckpt, step_mod = mod("checkpoint.ckpt"), mod("train.step")
    cfg = cfgs.reduced_config(cfgs.get_config(TRAIN_ARCH))
    dev = torch.device("cuda")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                TRAIN_ARCH, "--reduced", "--steps", "24", "--device", "cuda"]
        finals = {}
        for key, ckdir, extra in (("killed", "a", ["--fail-at", "21"]),
                                  ("resumed", "a", []),
                                  ("uninterrupted", "b", [])):
            cmd = base + ["--ckpt", os.path.join(tmp, ckdir)] + extra
            t = time.perf_counter()
            r = run_alone(cmd)
            s = time.perf_counter() - t
            lines = r.stdout.strip().splitlines()
            final = [ln for ln in lines if ln.startswith("final loss:")]
            said = [ln for ln in lines if ln.startswith(
                ("[trainer] resumed", "final loss"))]
            if key == "killed" and r.stderr.strip():
                said.append(r.stderr.strip().splitlines()[-1])
            print(f"[main] train launcher {key}: {' '.join(cmd[1:])}: exit "
                  f"{r.returncode} in {s:.1f} s; " + "; ".join(said),
                  flush=True)
            if key == "killed":
                check(r.returncode != 0 and "simulated node failure at step "
                      "21" in r.stderr, f"train launcher --fail-at 21: exit "
                      f"{r.returncode}: {r.stderr[-2000:]}")
                check(ckpt.latest_step(os.path.join(tmp, "a")) == 20,
                      "the killed run's newest checkpoint is step 20")
            else:
                check(r.returncode == 0 and len(final) == 1,
                      f"train launcher {key} exit {r.returncode}: "
                      f"{r.stderr[-2000:]}")
                finals[key] = final[0].split("(")[1].rstrip(")")
            if key == "resumed":
                check("[trainer] resumed from step 20" in lines,
                      "the second run resumed from step 20")
            out[key] = dict(returncode=r.returncode, wall_s=s)
        same = finals["resumed"] == finals["uninterrupted"]
        print(f"[check] train launcher resume: final loss {finals['resumed']}"
              f" vs uninterrupted {finals['uninterrupted']}: equal {same}",
              flush=True)
        check(same, "resumed final loss differs from the uninterrupted run's")

        def restored(ckdir):
            state = step_mod.train_state(T_.init_lm(
                cfg, torch.Generator(device=dev).manual_seed(9), device=dev))
            tree = ckpt.restore(os.path.join(tmp, ckdir),
                                like=conv.train_state_to_jax(state, cfg))
            return conv.train_state_from_jax(tree, cfg, state).params
        resumed_model, ref_model = restored("a"), restored("b")
        same_w = all(torch.equal(p, q) for p, q in zip(
            resumed_model.parameters(), ref_model.parameters()))
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               TRAIN_ARCH, "--reduced", "--ckpt", os.path.join(tmp, "a"),
               "--device", "cuda"]
        t = time.perf_counter()
        r = run_alone(cmd)
        s = time.perf_counter() - t
    check(r.returncode == 0 and "restored params from" in r.stdout,
          f"serve --ckpt exit {r.returncode}: {r.stderr[-2000:]}")
    served = np.array([json.loads(ln.split(":", 1)[1]) for ln in
                       r.stdout.splitlines() if ln.startswith("seq ")])
    # the launcher's prompt: its generator's draws after init_lm
    gen = torch.Generator(device=dev).manual_seed(0)
    T_.init_lm(cfg, gen, device=dev)
    prompt = torch.randint(0, cfg.vocab, (2, 16), generator=gen, device=dev)
    # the launcher serves in float32, as JAX's does
    run = T_.RunCfg(dtype=torch.float32)
    with torch.inference_mode():
        want = mod("serve.engine").LMEngine(
            resumed_model, cfg, run, batch=2, max_len=24).generate(
                prompt.cpu().numpy(), 8)
        la, _ = T_.prefill(resumed_model, {"tokens": prompt}, cfg, run)
        lb, _ = T_.prefill(ref_model, {"tokens": prompt}, cfg, run)
    same_logits = bool(torch.equal(la, lb))
    same_tokens = served.shape == want.shape and bool((served == want).all())
    print(f"[main] serve --ckpt: {' '.join(cmd[1:])}: exit {r.returncode} in "
          f"{s:.1f} s; served tokens equal an engine's on the restored "
          f"weights {same_tokens}; resumed and uninterrupted checkpoints: "
          f"weights equal {same_w}, prefill logits equal {same_logits}",
          flush=True)
    check(same_w and same_logits and same_tokens, "serve --ckpt vs the "
          "trained model")
    out["serve"] = dict(returncode=r.returncode, wall_s=s,
                        final_loss=finals["resumed"])
    return out

# ---------------------------------------------------------------------- #
# the mesh slice on one card: a world-1 process group in this process
# (NCCL for CUDA tensors, gloo for host ones) and a 1 x 1 rank mesh
# ---------------------------------------------------------------------- #
# moe_dispatch with capacity E / top_k (nothing dropped) against
# moe_dense's last logits, relative to their max |logit|: CONSIST_TOL
# (1e-3) taken at dbrx-132b's max |logit| on the card, 3.928, where the
# prefill/decode check of the same 3 layers (float32 sums in other
# orders) reads 1.08e-4 (PERF.md section 2)
DISPATCH_REL_TOL = 2.5e-4


def rank_mesh_1x1(torch, mod):
    """Start a world-1 process group in this process (``launch/mesh.py``'s
    ``init_ranks``: NCCL for the card's tensors, gloo for the host's,
    over a ``file://`` store in a fresh temporary directory) and return
    the rules of a 1 x 1 rank mesh over it and the directory (removed by
    the caller once the group is destroyed)."""
    import tempfile
    M = mod("launch.mesh")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    M.init_ranks("cuda", rank=0, world_size=1,
                 init_method="file://" + os.path.join(tmp, "store"))
    return (M.mesh_rules(M.make_rank_mesh((1, 1), ("data", "model"),
                                          "cuda")), tmp)


def dispatch_drops(torch, routes, cfg, tokens):
    """Each layer's dropped share of its (token, expert) slots at the
    config's capacity, from its top-k expert sets (``capture_routes``):
    an expert chosen by more than C of the local tokens drops the rest."""
    import math
    e = cfg.moe
    C = min(math.ceil(e.capacity_factor * tokens * e.top_k / e.num_experts),
            tokens)
    out = []
    for r in routes:
        counts = torch.bincount(r.reshape(-1), minlength=e.num_experts)
        out.append(float((counts - C).clamp_min(0).sum())
                   / (tokens * e.top_k))
    return C, out


def moe_dispatch_phase(torch, np, mod, all_launches, rules, model, cfg,
                       prompt, prompt_len, n_new, batch, dense):
    """dbrx-132b through ``moe_dispatch`` on the 1 x 1 mesh, on the
    weights the dense serve built (``lm_phase``'s ``then``): first the
    prefill at capacity ``E / top_k``, where nothing drops, against the
    dense prefill's last logits (``[check]``, ``DISPATCH_REL_TOL``
    relative); then the serve through ``LMEngine(rules=)`` at the
    config's capacity 1.25 (batch, prompt and new tokens the dense
    serve's), the flash launches counted from 0, each layer's dropped
    share of (token, expert) slots in the prefill, and a profiled
    prefill and decode (``[main] ... serve dispatch``), dense's times
    beside it.  prefill(T) + decode and prefill(T + 1) drop different
    tokens at capacity 1.25, so no consistency hold is made there."""
    t0 = time.perf_counter()
    T_, L = mod("models.transformer"), mod("models.layers")
    FL = mod("kernels.flash_attention")
    e = cfg.moe
    run = T_.RunCfg(impl="flash", dtype=torch.float32, moe_impl="dispatch")
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        e, capacity_factor=e.num_experts / e.top_k))
    feed = lambda n: {"tokens": prompt[:, :n]}
    ((last, cache), routes), chk_s = wall(torch, lambda: capture_routes(
        L, lambda: T_.prefill(model, feed(prompt_len), nodrop, run,
                              max_len=prompt_len, rules=rules)))
    del cache
    _, nodrop_drops = dispatch_drops(torch, routes, nodrop,
                                     batch * prompt_len)
    want = dense["last_logits"].to(last.device)
    d = float((last - want).abs().max())
    top = float(want.abs().max())
    tol = DISPATCH_REL_TOL * top
    finite = bool(torch.isfinite(last).all())
    print(f"[check] {cfg.name} dispatch vs dense (1 x 1 mesh, capacity "
          f"factor {nodrop.moe.capacity_factor:g}: dropped shares "
          f"{nodrop_drops}): prefill {prompt_len} in {chk_s:.3f} s, last "
          f"logits max |d| {d:.3e} (tol {tol:.3e} = {DISPATCH_REL_TOL} x "
          f"max |logit| {top:.3f}), finite {finite}", flush=True)
    check(finite and d <= tol and not any(nodrop_drops),
          f"{cfg.name} dispatch vs dense: {d} > {tol} or drops "
          f"{nodrop_drops}")
    del last, want

    eng = mod("serve.engine").LMEngine(model, cfg, run, batch=batch,
                                       max_len=prompt_len + n_new,
                                       rules=rules)
    prompt_np = prompt[:, :prompt_len].cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(all_launches)
    (out, routes), gen_s = wall(torch, lambda: capture_routes(
        L, lambda: eng.generate(prompt_np, n_new)))
    launches = {"flash_attention": FL.LAUNCHES["flash_attention"]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tm = eng.timings
    C, drops = dispatch_drops(torch, routes[:cfg.n_layers], cfg,
                              batch * prompt_len)
    _, dec_drops = dispatch_drops(torch, routes[cfg.n_layers:], cfg, batch)
    decode_ms = tm["decode_s"] / tm["decode_steps"] * 1e3
    print(f"[main] {cfg.name} serve dispatch (1 x 1 mesh; {cfg.n_layers} "
          f"layers): batch {batch}, prompt {prompt_len}, {n_new} new tokens "
          f"in {gen_s:.3f} s: prefill {tm['prefill_s']:.3f} s (dense "
          f"{dense['prefill_s']:.3f} s), decode {decode_ms:.3f} ms/token "
          f"(dense {dense['decode_ms']:.3f}); capacity {C} of "
          f"{batch * prompt_len} tokens an expert (factor "
          f"{e.capacity_factor:g}); dropped share of (token, expert) slots "
          f"a prefill layer {[round(x, 5) for x in drops]}, in decode "
          f"{max(dec_drops) if dec_drops else 0.0}; launches "
          f"{json.dumps(launches)}; peak device memory {peak_gb:.3f} GB",
          flush=True)
    n_attn = sum(cfg.block_kind(i) in ("attn", "local")
                 for i in range(cfg.n_layers))
    check(launches == {"flash_attention": n_attn},
          f"{cfg.name} dispatch launches {launches}: want {n_attn} (one "
          "prefill, none in decode)")
    check(out.shape == (batch, n_new) and (out >= 0).all()
          and (out < cfg.vocab).all(), f"{cfg.name} dispatch tokens")
    check(len(routes) == cfg.n_layers * (n_new + 1),
          f"{cfg.name}: {len(routes)} routed MoE calls")
    check(peak_gb < 80.0, f"{cfg.name} dispatch peak memory {peak_gb} GB")
    prof = lm_profile(torch, T_, model, cfg, run, feed, prompt_len, tm,
                      rules=rules)
    return dict(check_max_abs=d, check_tol=tol, check_prefill_s=chk_s,
                nodrop_capacity_factor=nodrop.moe.capacity_factor,
                tokens=out.tolist(), prefill_s=tm["prefill_s"],
                decode_ms_per_token=decode_ms, generate_s=gen_s,
                capacity=C, dropped_share=drops, decode_dropped_share=dec_drops,
                launches=launches, peak_device_gb=peak_gb, profile=prof,
                dense_prefill_s=dense["prefill_s"],
                dense_decode_ms_per_token=dense["decode_ms"],
                phase_s=time.perf_counter() - t0)


def mesh_train_phase(torch, mod, all_launches, rules):
    """One ``make_train_step`` step of qwen3-0.6b at its published width
    and depth through flash (batch 2 x 4096, remat full, AdamW's
    defaults) without rules and with the 1 x 1 mesh's, from the same
    weights (seed 0) and batch: the loss, the gradient norm, every
    gradient and every updated parameter bit-equal (a one-rank
    ``all_reduce`` and a weight of one change no bit), the flash
    launches of the mesh step counted."""
    cfgs, data = mod("configs"), mod("data.pipeline")
    T_, opt, step_mod = (mod("models.transformer"), mod("optim.adamw"),
                         mod("train.step"))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = cfgs.get_config(FLASH_TRAIN_ARCH)
    run = T_.RunCfg(impl="flash", remat="full", dtype=torch.float32)
    src = data.SyntheticSource(cfg.vocab, FLASH_TRAIN_BATCH, FLASH_TRAIN_SEQ)
    batch = data.to_device(src.batch(0), dev)
    out, keep = {}, {}
    for label, r in (("plain", None), ("mesh", rules)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = step_mod.init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        step = step_mod.make_train_step(cfg, run, opt.AdamWConfig(), r)
        zero_counts(all_launches)
        (state, m), t = wall(torch, lambda: step(state, batch))
        rec = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   step_s=t, launches=kernel_counts(mod),
                   peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
        named = dict(state.params.named_parameters())
        if label == "plain":
            keep = {n: (p.detach().clone(), p.grad.clone())
                    for n, p in named.items()}
            keep["loss"], keep["norm"] = m["loss"], m["grad_norm"]
        else:
            diff = [n for n, p in named.items()
                    if not (torch.equal(p, keep[n][0])
                            and torch.equal(p.grad, keep[n][1]))]
            rec["bit_equal"] = (not diff and torch.equal(m["loss"],
                                                         keep["loss"])
                                and torch.equal(m["grad_norm"],
                                                keep["norm"]))
            rec["differing_leaves"] = diff[:8]
        out[label] = rec
        del state, step, named, m
    keep.clear()
    torch.cuda.empty_cache()
    mesh = out["mesh"]
    launches = {k: v for k, v in mesh["launches"].items() if v}
    print(f"[main] {FLASH_TRAIN_ARCH} train flash on the 1 x 1 mesh: one "
          f"step of batch {FLASH_TRAIN_BATCH} x {FLASH_TRAIN_SEQ}, "
          f"{mesh['step_s']:.3f} s (without rules {out['plain']['step_s']:.3f}"
          f" s), loss {mesh['loss']!r}, grad_norm {mesh['grad_norm']!r}; "
          f"loss, grad_norm, every gradient and parameter bit-equal to the "
          f"step without rules: {mesh['bit_equal']}"
          + (f" (differing: {mesh['differing_leaves']})"
             if not mesh["bit_equal"] else "")
          + f"; launches {json.dumps(launches)}; peak device memory "
          f"{mesh['peak_device_gb']:.3f} GB", flush=True)
    check(mesh["bit_equal"], "the 1 x 1 mesh step differs from the step "
          f"without rules: {mesh['differing_leaves']}")
    n_attn = cfg.n_layers
    check(launches == {"flash_attention": 2 * n_attn,
                       "flash_attention_backward": n_attn},
          f"mesh step launches {launches}")
    return out


def compressed_psum_check(torch, mod, rules):
    """``compressed_psum`` over the world-1 group on the card's tensors
    against the same call on host copies (gloo): the reduced gradients
    and residuals of two calls (the residual fed back), bit for bit
    (elementwise IEEE operations and a max)."""
    C = mod("optim.compression")
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = {"w": torch.randn(4096, 1024, generator=gen, device="cuda"),
         "b": torch.randn(1000, generator=gen, device="cuda") * 1e-3}

    def twice(grads):
        red, ef = C.compressed_psum(grads, None, rules.mesh, rules.dp)
        red2, ef2 = C.compressed_psum(grads, ef, rules.mesh, rules.dp)
        return [red, ef.residual, red2, ef2.residual]
    card = twice(g)
    host = twice({k: v.cpu() for k, v in g.items()})
    gap = max(float((a[k].cpu() - b[k]).abs().max())
              for a, b in zip(card, host) for k in a)
    equal = all(torch.equal(a[k].cpu(), b[k])
                for a, b in zip(card, host) for k in a)
    err = max(float((card[0][k] - g[k]).abs().max() / g[k].abs().max())
              for k in g)
    print(f"[check] compressed_psum over the world-1 group (NCCL) vs host "
          f"(gloo): two calls, reduced gradients and residuals bit-equal "
          f"{equal} (max |d| {gap:.3e}); the int8 round trip's max error "
          f"{err:.3e} of max |g|", flush=True)
    check(equal, f"compressed_psum card vs host: max |d| {gap}")
    return dict(bit_equal=equal, max_abs=gap, roundtrip_rel=err)


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    mod = lambda name: importlib.import_module("repro_torch." + name)
    api, build = mod("api"), mod("kernels._build")
    B, RS, R = mod("kernels.binomial_step"), mod("kernels.rz_step"), mod("core.rz")
    ops, notc, cfgs = mod("kernels.ops"), mod("core.notc"), mod("configs.pricing")
    import numpy as np

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave no output"
    print(f"[device] {torch.cuda.get_device_name(0)} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)

    # each phase's wall time, printed as it ends ([time] lines)
    laps, t_lap = {}, [t_start]

    def lap(label):
        now = time.perf_counter()
        laps[label] = now - t_lap[0]
        t_lap[0] = now
        print(f"[time] {label}: {laps[label]:.1f} s", flush=True)

    # 1. build
    t = time.perf_counter()
    names = ["binomial_step", "rz_step", "lru_scan", "flash_attention",
             "flash_attention_bf16", "flash_attention_bwd",
             "flash_attention_bwd_bf16"]
    logs = build.build_all(names)
    print(f"[build] nvcc x{len(names)} in parallel: "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for name in names:
        print_ptxas(name, logs[name])
    lap("build")

    put_cfg, notc_cfg = cfgs.PAPER_PUT, cfgs.PAPER_NOTC
    capacity = put_cfg.capacity
    tc_grid, cb_grid, notc_grid = pricing_grids(api, cfgs, np)
    check(tc_grid.n_scenarios == put_cfg.contracts == 256, "TC grid size")
    check(cb_grid.n_scenarios == 256, "call/bull grid size")
    check(notc_grid.n_scenarios == notc_cfg.contracts == 256, "grid size")

    # 2. each kernel against its plain version on the card
    lat = lattice_phase(torch, B, notc_cfg)
    rz = rz_phase(torch, R, RS, mod("core.partition"), tc_grid, cb_grid,
                  capacity)
    contracts = mod("kernels.contracts").CONTRACTS
    k32 = float32_kernel_phase(torch, np, B, RS, R, mod("core.distributed"),
                               mod("core.pwl"), contracts, tc_grid, notc_cfg,
                               put_cfg)
    fmirror = flash_mirror_phase(torch, np, mod("kernels.flash_attention"),
                                 contracts)
    fbf16 = flash_bf16_phase(torch, np, mod("kernels.flash_attention"))
    lap("kernel holds")

    # 3. the main path, through the public API with the default backend
    zero_counts((B.LAUNCHES, RS.LAUNCHES))
    torch.cuda.reset_peak_memory_stats()
    tc, tc_s = wall(torch, lambda: api.price_grid(tc_grid, capacity=capacity))
    cb, cb_s = wall(torch, lambda: api.price_grid(cb_grid, capacity=capacity))
    nt, nt_s = wall(torch, lambda: api.price_grid(
        notc_grid, levels=notc_cfg.round_depth, block=256))
    model = mod("core.lattice").LatticeModel(
        s0=notc_cfg.s0, sigma=notc_cfg.sigma, rate=notc_cfg.rate,
        maturity=notc_cfg.maturity, n_steps=notc_cfg.n_steps)
    one, one_s = wall(torch, lambda: ops.price_notc_kernel(
        model, notc_cfg.strike, levels=notc_cfg.round_depth,
        dtype=torch.float64))
    launches = {"lattice_round_param": B.LAUNCHES["lattice_round_param"],
                "lattice_round": B.LAUNCHES["lattice_round"],
                "rz_round": RS.LAUNCHES["rz_round"]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[main] TC grid: {tc_grid.n_scenarios} contracts N={tc_grid.n_steps}"
          f" K={capacity}: {tc_s:.3f} s, max_pieces={tc.max_pieces}",
          flush=True)
    print(f"[main] call/bull-spread grid: {cb_grid.n_scenarios} contracts "
          f"N={cb_grid.n_steps} K={capacity}: {cb_s:.3f} s, max_pieces="
          f"{cb.max_pieces}, mean row_pieces {cb.row_pieces.mean():.3f}",
          flush=True)
    print(f"[main] no-TC grid: {notc_grid.n_scenarios} contracts "
          f"N={notc_grid.n_steps}: {nt_s:.3f} s", flush=True)
    print(f"[main] price_notc_kernel N={model.n_steps}: {one:.10f} in "
          f"{one_s:.3f} s", flush=True)
    print(f"[main] launches {json.dumps(launches)}; peak device memory "
          f"{peak_gb:.3f} GB (torch.cuda.max_memory_allocated)", flush=True)
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    for label, res, grid in (("TC", tc, tc_grid), ("call/bull", cb, cb_grid)):
        check(np.isfinite(res.ask).all() and np.isfinite(res.bid).all(),
              f"{label} finite")
        check(res.ask.shape == grid.shape, f"{label} shape")
        check((res.ask >= res.bid - 1e-12).all(), f"{label} ask >= bid")
        check(res.max_pieces <= capacity,
              f"{label} max_pieces {res.max_pieces} > K")
    check(np.isfinite(nt.ask).all() and (nt.ask >= 0).all(), "no-TC prices")

    # the plain level walk as second opinion on a subset of each grid
    idx = np.arange(0, 256, 32)

    def subset(g):
        f = g.flat()
        return api.ScenarioGrid.explicit(
            s0=f.s0[idx], sigma=f.sigma[idx], rate=f.rate[idx],
            maturity=f.maturity[idx], cost_rate=f.cost_rate[idx],
            payoff=tuple(f.payoff[i] for i in idx), strike=f.strike[idx],
            strike2=f.strike2[idx], n_steps=f.n_steps)
    plain = api.ExecutionConfig(backend="torch")
    for label, res, grid in (("TC", tc, tc_grid), ("call/bull", cb, cb_grid)):
        sub, sub_s = wall(torch, lambda: api.price_grid(
            subset(grid), capacity=capacity, execution=plain))
        d = max(np.abs(sub.ask - res.ask.ravel()[idx]).max(),
                np.abs(sub.bid - res.bid.ravel()[idx]).max())
        same = bool((sub.row_pieces == res.row_pieces.ravel()[idx]).all())
        print(f"[check] plain walk on {len(idx)} {label} contracts "
              f"({sub_s:.1f} s): max |d| {d:.3e}, equal row_pieces {same}, "
              f"row_pieces {sub.row_pieces.tolist()}", flush=True)
        check(d <= TOL and same, f"{label} grid vs plain walk")
    nts, nts_s = wall(torch, lambda: api.price_grid(
        subset(notc_grid), execution=plain))
    d_nt = np.abs(nts.ask - nt.ask.ravel()[idx]).max()
    print(f"[check] plain walk on {len(idx)} no-TC contracts ({nts_s:.1f} s):"
          f" max |d| {d_nt:.3e}", flush=True)
    check(d_nt <= TOL, "no-TC grid vs plain walk")
    # small inputs against the numpy oracle (and k = 0 collapses to it)
    pay = mod("core.payoff")
    small = mod("core.lattice").LatticeModel(
        s0=100.0, sigma=0.3, rate=0.06, maturity=1.0, n_steps=200)
    want = notc.price_notc_np(small, pay.american_put(100.0))
    got_k = ops.price_notc_kernel(small, 100.0, levels=50,
                                  dtype=torch.float64)
    got_rz = R.price_rz(small, pay.american_put(100.0), capacity=16)
    d_or = max(abs(got_k - want), abs(got_rz.ask - want), abs(got_rz.bid - want))
    print(f"[check] N=200 put vs numpy oracle: max |d| {d_or:.3e}", flush=True)
    check(d_or <= TOL, "numpy oracle")
    # how a call's knot count grows with N, and the paper's bull spread at
    # its depth, through the kernels at capacity 128 (ROADMAP Queue C)
    grown = {}
    for label, kw, steps in (
            ("call s0=K=100 k=0.01", dict(payoff="call", strike=100.0,
                                          cost_rate=0.01),
             (40, 80, 100, 150, 200)),
            ("PAPER_BULL", dict(payoff="bull_spread",
                                strike=cfgs.PAPER_BULL.strike,
                                cost_rate=cfgs.PAPER_BULL.cost_rate),
             (cfgs.PAPER_BULL.n_steps,))):
        for n in steps:
            g = api.ScenarioGrid.cartesian(s0=100.0, n_steps=n, **kw)
            try:
                grown[f"{label} N={n}"] = api.price_grid(
                    g, capacity=128).max_pieces
            except OverflowError as exc:
                grown[f"{label} N={n}"] = str(exc).split(";")[0]
    print(f"[knots] max_pieces at capacity 128: {json.dumps(grown)}",
          flush=True)
    # the float32 main paths (each with its launches counted from 0)
    main32 = float32_main_phase(torch, np, mod, cfgs, ops, R, tc_grid, tc, one,
                                (B.LAUNCHES, RS.LAUNCHES))
    lap("pricing grids")

    # the LSMC engine's main lines, the sharded layouts and the launcher
    pricing_launches = (B.LAUNCHES, RS.LAUNCHES)
    lsmc = lsmc_phase(torch, np, api, pricing_launches)
    layout = layout_phase(torch, np, api, tc_grid, notc_grid, notc_cfg,
                          capacity, pricing_launches)
    node = node_axis_phase(torch, np, mod, cfgs, pricing_launches)
    launcher = launcher_phase()
    lap("LSMC, layouts, node axis, launcher")
    serving = serving_phase(torch, np, mod, cfgs, pricing_launches)
    serve_launcher = serve_launcher_phase()
    lap("pricing service")

    # 4. the language models' serve paths at full width
    FL, LS = mod("kernels.flash_attention"), mod("kernels.lru_scan")
    all_launches = (B.LAUNCHES, RS.LAUNCHES, FL.LAUNCHES, LS.LAUNCHES)
    lm_kern, lm_launches, lm = lm_phase(
        torch, np, mod, all_launches, LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW,
        lambda seen: rg_kernel_phase(torch, np, FL, LS, seen))
    launches.update(lm_launches)
    mamba_kern, mamba_launches, mamba = lm_phase(
        torch, np, mod, all_launches, *MAMBA_SERVE,
        lambda seen: {"lru_scan": lru_hold(torch, LS, seen, MAMBA_SERVE[0]
                                           + " ")})
    gqa_kern, gqa_launches, gqa = lm_phase(
        torch, np, mod, all_launches, *GQA_SERVE,
        lambda seen: {"flash_attention": flash_hold(torch, np, FL, seen,
                                                    GQA_SERVE[0] + " ")})
    # the MoE archs (causal attention at G = 6 and G = 5) and the
    # encoder-decoder arch (its encoder's bidirectional attention, the
    # decoder's causal self attention and its cross attention, T != S)
    # dbrx-132b also through moe_dispatch on a 1 x 1 rank mesh (a world-1
    # process group in this process), on the dense serve's weights
    t_mesh = time.perf_counter()
    rules, ranks_tmp = rank_mesh_1x1(torch, mod)
    mesh_s = time.perf_counter() - t_mesh
    more = []
    for arch, b, p, n, layers in MOE_SERVES:
        then = None
        if arch == DISPATCH_ARCH:
            then = (lambda model, cfg, prompt, dense, b=b, p=p, n=n:
                    moe_dispatch_phase(torch, np, mod, all_launches, rules,
                                       model, cfg, prompt, p, n, b, dense))
        more.append((arch,) + lm_phase(
            torch, np, mod, all_launches, arch, b, p, n,
            lambda seen, arch=arch: {"flash_attention": flash_hold(
                torch, np, FL, seen, arch + " ")}, n_layers=layers,
            then=then))
    arch, b, p, n, frames = ENCDEC_SERVE
    more.append((arch,) + lm_phase(
        torch, np, mod, all_launches, arch, b, p, n,
        lambda seen: {kind: flash_hold(torch, np, FL, seen,
                                       f"{arch} {label} ", kind)
                      for kind, label in (
                          ("flash_attention.bidirectional", "encoder"),
                          ("flash_attention", "self"),
                          ("flash_attention.cross", "cross"))},
        enc_frames=frames))

    # the bfloat16 serves (chameleon-34b and qwen2.5-14b's first on the
    # card), qwen3-4b beside its float32 serve
    lap("float32 LM serves")
    bf16 = bf16_serve_phase(torch, np, mod, all_launches, gqa)
    # the bfloat16 kernel at recurrentgemma-2b's and seamless-m4t-medium's
    # main-path shapes, on their bfloat16 prefills' inputs
    bf16_pre = bf16_prefill_phase(torch, np, mod, all_launches)
    lap("bfloat16 LM serves")

    # 5. training: the scan's backward kernel, a reduced step card vs CPU,
    # the full-width step, the launchers' restart and serve --ckpt; the
    # same in bfloat16 with a float32 master
    lru_train = lru_backward_phase(torch, LS)
    train_chk = train_check_phase(torch, mod)
    train_main = train_main_phase(torch, mod, all_launches)
    train_chk_bf16 = train_check_bf16_phase(torch, mod)
    train_bf16 = train_main_phase(torch, mod, all_launches,
                                  dtype=torch.bfloat16)
    train_launch = train_launcher_phase(torch, mod)
    lap("recurrentgemma-2b training")
    # 6. training through flash_attention's backward kernel: the kernel
    # against its plain version, a reduced qwen3-0.6b step (head dim 16)
    # card vs CPU, the full-width step in float32 and bfloat16 beside
    # impl="naive"; then serve --reduced on the card (the padded instance)
    fbwd = flash_backward_phase(torch, np, FL)
    lap("flash backward holds")
    train_chk_flash = train_check_phase(torch, mod, FLASH_TRAIN_ARCH, "flash")
    flash_train = dict(arch=FLASH_TRAIN_ARCH, impl="flash",
                       batch=FLASH_TRAIN_BATCH, seq=FLASH_TRAIN_SEQ)
    train_flash = train_main_phase(torch, mod, all_launches, **flash_train)
    train_chk_flash_bf16 = train_check_bf16_phase(torch, mod,
                                                  FLASH_TRAIN_ARCH, "flash")
    train_flash_bf16 = train_main_phase(torch, mod, all_launches,
                                        dtype=torch.bfloat16, **flash_train)
    lap("qwen3-0.6b training through flash")
    # the mesh slice: the 1 x 1 mesh train step bit-equal to the step
    # without rules, compressed_psum card vs host
    mesh_train = mesh_train_phase(torch, mod, all_launches, rules)
    mesh_compress = compressed_psum_check(torch, mod, rules)
    import shutil
    import torch.distributed as dist
    dist.destroy_process_group()
    shutil.rmtree(ranks_tmp, ignore_errors=True)
    dispatch = next(rec["then"] for arch, _, _, rec in more
                    if arch == DISPATCH_ARCH)
    lap("mesh train step and compressed_psum")
    mesh_s += dispatch["phase_s"] + laps["mesh train step and compressed_psum"]
    print(f"[time] mesh slice in all: {mesh_s:.1f} s (the group, the dbrx "
          "dispatch phase, the train step and compressed_psum)", flush=True)
    serve_red = serve_reduced_phase(torch, np, mod)
    lap("serve --reduced")
    for rec in [lm, mamba, gqa] + [r for *_, r in more] + [
            r for _, _, r in bf16.values()]:
        rec.pop("last_logits")

    src = "src/repro_torch/csrc/"
    kernels = []
    for name, rec, source, replaces in (
            ("lattice_round_param", lat["lattice_round_param"],
             src + "binomial_step.cu", "src/repro/kernels/binomial_step.py:87"),
            ("lattice_round", lat["lattice_round"], src + "binomial_step.cu",
             "src/repro/kernels/binomial_step.py:67"),
            ("rz_round", rz["single-block"], src + "rz_step.cu",
             "src/repro/kernels/rz_step.py:72")):
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=rec["max_abs_err"],
            ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=None,
            node_axis_launches=sum(v["launches"].get(name, 0)
                                   for k, v in node.items()
                                   if k.startswith(("TC put", "no-TC"))),
            lane0_hold=node.get(f"{name} lane0"),
            bound_note=("counted: the float64 operations of the kernel's "
                        "device functions (rz_step_ops) at each live "
                        "lane-level, with the lanes' input and output knot "
                        "counts, over 34 TFLOP/s" if name == "rz_round" else
                        "5 float64 operations per node and active level, the "
                        "intrinsic once per distinct spot (exp as one), "
                        "over 34 TFLOP/s")))
    # the float32 instances: lattice_round_param has no float32 main path
    # (the grids compute in float64 in both packages), so no launches
    tc32 = next((v for k, v in main32.items()
                 if k.startswith("TC put K=") and v["fits"]),
                main32[f"TC put K={capacity}"])
    f32_paths = (
        ("lattice_round_param", "lattice_round_param", 0, None,
         "none: the no-TC grid computes in float64 in both packages; held "
         "at its shape"),
        ("lattice_round", "lattice_round",
         main32["price_notc_kernel"]["launches"].get("lattice_round.float32",
                                                     0),
         "lattice_round.float32",
         "price_notc_kernel float32 (PAPER_NOTC's put, the policy default "
         "on the card)"),
        ("rz_round", "rz_round",
         tc32["launches"].get("rz_round.float32", 0), "rz_round.float32",
         "float32 TC put (rz_backward_kernel, dtype=float32)"))
    for name, key, n32, lkey, path in f32_paths:
        rec = k32[key]
        kernels.append(dict(
            name=f"{name}.float32", route="cuda",
            source=contracts[name].source, replaces=contracts[name].replaces,
            launches=n32, max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=None, main_path=path,
            node_axis_launches=sum(v["launches"].get(lkey, 0)
                                   for k, v in main32.items()
                                   if k.startswith("node axis"))
            if lkey else 0,
            lane0_hold=k32.get(f"{name} lane0"),
            tolerance=contracts[name].tolerance(torch.float32),
            bound_note="the float64 line's count over float32's 67 TFLOP/s "
                       "outside the tensor cores, 4-byte values"))
    notes = {
        "lru_scan": ("src/repro/kernels/lru_scan.py:31",
                     "12 bytes per element (a, b read, h written) over "
                     "3.35 TB/s"),
        "flash_attention": ("src/repro/kernels/flash_attention.py:29",
                            "split TF32: 3 TF32 MMAs of 4*hd operations per "
                            "live (query, key) pair over 495 TFLOP/s "
                            "(ffma_bound_ms: the same pairs' 4*hd float32 "
                            "operations over 67 TFLOP/s)")}
    # one entry a kernel and a main path that runs it: the earlier entries
    # keep their names, this slice's carry the arch's
    # (an encoder-decoder path's entries carry the call's kind after the
    # arch: flash_attention.<arch>.bidirectional, ....cross)
    for path, recs, path_launches in (
            (LM_ARCH, lm_kern, lm_launches),
            (MAMBA_SERVE[0], mamba_kern, mamba_launches),
            (GQA_SERVE[0], gqa_kern, gqa_launches)) + tuple(
                (arch, recs, calls) for arch, recs, calls, _ in more):
        for name, rec in recs.items():
            base, _, kind = name.partition(".")
            replaces, note = notes[base]
            kernels.append(dict(
                name=name if path == LM_ARCH else
                f"{base}.{path}" + (f".{kind}" if kind else ""),
                route="cuda", source=src + base + ".cu", replaces=replaces,
                launches=path_launches[name], max_abs_err=rec["max_abs_err"],
                ms=rec["ms"], plain_ms=rec["plain_ms"],
                bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
                library_ms=rec["library_ms"], main_path=f"{path} serve",
                bound_note=note, **({"ffma_bound_ms": rec["ffma_bound_ms"]}
                                    if "ffma_bound_ms" in rec else {})))
    # the training path's entries: the backward kernel (no TPU kernel
    # stands behind it: JAX differentiates _linear_scan_chunked) and the
    # forward at the training shape, each with the full-width run's
    # launches (TRAIN_STEPS steps); the bfloat16 train step runs the same
    # float32 scans (entries with ".bfloat16-train")
    for name, rec, n, tag in (
            ("lru_scan_backward", lru_train["lru_scan_backward"],
             train_main["launches"]["lru_scan_backward"], ""),
            (f"lru_scan.{TRAIN_ARCH}-train", lru_train["lru_scan.train"],
             train_main["launches"]["lru_scan"], ""),
            ("lru_scan_backward.bfloat16-train",
             lru_train["lru_scan_backward"],
             train_bf16["launches"]["lru_scan_backward"], " bfloat16"),
            (f"lru_scan.{TRAIN_ARCH}-train.bfloat16",
             lru_train["lru_scan.train"], train_bf16["launches"]["lru_scan"],
             " bfloat16")):
        kernels.append(dict(
            name=name, route="cuda", source=src + "lru_scan.cu",
            replaces="src/repro/kernels/lru_scan.py:31", launches=n,
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=None,
            main_path=f"{TRAIN_ARCH} train{tag} ({TRAIN_STEPS} steps, remat "
                      "full)",
            bound_note=("20 bytes an element (a, dh_seq, h_{t-1} read, da, "
                        "db written) and the (B, W) rows over 3.35 TB/s"
                        if name.startswith("lru_scan_backward")
                        else notes["lru_scan"][1]),
            **({"replaces_note": "no TPU kernel: the gradient of "
                "_lru_kernel's recurrence, which JAX takes by autodiff of "
                "src/repro/models/layers.py:475 (_linear_scan_chunked)"}
               if name.startswith("lru_scan_backward") else {})))
    # the bfloat16 instance on each bfloat16 serve's path
    for i, (arch, (recs, calls, _)) in enumerate(bf16.items()):
        rec = recs["flash_attention"]
        kernels.append(dict(
            name="flash_attention.bfloat16" + (f".{arch}" if i else ""),
            route="cuda", source=src + "flash_attention_bf16.cu",
            replaces=notes["flash_attention"][0],
            launches=calls["flash_attention"], max_abs_err=rec["max_abs_err"],
            ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            main_path=f"{arch} serve bfloat16",
            mirror_max_abs=rec["mirror_max_abs"],
            mirror_of_bound=rec["mirror_of_bound"],
            bound_share=rec["bound_share"],
            bound_note="4*hd operations per live (query, key) pair, one "
                       "bfloat16 MMA each, over 989 TFLOP/s"))
    for arch, (recs, _, calls) in bf16_pre.items():
        for kind, rec in recs.items():
            kernels.append(dict(
                name=f"flash_attention.bfloat16.{arch}"
                + kind.removeprefix("flash_attention"),
                route="cuda", source=src + "flash_attention_bf16.cu",
                replaces=notes["flash_attention"][0], launches=calls[kind],
                max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                bound_by=rec["bound_by"], library_ms=rec["library_ms"],
                main_path=f"{arch} prefill bfloat16",
                mirror_max_abs=rec["mirror_max_abs"],
                mirror_of_bound=rec["mirror_of_bound"],
                bound_share=rec["bound_share"],
                bound_note="4*hd operations per live (query, key) pair, one "
                           "bfloat16 MMA each, over 989 TFLOP/s"))
    # the training path through flash: the backward kernel (no TPU kernel
    # stands behind it: JAX differentiates _attn_flash) and the forward at
    # the training shape, each with the full-width run's launches
    # (TRAIN_STEPS steps); times at the slice's shape
    for sfx, rec_d, run_rec in (("", fbwd["float32"], train_flash),
                                (".bfloat16", fbwd["bfloat16"],
                                 train_flash_bf16)):
        rec = rec_d[FLASH_BWD_MAIN[0][0]]
        main_path = (f"{FLASH_TRAIN_ARCH} train flash"
                     f"{' bfloat16' if sfx else ''} ({TRAIN_STEPS} steps, "
                     "remat full)")
        kernels.append(dict(
            name="flash_attention_backward" + sfx, route="cuda",
            source=src + ("flash_attention_bwd_bf16.cu" if sfx else
                          "flash_attention_bwd.cu"),
            replaces=notes["flash_attention"][0],
            launches=run_rec["launches"]["flash_attention_backward" + sfx],
            max_abs_err=rec["max_abs_err"], max_rel_err=rec["max_rel_err"],
            ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            bound_share=rec["bound_share"], main_path=main_path,
            walks=rec["walks"],
            other_shapes={k: {x: v[x] for x in ("ms", "bound_ms",
                                                "library_ms", "max_rel_err",
                                                "walks")}
                          for k, v in rec_d.items()
                          if k not in ("small", FLASH_BWD_MAIN[0][0])},
            replaces_note="no TPU kernel: the gradient of _fa_kernel's "
                          "attention, which JAX takes by autodiff of "
                          "src/repro/models/layers.py:142 (_attn_flash)",
            bound_note="10*hd operations per live (query, key) pair (S "
                       "again, dP, dV, dK, dQ), " + (
                           "one bfloat16 MMA each, over 989 TFLOP/s" if sfx
                           else "three TF32 MMAs each, over 495 TFLOP/s")))
        fwd = rec["forward"]
        kernels.append(dict(
            name=f"flash_attention{sfx}.{FLASH_TRAIN_ARCH}-train",
            route="cuda", source=src + ("flash_attention_bf16.cu" if sfx
                                        else "flash_attention.cu"),
            replaces=notes["flash_attention"][0],
            launches=run_rec["launches"]["flash_attention" + sfx],
            max_abs_err=fwd["max_abs_err"],
            ms=fwd["ms"], plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
            bound_by=fwd["bound_by"], library_ms=fwd["library_ms"],
            bound_share=fwd["bound_share"], main_path=main_path,
            bound_note="4*hd operations per live pair, with lse written"))
    # the mesh slice's paths: dbrx-132b's serve through moe_dispatch (the
    # float32 kernel held at dbrx's prefill shape above) and the 1 x 1
    # mesh train step (the kernels held at the training shape above)
    dbrx_flash = next(recs["flash_attention"] for arch, recs, _, _ in more
                      if arch == DISPATCH_ARCH)
    fbwd_main = fbwd["float32"][FLASH_BWD_MAIN[0][0]]
    for name, rec, n, source, path in (
            (f"flash_attention.{DISPATCH_ARCH}.dispatch", dbrx_flash,
             dispatch["launches"]["flash_attention"], "flash_attention.cu",
             f"{DISPATCH_ARCH} serve dispatch (1 x 1 mesh)"),
            (f"flash_attention.{FLASH_TRAIN_ARCH}-train.mesh",
             fbwd_main["forward"],
             mesh_train["mesh"]["launches"]["flash_attention"],
             "flash_attention.cu", f"{FLASH_TRAIN_ARCH} train flash on the "
             "1 x 1 mesh (one step, remat full)"),
            ("flash_attention_backward.mesh", fbwd_main,
             mesh_train["mesh"]["launches"]["flash_attention_backward"],
             "flash_attention_bwd.cu", f"{FLASH_TRAIN_ARCH} train flash on "
             "the 1 x 1 mesh (one step, remat full)")):
        kernels.append(dict(
            name=name, route="cuda", source=src + source,
            replaces=notes["flash_attention"][0], launches=n,
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            main_path=path, bound_note="the same kernel and shape as the "
            "entry of its path without the mesh"))
    summary = dict(card=card, build_ok=True,
                   tc_grid_s=tc_s, cb_grid_s=cb_s, notc_grid_s=nt_s,
                   notc_one_s=one_s, peak_device_gb=peak_gb,
                   lattice_round_call_x256=lat["lattice_round call x256"],
                   lattice_edges={k: v for k, v in lat.items()
                                  if k.startswith("edge")},
                   rz_deep=rz["single-block-deep"],
                   rz_call_bull_deep=rz["call-bull-deep"], rz_halo=rz["halo"],
                   rz_edges={k: v for k, v in rz.items()
                             if k.startswith("edge")},
                   rz_capacity=rz["capacity"], float32_kernels=k32,
                   float32_main=main32, flash_mirror=fmirror,
                   lsmc=lsmc, layout=layout,
                   node_axis=node,
                   launcher=launcher, serving=serving,
                   serve_launcher=serve_launcher, lm=lm, lm_kernels=lm_kern,
                   lm_mamba=mamba, lm_mamba_kernels=mamba_kern, lm_gqa=gqa,
                   lm_gqa_kernels=gqa_kern,
                   lm_more={arch: dict(serve=rec, kernels=recs)
                            for arch, recs, _, rec in more},
                   train_kernels=lru_train, train_check=train_chk,
                   train=train_main, train_launcher=train_launch,
                   flash_bf16=fbf16,
                   lm_bf16={arch: dict(serve=rec, kernels=recs)
                            for arch, (recs, _, rec) in bf16.items()},
                   lm_bf16_prefill={arch: dict(kernels=recs, launches=n,
                                               calls=calls)
                                    for arch, (recs, n, calls)
                                    in bf16_pre.items()},
                   train_check_bf16=train_chk_bf16, train_bf16=train_bf16,
                   flash_backward=fbwd, train_check_flash=train_chk_flash,
                   train_flash=train_flash,
                   train_check_flash_bf16=train_chk_flash_bf16,
                   train_flash_bf16=train_flash_bf16,
                   mesh=dict(dispatch=dispatch, train=mesh_train,
                             compressed_psum=mesh_compress,
                             total_s=mesh_s),
                   serve_reduced=serve_red)
    # 5. no process the script started outlives it: the gateways closed
    # their workers; the helper process spawning them started goes too
    mod("serve.procpool").stop_spawn_helper()
    left = processes(parent=os.getpid())
    print(f"[procs] child processes left: {left or 'none'}", flush=True)
    check(not left, f"child processes left: {left}")
    summary["total_s"] = time.perf_counter() - t_start
    summary["phase_s"] = laps
    print(f"[time] smoke total {summary['total_s']:.1f} s", flush=True)
    print("[summary] " + json.dumps(summary), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        rc = 1
    finally:
        stop_children()
    sys.exit(rc)
