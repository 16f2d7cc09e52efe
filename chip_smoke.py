#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``src/repro_torch/csrc`` (one ``nvcc`` per
source, started together), holds each kernel against its plain PyTorch
version on the card at the main path's shapes (float64: the lattice
kernel bit for bit, also on edge cases at small rows; ``rz_round`` to
1e-9 with identical knot counts, also on edge cases of its tile
schedule, with its widest round timed at capacities 16, 48 and 128),
then drives the port's
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
oracle, and prints how a call's knot count grows with N.

Then the LSMC engine (``engine="lsmc"``, plain PyTorch: no TPU kernel
stands behind it): the two grids of Longstaff & Schwartz (2001) Table 1
(American puts, 100,000 antithetic paths, Laguerre degree 3, T=1 at N=50
and T=2 at N=100) and 64 Bermudan basket puts of 5 assets, each timed
after a warm-up with its peak device memory, and each held against the
same rows priced on the host (``[check] LSMC ... card vs host``: the
host's generator draws other normals, so within 4 combined standard
errors); the estimator within 3
standard errors of the lattice kernel's price (``[check] LSMC vs
lattice``); the TC put, no-TC and LSMC grids (and the LSMC grid padded)
under ``devices=1``, ``devices=4`` (simulated on one card) and
``mesh=(cuda:0,) * 4`` (the real per-shard dispatch), held bit for bit
(``[check] layout``, with each layout's kernel launches counted from 0);
and ``python -m repro_torch.launch.price --grid --engine lsmc --devices
4`` as a subprocess (``[main] launcher``).

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
TF32 is switched off for matrix products and cuDNN before the LM runs,
so every product compared is full float32.

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
# the flash kernel's split TF32: three TF32 MMAs a float32 product
SPLIT_TF32_MMAS = 3
# float64 operations the lattice round needs: 5 per node and level (p*up,
# q*v, their sum, *inv_r, the max), and the intrinsic once per distinct
# spot j = 2i - lvl, counted from the expression of each kind (the exp as
# one): s0 * exp(j * sig) and the payoff with its clamp
LATTICE_STEP_OPS = 5
LATTICE_INTRINSIC_OPS = {"param": 15, "put": 5, "call": 5}
CB_STEPS = 120    # depth of the call/bull-spread grid
# the LM serve: recurrentgemma-2b at full width
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "recurrentgemma-2b", 4, 4096, 32
# flash against its plain version: the bound JAX's own flash is held to.
# lru_scan rounds as its plain version does (no fused multiply-add) and
# is held to equality, within the float32 contract's 2e-6.
FLASH_TOL = 2e-5
# prefill(T) + decode(T) against prefill(T + 1), last logits: float32
# through 26 layers, sums of up to 7680 terms in other orders (flash
# kernel against naive decode attention, cuBLAS at other shapes)
CONSIST_TOL = 1e-3
# lru_scan's edge shapes (B, T, W): a ragged last ring chunk, T shorter
# than a chunk, W not a multiple of a warp's 32 channels nor 16-byte
# aligned, one batch row
LRU_EDGES = ((1, 300, 2560), (2, 20, 77), (1, 1, 33))
# flash_attention beyond the prefill's instance (hd 256, causal, window):
# (label, B, T = S, H, KVH, hd, causal, window)
FLASH_EXTRA = (("hd128", 2, 1000, 8, 2, 128, True, None),
               ("bidirectional", 1, 1000, 10, 1, 256, False, None))
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
            # the kernel's name and template arguments out of the mangled one
            k = re.search(r"([a-z][a-z_]*_kernel)(?:ILi(\d+)E(?:Lb(\d)E)?)?",
                          m.group(1))
            args = [] if k is None else [x for x in k.groups()[1:] if x]
            if len(args) == 2:
                args[1] = "true" if args[1] == "1" else "false"
            entry = (m.group(1) if k is None else
                     k.group(1) + (f"<{', '.join(args)}>" if args else ""))
            facts = []
        elif entry and ("Used" in ln or "spill" in ln):
            facts.append(ln.split(":", 1)[-1].strip())


def lattice_bound(torch, x, s, kind, levels):
    """Least time for one round on these inputs: 5 float64 operations per
    node and active level, the intrinsic once per distinct spot j (about
    2 (P + levels) a row), against each lane read and written once."""
    rows, P = x.shape
    active = torch.clamp(torch.floor(s[:, 0]), 0, levels)
    ops = float((P * active * LATTICE_STEP_OPS
                 + torch.where(active > 0, 2 * (P + active) - 3, 0)
                 * LATTICE_INTRINSIC_OPS[kind]).sum())
    t_ops = ops / FP64_OPS_PER_S
    t_bytes = (2 * x.numel() + s.numel()) * 8 / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def lattice_inputs(torch, dev, rows, P, lvl0, kind):
    """Seeded node values in [0, 30) and round scalars for ``rows`` rows
    of ``P`` lanes (puts and calls of the 4-parameter family alternating;
    the 6 put/call scalars for ``kind`` other than "param"); ``lvl0`` is
    one level or one per row."""
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


def rz_state(torch, R, grid, capacity, rows, lanes):
    """The main TC grid's leaf state over ``lanes`` lanes for its first
    ``rows`` contracts, and their round scalars."""
    dev = torch.device("cuda")
    col = lambda a: torch.as_tensor(a[:rows], dtype=torch.float64, device=dev)
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


def rz_bound(torch, z, got, sc, levels, K):
    """Least time for one rz_round on these inputs: rz_step_ops at each
    live lane-level of the owned lanes, with each lane's input counts
    (its own and its right neighbour's) and its output count, over the
    float64 rate; against each input's valid knots read once (with its
    sl, sr and m) and each output record written once, over the memory
    rate.  Returns (ms, "operations" or "bytes", operations, bytes)."""
    R, S, lanes = z.m.shape
    mi = z.m.double()
    mu = torch.cat([mi[..., 1:], mi[..., -1:]], dim=-1)
    mo = got.m.double()
    g = torch.arange(lanes, dtype=torch.float64, device=mi.device)
    live = torch.clamp(torch.floor(sc[:, 0, None] - g), 0, levels)[:, None]
    ops = float((live * rz_step_ops(torch, mu, mi, mo)).sum())
    nbytes = float(16 * mi.sum() + 20 * mi.numel()
                   + (16 * K + 20) * mo.numel() + 8 * sc.numel())
    t_ops, t_bytes = ops / FP64_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def rz_hold(torch, RS, label, z, sc, levels, block):
    """rz_round against its plain version: max abs error <= 1e-9 and
    equal knot counts and raw counts.  Returns the kernel's result, the
    plain version's time and the error."""
    got, pieces = RS.rz_round(z, sc, levels=levels, block=block)
    (want, wpieces), plain_ms = timed_once(torch, lambda: RS.rz_round_plain(
        z, sc, levels=levels, block=block))
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


def capture_kernel_inputs(ops, fn):
    """Run ``fn()`` and keep copies of the first inputs that
    ``ops.flash_attention`` and ``ops.lru_scan`` receive in it."""
    seen = {}
    orig = {name: getattr(ops, name) for name in ("flash_attention",
                                                   "lru_scan")}

    def wrap(name):
        def call(*args, **kw):
            if name not in seen:
                seen[name] = ([a.clone() for a in args], dict(kw))
            return orig[name](*args, **kw)
        return call
    for name in orig:
        setattr(ops, name, wrap(name))
    try:
        out = fn()
    finally:
        for name, f in orig.items():
            setattr(ops, name, f)
    return out, seen


def lm_kernel_phase(torch, np, FL, LS, seen):
    """lru_scan and flash_attention vs their plain versions on the inputs
    the full-width prefill gave them (lru_scan also on slow-decay inputs
    of the same shape); SDPA with the same mask as the attention kernel's
    yardstick."""
    import torch.nn.functional as F
    out = {}
    (a, b, h0), _ = seen["lru_scan"]
    # the captured a is about exp(-16): h_t is b_t to within an ulp, so a
    # kernel that dropped the carry would pass on them.  Slow decay, as
    # trained RG-LRU gates have, makes the carry dominate.
    g = torch.Generator(device=a.device).manual_seed(7)
    slow = (0.9 + 0.1 * torch.rand(a.shape, generator=g, device=a.device),
            torch.randn(a.shape, generator=g, device=a.device),
            torch.randn(h0.shape, generator=g, device=a.device))
    errs = {}
    for label, xs in (("prefill inputs", (a, b, h0)), ("slow decay", slow)):
        got = LS.lru_scan(*xs)
        want = LS.lru_scan_plain(*xs)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, want))
        errs[label] = max(float((x - y).abs().max()) for x, y in zip(got, want))
        carry = float((want[0] - xs[1]).abs().max())
        print(f"[kernel] lru_scan {label}: equal to plain {same}, max abs "
              f"err {errs[label]:.3e}, max |h_t - b_t| {carry:.3e}", flush=True)
        check(same, f"lru_scan {label}: kernel differs from plain "
              f"(max abs err {errs[label]})")
    del slow, got, want
    for Bx, Tx, Wx in LRU_EDGES:
        xs = (torch.rand(Bx, Tx, Wx, generator=g, device=a.device),
              torch.randn(Bx, Tx, Wx, generator=g, device=a.device),
              torch.randn(Bx, Wx, generator=g, device=a.device))
        got, want = LS.lru_scan(*xs), LS.lru_scan_plain(*xs)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, want))
        label = f"edge B={Bx} T={Tx} W={Wx}"
        errs[label] = max(float((x - y).abs().max())
                          for x, y in zip(got, want))
        print(f"[kernel] lru_scan {label}: equal to plain {same}", flush=True)
        check(same, f"lru_scan {label}: kernel differs from plain")
    err = max(errs.values())
    ms = cuda_ms(torch, lambda: LS.lru_scan(a, b, h0), 20)
    plain_ms = cuda_ms(torch, lambda: LS.lru_scan_plain(a, b, h0), 2)
    n = a.numel()
    t_bytes = (3 * n + 2 * h0.numel()) * 4 / HBM_BYTES_PER_S
    t_ops = 2 * n / FP32_OPS_PER_S
    out["lru_scan"] = dict(max_abs_err=err, errs=errs, ms=ms,
                           plain_ms=plain_ms,
                           bound_ms=max(t_ops, t_bytes) * 1e3,
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations", library_ms=None,
                           shape=list(a.shape))
    print(f"[kernel] lru_scan: a,b {tuple(a.shape)} max_abs_err={err:.3e} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={out['lru_scan']['bound_ms']:.4f}", flush=True)

    (q, k, v), kw = seen["flash_attention"]
    B, T, H, hd = q.shape
    S = k.shape[1]
    got = FL.flash_attention(q, k, v, **kw)
    want = FL.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= FLASH_TOL, f"flash_attention: kernel vs plain max abs err "
          f"{err}")
    ms = cuda_ms(torch, lambda: FL.flash_attention(q, k, v, **kw), 5)
    plain_ms = cuda_ms(torch, lambda: FL.flash_attention_plain(q, k, v, **kw),
                       2)
    # the library's attention on the same inputs, heads first, the KV head
    # repeated for every query head, the same causal-window mask
    qs = q.transpose(1, 2)
    ks = k.transpose(1, 2).expand(B, H, S, hd).contiguous()
    vs = v.transpose(1, 2).expand(B, H, S, hd).contiguous()
    pos_q = torch.arange(T, device=q.device)[:, None]
    pos_k = torch.arange(S, device=q.device)[None, :]
    mask = pos_q >= pos_k if kw["causal"] else torch.ones_like(pos_q >= pos_k)
    if kw["window"] is not None:
        mask &= pos_q - pos_k < kw["window"]
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    lib_err = float((sdpa().transpose(1, 2) - got).abs().max())
    lib_ms = cuda_ms(torch, sdpa, 5)
    del ks, vs
    pairs = live_pairs(np, T, S, kw["causal"], kw["window"]) * B * H
    # the kernel's products: 3 TF32 MMAs (split TF32) of 4*hd operations a
    # live pair; the FFMA bound of the same pairs beside it
    t_ops = SPLIT_TF32_MMAS * 4 * hd * pairs / TF32_OPS_PER_S
    t_ffma = 4 * hd * pairs / FP32_OPS_PER_S
    t_bytes = 2 * (q.numel() + k.numel()) * 4 / HBM_BYTES_PER_S
    out["flash_attention"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes) * 1e3, ffma_bound_ms=t_ffma * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=lib_ms, library_max_abs_diff=lib_err, live_pairs=pairs,
        q_shape=list(q.shape), kv_shape=list(k.shape), window=kw["window"])
    print(f"[kernel] flash_attention: q {tuple(q.shape)} k,v {tuple(k.shape)} "
          f"window={kw['window']} live_pairs={pairs} max_abs_err={err:.3e} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={out['flash_attention']['bound_ms']:.4f} (split TF32 "
          f"on the tensor cores) ffma_bound_ms={t_ffma * 1e3:.4f} "
          f"sdpa_ms={lib_ms:.4f} (sdpa vs kernel {lib_err:.3e})", flush=True)
    del q, k, v, got, want
    extra = out["flash_attention"]["extra"] = {}
    g = torch.Generator(device=a.device).manual_seed(11)
    for label, Bx, Tx, Hx, KVHx, hdx, causal, window in FLASH_EXTRA:
        qx = torch.randn(Bx, Tx, Hx, hdx, generator=g, device=a.device)
        kx = torch.randn(Bx, Tx, KVHx, hdx, generator=g, device=a.device)
        vx = torch.randn(Bx, Tx, KVHx, hdx, generator=g, device=a.device)
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


def lm_profile(torch, T_, model, cfg, run, prompt, timings, n_dec=4):
    """Where a full-width prefill and ``n_dec`` decode steps spend device
    time, and the device's idle share: 1 - device busy time over the
    host-clock time of the same profiled window.  The tracing slows the
    host, so the share is an upper bound on the unprofiled serve's; that
    serve's own host-clock time is printed beside it."""
    state = {}

    def do_prefill():
        state["last"], state["cache"] = T_.prefill(
            model, {"tokens": prompt[:, :LM_PROMPT]}, cfg, run,
            max_len=LM_PROMPT + n_dec)

    def do_decode():
        tok = torch.argmax(state["last"], dim=-1)[:, None]
        for i in range(n_dec):
            logits, _ = T_.decode_step(model, state["cache"], tok,
                                       LM_PROMPT + i, cfg, run)
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
        print(f"[profile] {label} (per {'step' if steps > 1 else 'call'}): "
              f"{n_kernels / steps:.0f} kernels, device busy "
              f"{busy_s * 1e3:.3f} ms of {profiled_s * 1e3:.3f} ms under the "
              f"profiler (idle share "
              f"{'not measured' if idle is None else f'{idle:.3f}'}; "
              f"unprofiled serve {unprofiled_s * 1e3:.3f} ms); "
              f"top kernels: {share}", flush=True)
    return out


def lm_phase(torch, np, mod, all_launches):
    """recurrentgemma-2b at full width: the prefill/decode consistency
    check (capturing the kernels' inputs), each kernel against its plain
    version, then the serve through ``LMEngine.generate``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    T_, cfgs, ops = mod("models.transformer"), mod("configs"), \
        mod("kernels.ops")
    FL, LS = mod("kernels.flash_attention"), mod("kernels.lru_scan")
    dev = torch.device("cuda")
    cfg = cfgs.get_config(LM_ARCH)
    run = T_.RunCfg(impl="flash")
    gen = torch.Generator(device=dev).manual_seed(0)
    model, init_s = wall(torch, lambda: T_.init_lm(cfg, gen, device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT + 1),
                           generator=gen, device=dev)
    print(f"[lm] {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} parameters ({n_params * 4 / 1e9:.3f} GB float32), "
          f"initialised on the card in {init_s:.2f} s", flush=True)

    # prefill(T) + decode(T) against prefill(T + 1): 4097 rows leave the
    # kernel's last 64-row tile ragged
    ((last, cache), seen), pre_s = wall(torch, lambda: capture_kernel_inputs(
        ops, lambda: T_.prefill(model, {"tokens": prompt[:, :LM_PROMPT]}, cfg,
                                run, max_len=LM_PROMPT + 1)))
    dec, _ = T_.decode_step(model, cache, prompt[:, LM_PROMPT:], LM_PROMPT,
                            cfg, run)
    del cache
    full, full_s = wall(torch, lambda: T_.prefill(model, {"tokens": prompt},
                                                  cfg, run)[0])
    d = float((dec[:, 0] - full).abs().max())
    finite = bool(torch.isfinite(full).all() and torch.isfinite(dec).all())
    print(f"[check] {LM_ARCH} prefill {LM_PROMPT} ({pre_s:.3f} s) + decode "
          f"of token {LM_PROMPT} vs prefill {LM_PROMPT + 1} ({full_s:.3f} s):"
          f" max |d| logits {d:.3e} (tol {CONSIST_TOL}), logits "
          f"{tuple(full.shape)} finite {finite}, max |logit| "
          f"{float(full.abs().max()):.3f}", flush=True)
    check(finite and tuple(full.shape) == (LM_BATCH, cfg.vocab),
          "LM logits finite and of shape (B, V)")
    check(d <= CONSIST_TOL, f"prefill/decode consistency {d}")
    del dec, full

    kern = lm_kernel_phase(torch, np, FL, LS, seen)
    del seen

    # the serve, through the engine a user calls
    eng = mod("serve.engine").LMEngine(model, cfg, run, batch=LM_BATCH,
                                       max_len=LM_PROMPT + LM_NEW)
    prompt_np = prompt[:, :LM_PROMPT].cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(all_launches)
    out, gen_s = wall(torch, lambda: eng.generate(prompt_np, LM_NEW))
    launches = {"flash_attention": FL.LAUNCHES["flash_attention"],
                "lru_scan": LS.LAUNCHES["lru_scan"]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tm = eng.timings
    kinds = [cfg.block_kind(i) for i in range(cfg.n_layers)]
    want = {"flash_attention": kinds.count("local"),
            "lru_scan": kinds.count("rglru")}
    decode_ms = tm["decode_s"] / tm["decode_steps"] * 1e3
    tok_s = LM_BATCH * LM_NEW / gen_s
    print(f"[main] {LM_ARCH} serve: batch {LM_BATCH}, prompt {LM_PROMPT}, "
          f"{LM_NEW} new tokens in {gen_s:.3f} s: prefill "
          f"{tm['prefill_s']:.3f} s, decode {decode_ms:.3f} ms/token, "
          f"{tok_s:.2f} tokens/s ({LM_BATCH * LM_NEW} generated), "
          f"{LM_BATCH * (LM_PROMPT + LM_NEW) / gen_s:.1f} prompt+generated "
          f"tokens/s; launches {json.dumps(launches)}; peak device memory "
          f"{peak_gb:.3f} GB", flush=True)
    check(launches == want, f"LM launches {launches}, want {want} (one "
          "prefill, none in decode)")
    check(out.shape == (LM_BATCH, LM_NEW) and (out >= 0).all()
          and (out < cfg.vocab).all(), "generated tokens")
    top2 = torch.topk(last, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1] > CONSIST_TOL).cpu().numpy()
    first = torch.argmax(last, dim=-1).cpu().numpy()
    check((out[sure, 0] == first[sure]).all(),
          "first served token vs the checked prefill's argmax")
    prof = lm_profile(torch, T_, model, cfg, run, prompt, tm)
    return kern, launches, dict(profile=prof,
        params=n_params, init_s=init_s, prefill_s=tm["prefill_s"],
        decode_ms_per_token=decode_ms, tokens_per_s=tok_s, generate_s=gen_s,
        peak_device_gb=peak_gb, consistency_max_abs=d,
        check_prefill_s=pre_s, check_prefill_4097_s=full_s)


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
        # priced on the host (independent draws, so the gap has mean 0 and
        # the two SEs' quadrature sum as its spread)
        host = api.price_grid(grid, execution=dataclasses.replace(
            cfg, device="cpu"))
        spread = np.sqrt(res.stderr ** 2 + host.stderr ** 2)
        gap = np.abs(res.ask - host.ask) / spread
        rec["vs_host_gap_se"] = gap.ravel().tolist()
        print(f"[check] LSMC {label} card vs host: {n} contracts, "
              f"{cfg.n_paths} paths each, max |card - host| = "
              f"{gap.max():.2f} combined SE (limit {LSMC_HOST_SE:g})",
              flush=True)
        check(np.isfinite(host.ask).all() and (gap <= LSMC_HOST_SE).all(),
              f"LSMC {label} card within {LSMC_HOST_SE:g} combined SE of "
              "the host")
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


def launcher_phase():
    """The launcher a user runs, as a subprocess on the card: grid mode,
    the LSMC engine, four shards (simulated on one card)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.price", "--grid",
           "--engine", "lsmc", "--devices", "4", "--n-steps", "50",
           "--paths", "16384", "--exercise-dates", "10,20,30,40,50",
           "--n-assets", "3", "--s0", "90,100,110", "--lambdas", "0,0.01"]
    t = time.perf_counter()
    r = run_alone(cmd)
    s = time.perf_counter() - t
    lines = r.stdout.strip().splitlines()
    mesh = [ln for ln in lines if ln.startswith("[simulated mesh")
            or ln.startswith("[device mesh")]
    print(f"[main] launcher: {' '.join(cmd[1:])}: exit {r.returncode} in "
          f"{s:.1f} s (process start, import and run); "
          f"{mesh[0] if mesh else 'no mesh line'}; "
          f"{lines[-1] if lines else ''}", flush=True)
    check(r.returncode == 0, f"launcher exit {r.returncode}: "
          f"{r.stderr[-2000:]}")
    check(len(mesh) == 1 and sum("se=" in ln for ln in lines) == 6,
          "launcher output: one mesh line and 6 rows with se=")
    return dict(returncode=r.returncode, wall_s=s, mesh_line=mesh[0])


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


def main() -> int:
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

    # 1. build
    t = time.perf_counter()
    names = ["binomial_step", "rz_step", "lru_scan", "flash_attention"]
    logs = build.build_all(names)
    print(f"[build] nvcc x{len(names)} in parallel: "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for name in names:
        print_ptxas(name, logs[name])

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
        model, notc_cfg.strike, levels=notc_cfg.round_depth))
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
    got_k = ops.price_notc_kernel(small, 100.0, levels=50)
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

    # the LSMC engine's main lines, the sharded layouts and the launcher
    pricing_launches = (B.LAUNCHES, RS.LAUNCHES)
    lsmc = lsmc_phase(torch, np, api, pricing_launches)
    layout = layout_phase(torch, np, api, tc_grid, notc_grid, notc_cfg,
                          capacity, pricing_launches)
    launcher = launcher_phase()
    serving = serving_phase(torch, np, mod, cfgs, pricing_launches)
    serve_launcher = serve_launcher_phase()

    # 4. the language model's serve path at full width
    FL, LS = mod("kernels.flash_attention"), mod("kernels.lru_scan")
    lm_kern, lm_launches, lm = lm_phase(
        torch, np, mod, (B.LAUNCHES, RS.LAUNCHES, FL.LAUNCHES, LS.LAUNCHES))
    launches.update(lm_launches)

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
            bound_note=("counted: the float64 operations of the kernel's "
                        "device functions (rz_step_ops) at each live "
                        "lane-level, with the lanes' input and output knot "
                        "counts, over 34 TFLOP/s" if name == "rz_round" else
                        "5 float64 operations per node and active level, the "
                        "intrinsic once per distinct spot (exp as one), "
                        "over 34 TFLOP/s")))
    for name, replaces, note in (
            ("lru_scan", "src/repro/kernels/lru_scan.py:31",
             "12 bytes per element (a, b read, h written) over 3.35 TB/s"),
            ("flash_attention", "src/repro/kernels/flash_attention.py:29",
             "split TF32: 3 TF32 MMAs of 4*hd operations per live (query, "
             "key) pair over 495 TFLOP/s (ffma_bound_ms: the same pairs' "
             "4*hd float32 operations over 67 TFLOP/s)")):
        rec = lm_kern[name]
        kernels.append(dict(
            name=name, route="cuda", source=src + name + ".cu",
            replaces=replaces, launches=launches[name],
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            bound_note=note, **({"ffma_bound_ms": rec["ffma_bound_ms"]}
                                if "ffma_bound_ms" in rec else {})))
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
                   rz_capacity=rz["capacity"], lsmc=lsmc, layout=layout,
                   launcher=launcher, serving=serving,
                   serve_launcher=serve_launcher, lm=lm, lm_kernels=lm_kern)
    # 5. no process the script started outlives it: the gateways closed
    # their workers; the helper process spawning them started goes too
    mod("serve.procpool").stop_spawn_helper()
    left = processes(parent=os.getpid())
    print(f"[procs] child processes left: {left or 'none'}", flush=True)
    check(not left, f"child processes left: {left}")
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
