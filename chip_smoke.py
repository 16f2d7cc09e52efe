#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``src/repro_torch/csrc`` (one ``nvcc`` per
source, started together), holds each kernel against its plain PyTorch
version on the card at the main path's shapes (float64, max abs
difference <= 1e-9 and identical knot counts), then drives the port's
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
oracle, and prints how a call's knot count grows with N.  The line before the last is a JSON object with each kernel's
times and bound; the last line is ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
TOL = 1e-9

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
FP64_OPS_PER_S = 34e12       # H100 SXM float64 outside the tensor cores
# float64 operations one PWL lane-level step does per knot of its state:
# two envelopes (merge with evaluations, crossings, compaction) and one
# cone (suffix/prefix minima, crossings, an envelope).  An estimate from
# the algorithm in csrc/rz_step.cu, not a count of its instructions, so
# rz_round's bound is marked as an estimate in the kernels line.
RZ_OPS_PER_KNOT = 300
# float64 operations per node and level of the lattice step, counted from
# csrc/binomial_step.cu (the exp counted as one)
LATTICE_OPS = {"param": 22, "put": 14, "call": 14}
CB_STEPS = 120    # depth of the call/bull-spread grid


class SmokeError(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeError(what)


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


def lattice_phase(torch, B, paper_notc):
    """lattice_round_param and lattice_round vs their plain version at the
    no-TC main path's shapes (P=40192 lanes, levels=50, block=256):
    lattice_round_param on the grid's 256 rows, lattice_round on the one
    row of the single-contract price; lattice_round also on 256 rows of
    calls, a check off the main path."""
    dev = torch.device("cuda")
    block, levels = 256, paper_notc.round_depth
    P = -(-(paper_notc.n_steps + 1) // block) * block
    g = torch.Generator(device=dev).manual_seed(0)
    v = torch.rand(256, P, generator=g, dtype=torch.float64, device=dev) * 30
    u = torch.rand(256, generator=g, dtype=torch.float64, device=dev)
    fam = torch.tensor([[1.0, -1.0, 0.0, 0.0], [-1.0, 1.0, 0.0, 0.0]],
                       dtype=torch.float64, device=dev)[torch.arange(256) % 2]
    k = 90.0 + 20.0 * u
    sc = torch.stack([torch.full_like(u, float(paper_notc.n_steps)),
                      0.5 + 0.01 * u, torch.full_like(u, 0.99998),
                      80.0 + 40.0 * u, torch.full_like(u, 0.0026),
                      *fam.T, k, k], dim=1).contiguous()
    sc6 = sc[:, [0, 1, 2, 9, 3, 4]].contiguous()
    out = {}
    for label, fn, kind, s_all, rows in (
            ("lattice_round_param", B.lattice_round_param, "param", sc, 256),
            ("lattice_round", B.lattice_round, "put", sc6, 1),
            ("lattice_round call x256", B.lattice_round, "call", sc6, 256)):
        x, s = v[:rows].contiguous(), s_all[:rows].contiguous()
        kw = {} if kind == "param" else {"kind": kind}
        got = fn(x, s, levels=levels, block=block, **kw)
        want = B.lattice_round_plain(x, s, levels=levels, block=block,
                                     kind=kind)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= TOL, f"{label}: kernel vs plain max abs err {err}")
        ms = cuda_ms(torch, lambda: fn(x, s, levels=levels, block=block,
                                       **kw), 20)
        plain_ms = cuda_ms(torch, lambda: B.lattice_round_plain(
            x, s, levels=levels, block=block, kind=kind), 3)
        nbytes = 2 * x.numel() * 8 + s.numel() * 8
        t_ops = rows * P * levels * LATTICE_OPS[kind] / FP64_OPS_PER_S
        t_bytes = nbytes / HBM_BYTES_PER_S
        bound = max(t_ops, t_bytes) * 1e3
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound,
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations",
                          shape=[rows, P], levels=levels, block=block)
        print(f"[kernel] {label}: rows={rows} P={P} levels={levels} "
              f"block={block} max_abs_err={err:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f}", flush=True)
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


def rz_phase(torch, R, RS, P, tc_grid, cb_grid, capacity):
    """rz_round vs its plain version at the TC main path's shapes, all 256
    contracts of a grid per launch: the put grid's first (widest)
    single-block round at its leaf state, a later single-block round
    whose lanes carry the walk's knots, and a late round of the
    call/bull-spread grid, whose lanes carry tens of knots; and a
    16-contract multi-block halo round, a check off the main path."""
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
        got, pieces = RS.rz_round(z, sc, levels=levels, block=blk)
        (want, wpieces), plain_ms = timed_once(torch, lambda: RS.rz_round_plain(
            z, sc, levels=levels, block=blk))
        err = max_pwl_err(got, want)
        same_m = bool(torch.equal(got.m, want.m))
        same_p = bool(torch.equal(pieces, wpieces))
        check(err <= TOL and same_m and same_p,
              f"rz_round {label}: max abs err {err}, equal m {same_m}, "
              f"equal pieces {same_p}")
        ms = cuda_ms(torch, lambda: RS.rz_round(z, sc, levels=levels,
                                                block=blk), 3)
        # work: live lane-levels of the round times the knots they carry,
        # taken as the mean of the live lanes' counts before and after it
        live = sum(max(0, min(lanes, lvl0 + 1 - j))
                   for j in range(1, levels + 1))
        knots = 0.5 * float(z.m[..., :min(lanes, lvl0 + 1)].double().mean()
                            + got.m[..., :lvl0 - levels + 1].double().mean())
        ops = rows * 2 * live * RZ_OPS_PER_KNOT * knots
        rec = 2 * capacity * 8 + 8 + 8 + 4
        nbytes = 2 * rows * 2 * lanes * rec + sc.numel() * 8
        t_ops, t_bytes = ops / FP64_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=max(t_ops, t_bytes) * 1e3,
                          bound_by="operations" if t_ops >= t_bytes
                          else "bytes", rows=rows, lanes=lanes, block=blk,
                          levels=levels, mean_knots=knots,
                          pieces=int(pieces.max()))
        print(f"[kernel] rz_round {label}: rows={rows} N={n} lvl0={lvl0} "
              f"lanes={lanes} block={blk} levels={levels} K={capacity} "
              f"max_abs_err={err:.3e} equal_m={same_m} "
              f"pieces={int(pieces.max())} mean_knots={knots:.3f} "
              f"ms={ms:.3f} plain_ms={plain_ms:.3f} "
              f"bound_ms={max(t_ops, t_bytes) * 1e3:.4f}", flush=True)
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
    build.build_all(["binomial_step", "rz_step"])
    print(f"[build] nvcc x2 in parallel: {time.perf_counter() - t:.1f} s",
          flush=True)

    put_cfg, notc_cfg = cfgs.PAPER_PUT, cfgs.PAPER_NOTC
    capacity = put_cfg.capacity
    # the TC main grid: 256 of the paper's American puts at its depth
    # (the paper's bull spread needs more than 128 knots at N=1500: see
    # the [knots] line)
    tc_grid = api.ScenarioGrid.cartesian(
        s0=tuple(np.linspace(90.0, 110.0, 32)), sigma=put_cfg.sigma,
        rate=put_cfg.rate, maturity=put_cfg.maturity,
        cost_rate=(0.005, 0.01), payoff=put_cfg.payoff,
        strike=(95.0, 100.0, 105.0, 110.0), n_steps=put_cfg.n_steps)
    # calls and bull spreads at full width and capacity, cut in depth
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
    check(tc_grid.n_scenarios == put_cfg.contracts == 256, "TC grid size")
    check(cb_grid.n_scenarios == 256, "call/bull grid size")
    check(notc_grid.n_scenarios == notc_cfg.contracts == 256, "grid size")

    # 2. each kernel against its plain version on the card
    lat = lattice_phase(torch, B, notc_cfg)
    rz = rz_phase(torch, R, RS, mod("core.partition"), tc_grid, cb_grid,
                  capacity)

    # 3. the main path, through the public API with the default backend
    for counts in (B.LAUNCHES, RS.LAUNCHES):
        for key in counts:
            counts[key] = 0
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
            bound_note=("estimate: 300 float64 operations per knot per "
                        "live lane-level" if name == "rz_round" else
                        "counted from the source, the exp as one operation")))
    summary = dict(card=card, build_ok=True,
                   tc_grid_s=tc_s, cb_grid_s=cb_s, notc_grid_s=nt_s,
                   notc_one_s=one_s, peak_device_gb=peak_gb,
                   lattice_round_call_x256=lat["lattice_round call x256"],
                   rz_deep=rz["single-block-deep"],
                   rz_call_bull_deep=rz["call-bull-deep"], rz_halo=rz["halo"])
    print("[summary] " + json.dumps(summary), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
