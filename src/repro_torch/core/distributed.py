"""Sharding over several devices: the scenario axis and the node axis.

The port of the JAX package's ``core/distributed.py``.

**Scenario axis** (``grid_mesh``, ``resolve_grid_mesh``,
``sharded_rows``).  Every row of a flat scenario batch is independent, so
the batch splits over a 1-D "mesh" of devices with no collectives at
all: shard ``d`` prices its slice of rows on ``mesh[d]`` and the results
gather on the host.  The shard assignment itself
(``core/partition.py::plan_shards``) is where the paper's §4.2
re-balancing reappears, at device granularity.  A mesh here is a tuple
of ``torch.device``.  It may repeat a device: ``(cuda:0,) * 4`` runs the
real per-shard dispatch (four slices, four sets of launches) on one
card, as JAX's ``--xla_force_host_platform_device_count`` gives one CPU
four devices.

**Node axis** (``plan_rounds``, ``build_rz_sharded``,
``build_notc_sharded``): the paper's §4 algorithm.  One contract's tree
splits into lane blocks of ``S`` columns over the ``model`` axis of a
2-D :class:`DeviceMesh`; contracts split over ``data``.  The backward
induction runs in rounds of ``L`` levels: every shard first receives
the ``L`` leftmost lanes of its right neighbour (the halo; the last
shard receives shard 0's, which lie beyond the live tree), then steps
its ``[S owned | L halo]`` buffer ``L`` levels, after which its owned
lanes are exact.  Near the root the live tree no longer spans the
shards: at a round known before the walk starts, the shards' lanes
gather on the row's first device, which finishes the tail alone with
the single-device engine's round plan.

JAX runs this as SPMD (``shard_map``, a ``ppermute`` halo, an
``all_gather`` collapse, every shard finishing redundantly).  Here one
controller drives the shards in turn: a halo is a copy into the left
neighbour's buffer, the collapse a gather, and the tail runs once.  A
mesh may repeat a device, so ``(cuda:0,) * W`` runs the real per-shard
launches and halo copies on one card, and the CPU tests run every width
in one process.  Shards on one device run one after another: the
paper's speedup is a claim about processors, which one device cannot
show.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .partition import KernelRound, kernel_round_plan
from .payoff import PayoffProcess, kernel_params
from .rz import _fused_leaf, _root_quote, _sides, rz_level_step_lanes, rz_params
from ..kernels.binomial_step import DEFAULT_BLOCK, lattice_round
from ..kernels.rz_step import rz_round

__all__ = ["GRID_AXIS", "grid_mesh", "resolve_grid_mesh", "sharded_rows",
           "DeviceMesh", "plan_rounds", "build_rz_sharded",
           "build_notc_sharded", "NODE_BACKENDS"]

GRID_AXIS = "scenarios"

Mesh = Tuple[torch.device, ...]


def _visible(kind: str) -> int:
    """Devices of ``kind`` this process sees: the CUDA device count, or
    one CPU."""
    if kind == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 1


def grid_mesh(devices: Optional[int] = None, *, kind: str = "cuda") -> Mesh:
    """1-D mesh over the first ``devices`` devices of ``kind`` (all if
    None); raises when the process sees fewer."""
    seen = _visible(kind)
    w = seen if devices is None else int(devices)
    if w < 1:
        raise ValueError("need devices >= 1")
    if w > seen:
        raise ValueError(
            f"asked for {w} devices but the process sees {seen} of kind "
            f"{kind!r}; pass devices <= the device count, an explicit "
            "mesh=(torch.device, ...), or use the simulated path via "
            "resolve_grid_mesh")
    if kind == "cpu":
        return (torch.device("cpu"),)
    return tuple(torch.device(kind, i) for i in range(w))


def resolve_grid_mesh(devices: Optional[int] = None,
                      mesh: Optional[Sequence] = None, *,
                      kind: str = "cuda"):
    """Normalise the grid engines' ``devices=``/``mesh=`` knobs.

    Returns ``(mesh_or_None, n_shards)``:

    * an explicit ``mesh`` (a flat sequence of devices, all of ``kind``)
      wins, ``n_shards`` = its length;
    * ``devices`` in (None, 0, 1) -> the single-device path;
    * ``devices`` <= the devices of ``kind`` this process sees -> a fresh
      :func:`grid_mesh`;
    * more -> the **simulated** sharded path: no mesh, but the same
      plan/permute/pad layout run on the one device.  Rows are
      independent, so the numbers are bit-equal to a real mesh run.
    """
    if mesh is not None:
        if isinstance(mesh, (str, torch.device)) or not isinstance(
                mesh, Sequence):
            raise TypeError(f"mesh must be a sequence of torch.device, got "
                            f"{type(mesh).__name__}")
        if any(isinstance(d, Sequence) and not isinstance(d, str)
               for d in mesh):
            raise ValueError("grid mesh must be 1-D: a flat sequence of "
                             "devices")
        mesh = tuple(torch.device(d) for d in mesh)
        if not mesh:
            raise ValueError("grid mesh must hold at least one device")
        wrong = [str(d) for d in mesh if d.type != kind]
        if wrong:
            raise ValueError(f"mesh devices {wrong} are not of the "
                             f"requested device type {kind!r}")
        if devices is not None and int(devices) != len(mesh):
            raise ValueError(f"devices={devices} conflicts with the given "
                             f"{len(mesh)}-device mesh; pass one or the "
                             "other")
        return mesh, len(mesh)
    if devices is None or int(devices) <= 1:
        return None, 1
    w = int(devices)
    if w <= _visible(kind):
        return grid_mesh(w, kind=kind), w
    return None, w


def _on(dev: torch.device):
    """Context that makes ``dev`` current, so a kernel launches there."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def sharded_rows(fn: Callable, mesh: Mesh) -> Callable:
    """``fn`` run shard by shard over a 1-D mesh.

    ``fn`` maps equal-length row tensors (and non-tensor extras passed
    through unchanged) to a tuple of equal-length row tensors.  The
    returned function splits every row tensor into ``len(mesh)`` equal
    slices, runs ``fn`` on slice ``d`` with its tensors on
    ``mesh[d]`` (a 2-D column, as LSMC's ``(rows, 2)`` keys, split by
    rows), and gathers each output on the host in mesh order.  Shards are
    dispatched one after another from the calling thread; whether shards
    on distinct cards overlap is not measured.  There are no
    collectives: per-row reductions (``max_pieces``) reduce on the host
    after the gather, so overflow semantics cannot diverge from the
    single-device path.
    """
    def run(*rows):
        n = len(mesh)
        lens = {r.shape[0] for r in rows if isinstance(r, torch.Tensor)}
        if len(lens) != 1 or next(iter(lens)) % n:
            raise ValueError(f"row tensors of lengths {sorted(lens)} do not "
                             f"split evenly over {n} shards")
        lanes = next(iter(lens)) // n
        outs = []
        for d, dev in enumerate(mesh):
            part = []
            for r in rows:
                if isinstance(r, torch.Tensor):
                    r = r[d * lanes:(d + 1) * lanes].to(dev)
                part.append(r)
            with _on(dev):
                outs.append(fn(*part))
        return tuple(torch.cat([o[i].cpu() for o in outs])
                     for i in range(len(outs[0])))
    return run


# --------------------------------------------------------------------- #
# the node axis: one contract's tree over the model axis of a 2-D mesh
# --------------------------------------------------------------------- #
NODE_BACKENDS = ("kernel", "torch")


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """Devices on named axes, JAX's ``Mesh`` for one controller.

    ``devices`` is a nested sequence (or an object array) of devices with
    one dimension per name of ``axis_names``; ``shape[name]`` is the
    length of that axis.  A device may repeat.
    """
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        arr = np.array(self.devices, dtype=object)
        names = tuple(self.axis_names)
        if arr.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"devices of shape {arr.shape} do not fit the "
                             f"axes {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        arr = np.vectorize(torch.device, otypes=[object])(arr)
        object.__setattr__(self, "devices", arr)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def rows(self, data_axes, model_axis: str):
        """The mesh as ``(D, W)`` rows of devices: the data axes flattened
        in order, each row one node-axis group of ``W`` shards."""
        order = tuple(data_axes) + (model_axis,)
        if sorted(order) != sorted(self.axis_names):
            raise ValueError(f"axes {order} must name each mesh axis "
                             f"{self.axis_names} once")
        arr = self.devices.transpose([self.axis_names.index(a)
                                      for a in order])
        return [tuple(r) for r in arr.reshape(-1, arr.shape[-1])]


def plan_rounds(n_steps: int, n_shards: int, round_depth: int,
                collapse_lanes: int | None = None):
    """Static partition of the N+1 backward levels into phase-1 rounds and
    a phase-2 (collapsed) tail.  Returns dict of static ints."""
    total_lanes = n_steps + 2
    shard_lanes = -(-total_lanes // n_shards)          # ceil
    halo = min(round_depth, shard_lanes)               # need halo <= S
    if collapse_lanes is None:
        collapse_lanes = max(shard_lanes, 2 * halo + 2)
    total_levels = n_steps + 1                         # levels N .. 0
    # phase 2 handles levels c-1 .. 0 (c levels); keep c <= collapse_lanes-1
    c_target = min(total_levels, max(collapse_lanes - 1, 1))
    rounds = -(-(total_levels - c_target) // halo) if total_levels > c_target else 0
    c = total_levels - rounds * halo                   # exact tail levels
    phase2_lanes = min(n_shards * shard_lanes, c + 1)  # live width at tail
    return dict(n_shards=n_shards, shard_lanes=shard_lanes, halo=halo,
                rounds=rounds, tail_levels=c, phase2_lanes=max(phase2_lanes, 1),
                total_lanes=n_shards * shard_lanes)


class _Values(NamedTuple):
    """The friction-free state: node values ``(R, lanes)``."""
    v: torch.Tensor

    def map(self, fn) -> "_Values":
        return _Values(fn(self.v))


class _Engine(NamedTuple):
    """What the harness needs of a node state.

    ``prepare(cols)`` -> per-device context from the ``(bc,)`` contract
    columns; ``leaf(ctx, lanes, lane0)`` -> state; ``step(ctx, state,
    lvl0, levels, lane0, owned, block)`` -> ``(state, pieces (bc,) or
    None)``, stepping levels ``lvl0 - 1`` down to ``lvl0 - levels``;
    ``finish(state)`` -> tuple of ``(bc,)`` results.  The lane axis of
    every leaf of a state is ``axis``; ``width(n)`` is the buffer a shard
    of ``n`` owned and halo lanes holds; the tail walks
    ``kernel_round_plan`` with ``tail_block``.
    """
    prepare: Callable
    leaf: Callable
    step: Callable
    finish: Callable
    axis: int
    width: Callable
    tail_block: Optional[int]


def _fit(state, axis: int, lanes: int):
    """The first ``lanes`` lanes of ``state``, zero-padded past its end,
    contiguous."""
    def fit(a):
        have = a.shape[axis]
        if have >= lanes:
            return a.narrow(axis, 0, lanes).contiguous()
        pad = list(a.shape)
        pad[axis] = lanes - have
        return torch.cat([a, a.new_zeros(pad)], dim=axis)
    return state.map(fit)


def _tail_plan(levels: int, block: Optional[int]):
    """Rounds of the tail: the single-device engine's plan from level
    ``levels`` (its ``levels + 1`` live lanes) to the root."""
    if levels < 1:
        return []
    if levels == 1:
        return [KernelRound(lvl0=1, depth=1, lanes=2, block=2)]
    return kernel_round_plan(levels - 1, block=block)


def _run_row(devs, cols: dict, eng: _Engine, plan: dict, n_steps: int):
    """Price one data row's contracts with the tree over ``devs``.

    Phase 1: round ``r`` steps levels ``n_steps - r H`` down to ``n_steps
    - r H - H + 1``; the kernels take the level above the first one they
    step, ``n_steps - r H + 1``.  Every shard's halo is copied before any
    shard steps (the ``ppermute`` of JAX's ``_right_halo_perm``: shard d
    receives shard d+1's lanes ``[0, H)``, the last shard receives shard
    0's).  Phase 2: the shards' owned lanes gather on ``devs[0]``, which
    steps the remaining ``tail_levels`` levels.  Knots are counted over
    each shard's owned lanes only: its halo lanes are stale or, for the
    last shard, beyond the tree.  Returns the results on the host and
    each contract's knot count.
    """
    S, H, R = plan["shard_lanes"], plan["halo"], plan["rounds"]
    ax, W = eng.axis, len(devs)
    ctx, bufs, pcs = [], [], []
    for d, dev in enumerate(devs):
        with _on(dev):
            ctx.append(eng.prepare({k: v.to(dev) for k, v in cols.items()}))
            bufs.append(eng.leaf(ctx[d], eng.width(S + H), d * S))
            pcs.append(None)

    def bump(d, pc):
        if pc is not None:
            pcs[d] = pc if pcs[d] is None else torch.maximum(pcs[d], pc)

    for r in range(R):
        for d in range(W):
            src = bufs[(d + 1) % W]
            for dst_t, src_t in zip(bufs[d], src):
                dst_t.narrow(ax, S, H).copy_(src_t.narrow(ax, 0, H))
        lvl0 = n_steps + 1 - r * H
        for d, dev in enumerate(devs):
            with _on(dev):
                bufs[d], pc = eng.step(ctx[d], bufs[d], lvl0, H, d * S, S,
                                       None)
                bump(d, pc)

    dev0 = devs[0]
    with _on(dev0):
        parts = [b.map(lambda a: a.narrow(ax, 0, S).to(dev0)) for b in bufs]
        z = type(parts[0])(*(torch.cat(leaves, dim=ax)
                             for leaves in zip(*parts)))
        for rnd in _tail_plan(plan["tail_levels"], eng.tail_block):
            z = _fit(z, ax, rnd.lanes)
            z, pc = eng.step(ctx[0], z, rnd.lvl0, rnd.depth, 0, rnd.lanes,
                             rnd.block)
            bump(0, pc)
        out = tuple(t.cpu() for t in eng.finish(z))
    seen = [p.cpu() for p in pcs if p is not None]
    pieces = torch.stack(seen).amax(dim=0) if seen else None
    return out, pieces


def _node_axis(mesh: DeviceMesh, data_axes, model_axis: str, eng: _Engine,
               plan: dict, n_steps: int, names: tuple, dtype):
    """The sharded function: contracts over the data rows of ``mesh``
    (their count must divide evenly), each row's trees over its model
    axis, the columns in ``dtype``.  Returns ``(results on the host, max
    knot count or None)``."""
    rows = mesh.rows(data_axes, model_axis)

    def run(*args):
        cols = [torch.as_tensor(a).to(dtype).reshape(-1) for a in args]
        n = cols[0].shape[0]
        if any(c.shape[0] != n for c in cols) or n % len(rows):
            raise ValueError(f"contract columns of lengths "
                             f"{sorted({c.shape[0] for c in cols})} do not "
                             f"split evenly over {len(rows)} data rows")
        bc = n // len(rows)
        outs, pieces = [], []
        for i, devs in enumerate(rows):
            part = {k: c[i * bc:(i + 1) * bc] for k, c in zip(names, cols)}
            out, pc = _run_row(devs, part, eng, plan, n_steps)
            outs.append(out)
            if pc is not None:
                pieces.append(pc)
        res = tuple(torch.cat(o) for o in zip(*outs))
        top = int(torch.cat(pieces).max()) if pieces and n else None
        return res, top
    return run


def _check_build(mesh: DeviceMesh, data_axes, model_axis: str,
                 backend: str, dtype) -> int:
    """Refuse what the builders cannot run; returns the node-axis width."""
    mesh.rows(data_axes, model_axis)
    if backend not in NODE_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{NODE_BACKENDS}")
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"the node-axis engines compute in torch.float64 "
                         f"or torch.float32, got dtype={dtype}")
    return mesh.shape[model_axis]


def build_rz_sharded(mesh: DeviceMesh, *, n_steps: int,
                     payoff: PayoffProcess, capacity: int = 48,
                     round_depth: int = 8,
                     collapse_lanes: int | None = None,
                     data_axes=("data",), model_axis: str = "model",
                     backend: str = "kernel",
                     dtype=torch.float64) -> Callable:
    """``f(s0, sigma, rate, maturity, k) -> (ask, bid, max_pieces)``: the
    transaction-cost (Roux–Zastawniak) ask and bid of a contract batch
    split over ``data_axes``, each tree's node axis over ``model_axis``.

    The state is the fused seller+buyer PWL record ``(bc, 2, lanes, K)``.
    ``backend="kernel"`` runs each shard's round as one ``rz_round`` on
    its ``[S owned | H halo]`` buffer, a single-block round whose wrap
    pollutes only the halo lanes (the payoff must carry ``params``);
    ``backend="torch"`` steps ``rz_level_step_lanes`` level by level and
    takes any payoff.  ``ask`` and ``bid`` come back on the host;
    ``max_pieces`` is the largest raw knot count over the shards' owned
    live lanes and the tail (JAX's ``stat`` also counts the halo lanes).
    ``dtype`` is torch.float64 or torch.float32, as JAX's builders take
    it: the contract columns are cast to it and every round runs in it
    (``rz_round``'s float32 instance).
    """
    W = _check_build(mesh, data_axes, model_axis, backend, dtype)
    plan = plan_rounds(n_steps, W, round_depth, collapse_lanes)
    pay = kernel_params(payoff) if backend == "kernel" else None

    def prepare(c):
        params = rz_params(c["s0"], c["sigma"], c["rate"], c["maturity"],
                           c["k"], n_steps=n_steps)
        ctx = dict(params=params)
        if backend == "kernel":
            s0 = params["s0"]
            ctx["sc"] = torch.stack(
                [torch.zeros_like(s0), s0, params["sig_sqrt_dt"],
                 params["r"], params["k"],
                 *(torch.full_like(s0, x) for x in pay)], dim=1)
        else:
            ctx["col"] = {n: v[:, None, None] for n, v in params.items()}
            ctx["pay"] = (payoff if payoff.params is None else
                          tuple(torch.full_like(params["s0"], x)[:, None, None]
                                for x in payoff.params))
        return ctx

    def leaf(ctx, lanes, lane0):
        return _fused_leaf(n_steps, ctx["params"], capacity, lanes, lane0)

    def step(ctx, z, lvl0, levels, lane0, owned, block):
        if backend == "kernel":
            ctx["sc"][:, 0] = float(lvl0)
            return rz_round(z, ctx["sc"], levels=levels,
                            block=z.sl.shape[-1], lane0=lane0, owned=owned)
        dev = z.xs.device
        sides = _sides(dev)
        pieces = torch.zeros(z.m.shape[0], dtype=torch.int32, device=dev)
        for j in range(levels):
            z, pc = rz_level_step_lanes(z, float(lvl0 - (j + 1)), ctx["col"],
                                        ctx["pay"], capacity=capacity,
                                        seller=sides, idx_offset=lane0)
            pieces = torch.maximum(pieces, pc[..., :owned].amax(dim=(1, 2)))
        return z, pieces

    eng = _Engine(prepare=prepare, leaf=leaf, step=step, finish=_root_quote,
                  axis=2, width=lambda n: n, tail_block=None)
    run = _node_axis(mesh, data_axes, model_axis, eng, plan, n_steps,
                     ("s0", "sigma", "rate", "maturity", "k"), dtype)

    def f(s0, sigma, rate, maturity, k):
        (ask, bid), pieces = run(s0, sigma, rate, maturity, k)
        return ask, bid, 0 if pieces is None else pieces
    return f


def build_notc_sharded(mesh: DeviceMesh, *, n_steps: int, strike: float,
                       kind: str = "put", round_depth: int = 50,
                       collapse_lanes: int | None = None,
                       data_axes=("data",), model_axis: str = "model",
                       backend: str = "kernel", block: int = DEFAULT_BLOCK,
                       dtype=torch.float64) -> Callable:
    """``f(s0, sigma, rate, maturity) -> price``: the friction-free
    American put or call (``kind``) of a contract batch split over
    ``data_axes``, each tree's node axis over ``model_axis``.

    The leaf is level N (N+1 nodes) and N levels are processed, so the
    plan is laid out for ``n_steps - 1``.  ``backend="kernel"`` runs
    ``lattice_round`` (put or call baked in) on each shard's buffer,
    ``[S owned | H halo]`` padded to a multiple of ``block``, in calls of
    at most ``block`` levels; unlike JAX's level step it does not hold
    lanes beyond the level (``idx > lvl``) still, but those lanes never
    reach a live one, so the price is the same.  ``backend="torch"`` is
    JAX's level step.  The prices come back on the host.  ``dtype`` is
    torch.float64 or torch.float32 (``lattice_round``'s float32 instance),
    as JAX's builders take it.
    """
    W = _check_build(mesh, data_axes, model_axis, backend, dtype)
    if kind not in ("put", "call"):
        raise ValueError(f"kind must be 'put' or 'call', got {kind!r}")
    plan = plan_rounds(n_steps - 1, W, round_depth, collapse_lanes)
    strike = float(strike)

    def intrinsic(s):
        return torch.clamp_min(strike - s if kind == "put" else s - strike,
                               0.0)

    def prepare(c):
        dt = c["maturity"] / n_steps
        u = torch.exp(c["sigma"] * torch.sqrt(dt))
        r = torch.exp(c["rate"] * dt)
        p = (r - 1.0 / u) / (u - 1.0 / u)
        sig = c["sigma"] * torch.sqrt(dt)
        sc = torch.stack([torch.zeros_like(p), p, 1.0 / r,
                          torch.full_like(p, strike), c["s0"], sig], dim=1)
        return dict(s0=c["s0"][:, None], sig=sig[:, None], r=r[:, None],
                    p=p[:, None], sc=sc)

    def spots(ctx, lanes, lane0, lvl, dev):
        idx = lane0 + torch.arange(lanes, dtype=dtype, device=dev)
        return idx, ctx["s0"] * torch.exp((2.0 * idx - lvl) * ctx["sig"])

    def leaf(ctx, lanes, lane0):
        _, s = spots(ctx, lanes, lane0, float(n_steps), ctx["sc"].device)
        return _Values(intrinsic(s))

    def step(ctx, state, lvl0, levels, lane0, owned, blk):
        v = state.v
        if backend == "kernel":
            blk = block if blk is None else blk
            for done in range(0, levels, blk):
                ctx["sc"][:, 0] = float(lvl0 - done)
                v = lattice_round(v, ctx["sc"], levels=min(blk, levels - done),
                                  block=blk, kind=kind, lane0=lane0)
            return _Values(v), None
        for j in range(levels):
            lvl = float(lvl0 - (j + 1))
            idx, s = spots(ctx, v.shape[1], lane0, lvl, v.device)
            cont = (ctx["p"] * torch.roll(v, -1, dims=1)
                    + (1.0 - ctx["p"]) * v) / ctx["r"]
            v = torch.where(idx <= lvl, torch.maximum(intrinsic(s), cont), v)
        return _Values(v), None

    def width(n):
        return -(-n // block) * block if backend == "kernel" else n

    eng = _Engine(prepare=prepare, leaf=leaf, step=step,
                  finish=lambda st: (st.v[:, 0],), axis=1, width=width,
                  tail_block=block if backend == "kernel" else None)
    run = _node_axis(mesh, data_axes, model_axis, eng, plan, n_steps - 1,
                     ("s0", "sigma", "rate", "maturity"), dtype)

    def f(s0, sigma, rate, maturity):
        (price,), _ = run(s0, sigma, rate, maturity)
        return price
    return f
