"""The paper's partition and round schedule, and the scenario-axis shard
planner.

A copy of the JAX package's ``core/partition.py`` (pure Python and
numpy), in three parts:

* :func:`simulate_schedule` runs Algorithm 1's schedule exactly and
  counts the nodes of each thread (paper Table I:
  :func:`table1_reference`).  The *text* semantics of §4.2
  (``literal=False``, line 25 read as ``n <- B``) reproduce all nine
  published cells; the pseudo-code as printed overcounts by ~0.15%.
* :func:`kernel_round_plan`: the static round schedule of the blocked
  kernels — the base level B starts at N+1 and each round advances
  ``D = pick_round_depth(B)`` levels, with the lane extent re-balanced to
  the live tree before every round (§4.2).
* The shard planner: whole scenario rows assigned to the devices of a
  1-D mesh so that their predicted work is equal (:func:`plan_shards`),
  re-planned from measured per-shard seconds (:func:`replan_shards`,
  :class:`ShardRebalancer`) — §4.2's re-balancing at device granularity.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["RoundInfo", "ScheduleResult", "simulate_schedule",
           "table1_reference", "KernelRound", "DEFAULT_KERNEL_L",
           "pick_round_depth", "kernel_round_plan", "ShardPlan",
           "scenario_costs", "plan_shards", "shard_layout", "replan_shards",
           "ShardRebalancer"]

DEFAULT_KERNEL_L = 64


@dataclasses.dataclass
class RoundInfo:
    base_level: int          # B: level whose nodes are already done
    depth: int               # D: levels processed this round
    p: int                   # threads active this round
    per_thread: List[int]    # nodes processed by each ORIGINAL thread id
    sync_events: int         # signals + barrier (cost model input)


@dataclasses.dataclass
class ScheduleResult:
    n_steps: int
    L: int
    p0_nodes: int            # nodes processed by thread 0 (incl. leaf init)
    per_thread: List[int]
    rounds: List[RoundInfo]
    total_nodes: int         # all nodes in the tree, levels 0..N+1

    @property
    def makespan_nodes(self) -> int:
        """Schedule length if every node costs 1 and threads run in parallel:
        sum over rounds of the busiest thread's nodes (plus leaf init)."""
        init = max(self._init_counts)
        return init + sum(max(r.per_thread) for r in self.rounds)

    _init_counts: List[int] = dataclasses.field(default_factory=list)


def simulate_schedule(n_steps: int, p: int, L: int,
                      literal: bool = False) -> ScheduleResult:
    """Run Algorithm 1's schedule and count nodes per (original) thread."""
    if p < 1 or L < 1 or n_steps < 1:
        raise ValueError("need p >= 1, L >= 1, N >= 1")
    N = n_steps
    p_orig = p

    counts = [0] * p_orig
    rounds: List[RoundInfo] = []

    # --- initialisation at the leaf level t = N+1 (N+2 nodes) -------------
    n = N + 1                       # as in Algorithm 1 line 2 (level index)
    q = (n + 1) // p
    bounds = [(i * q, (i + 1) * q if i != p - 1 else n + 1) for i in range(p)]
    init_counts = [e - s for s, e in bounds]
    for i, c in enumerate(init_counts):
        counts[i] += c

    B = N + 1
    while B > 0:
        q = (n + 1) // p
        D = min(L, q - 1)
        D = max(D, 1)
        per_round = [0] * p_orig
        for C in range(B - 1, B - D - 1, -1):       # levels processed
            width = C + 1
            for i in range(p):
                s, e = bounds[i]
                got = max(0, min(e, width) - s)
                per_round[i] += got
        for i in range(p_orig):
            counts[i] += per_round[i]
        # each inner thread signals its left neighbour once; one barrier
        rounds.append(RoundInfo(base_level=B, depth=D, p=p,
                                per_thread=per_round,
                                sync_events=(p - 1) + 1))
        B = B - D
        if B <= 0:
            break
        # --- re-balance for the next round --------------------------------
        if literal:
            n = B + 1               # pseudo-code line 25 (count semantics)
        else:
            n = B                   # text semantics: n = base level index
        node_count = B + 1
        while node_count < 2 * p and p > 1:
            p = max(p - 1, 1)
        q = (n + 1) // p
        bounds = [(i * q, (i + 1) * q if i != p - 1 else n + 1)
                  for i in range(p)]

    total = (N + 2) * (N + 3) // 2
    res = ScheduleResult(n_steps=N, L=L, p0_nodes=counts[0],
                         per_thread=counts, rounds=rounds, total_nodes=total)
    res._init_counts = init_counts
    return res


@dataclasses.dataclass(frozen=True)
class KernelRound:
    """One round: base level ``lvl0``, ``depth`` levels, ``lanes`` lanes
    in blocks of ``block`` (``nblk = lanes // block``)."""
    lvl0: int
    depth: int
    lanes: int
    block: int

    @property
    def nblk(self) -> int:
        return self.lanes // self.block


def pick_round_depth(base_level: int, block: int | None,
                     L: int | None = None) -> int:
    """``D = min(L, B)``, and ``D <= block`` for a multi-block round
    (one right-neighbour halo block goes stale after ``block`` steps)."""
    L = DEFAULT_KERNEL_L if L is None else L
    d = min(L, base_level)
    if block is not None and base_level + 1 > block:
        d = min(d, block)
    return max(1, d)


def kernel_round_plan(n_steps: int, *, levels: int | None = None,
                      block: int | None = None) -> List[KernelRound]:
    """Round schedule from level N+1 to the root.

    ``block=None`` gives one block per round sized to the live level (no
    halo); otherwise lanes pad to a multiple of ``block`` and rounds with
    more than one block use the right-neighbour halo.
    """
    if n_steps < 1:
        raise ValueError("need n_steps >= 1")
    if block is not None and block < 1:
        raise ValueError("need block >= 1")
    B = n_steps + 1
    plan: List[KernelRound] = []
    while B > 0:
        D = pick_round_depth(B, block, levels)
        live = B + 1
        if block is None or live <= block:
            lanes, blk = live, live
        else:
            lanes = -(-live // block) * block
            blk = block
        plan.append(KernelRound(lvl0=B, depth=D, lanes=lanes, block=blk))
        B -= D
    return plan


# scenario-axis shard planner: §4.2's re-balancing lifted to a device mesh.
# A plan is made on the host from static ints before any engine runs.

def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Static assignment of scenario rows to the shards of a 1-D mesh.

    ``shards[d]`` holds the original row indices device ``d`` owns;
    ``work[d]`` is the predicted cost of those rows under the cost model
    the plan was made with.  ``lanes`` is the per-device row count after
    padding — every device gets exactly ``lanes`` rows (shorter shards
    repeat one of their own rows; an empty shard repeats row 0), so the
    engines see one shape ``(n_shards * lanes,)``.
    """
    n_shards: int
    shards: Tuple[Tuple[int, ...], ...]
    work: Tuple[float, ...]
    lanes: int
    n_rows: int

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(len(s) for s in self.shards)

    @property
    def padded_rows(self) -> int:
        return self.n_shards * self.lanes

    @property
    def work_spread(self) -> float:
        """(max - min) / mean of predicted per-shard work over non-empty
        shards — the planner's balance figure (0 = perfectly equal)."""
        w = [x for x, s in zip(self.work, self.shards) if s]
        if not w:
            return 0.0
        mean = sum(w) / len(w)
        return (max(w) - min(w)) / mean if mean > 0 else 0.0


def scenario_costs(n_steps: int, cost_rate, *, capacity: int = 48,
                   pieces=None, engine: Optional[str] = None,
                   n_paths: int = 4096, n_exercise: Optional[int] = None,
                   n_assets: int = 1) -> np.ndarray:
    """Predicted relative cost of each scenario row of a flat grid.

    Cost model (see docs/ARCHITECTURE.md "Engine matrix"):

      * a frictionless lattice row is one backward induction over the
        tree: ~``(N+1)^2 / 2`` node updates -> cost ``N^2``;
      * a transaction-cost row runs the Roux–Zastawniak PWL sweep at
        every node: ~``pieces`` knots of work per node -> cost
        ``N^2 * pieces``.  Before anything has run, ``pieces`` is the
        worst-case ``capacity``; after a flush the *measured*
        ``max_pieces`` is a much tighter estimate (feed it back here);
      * an ``engine="lsmc"`` row simulates ``n_paths`` basket paths of
        ``n_assets`` GBMs at ``n_exercise`` dates and regresses at each
        -> cost ``n_paths * n_exercise * n_assets``, identical across
        rows (MC work does not depend on the row's lambda).

    ``cost_rate`` is the per-row lambda array; ``pieces`` may be a scalar
    or a per-row array.  Returns a float64 array of per-row costs.
    """
    cr = np.atleast_1d(np.asarray(cost_rate, np.float64))
    if engine == "lsmc":
        n_ex = (n_steps + 1) if n_exercise is None else int(n_exercise)
        cost = float(n_paths) * max(n_ex, 1) * max(int(n_assets), 1)
        return np.full(cr.shape, cost)
    base = float(n_steps) ** 2
    if pieces is None:
        pieces = capacity
    mult = np.broadcast_to(np.asarray(pieces, np.float64), cr.shape)
    return base * np.where(cr > 0.0, np.maximum(mult, 1.0), 1.0)


def plan_shards(costs: Sequence[float], n_shards: int, *,
                device_speed: Optional[Sequence[float]] = None,
                lanes_pow2: bool = False) -> ShardPlan:
    """Assign rows to ``n_shards`` devices, equalising predicted work.

    Greedy LPT (longest-processing-time): rows sorted by descending cost
    are placed on the device with the smallest predicted *finish time*
    ``(load + cost) / speed``.  ``device_speed`` (relative, default all
    1.0) is how the rebalancer steers work away from shards that ran
    slow last flush.  With uneven costs the shard *sizes* come out
    uneven while the per-device work stays near-equal — the device-level
    mirror of the paper's ``floor((n+1)/p)`` bounds recomputation.

    ``lanes_pow2`` rounds the per-device lane count up to a power of two
    so a stream of slightly different batches reuses a few batch shapes
    (the serving layer's pad-to-bucket discipline, per device).
    """
    costs = np.asarray(costs, np.float64)
    n = costs.shape[0]
    W = int(n_shards)
    if W < 1:
        raise ValueError("need n_shards >= 1")
    if np.any(costs < 0):
        raise ValueError("row costs must be >= 0")
    speed = (np.ones(W) if device_speed is None
             else np.asarray(device_speed, np.float64))
    if speed.shape != (W,) or np.any(speed <= 0):
        raise ValueError(f"device_speed must be {W} positive factors")

    members: List[List[int]] = [[] for _ in range(W)]
    load = np.zeros(W)
    # stable sort: equal-cost rows keep index order -> deterministic plans
    for i in np.argsort(-costs, kind="stable"):
        d = int(np.argmin((load + costs[i]) / speed))
        members[d].append(int(i))
        load[d] += costs[i]
    for m in members:
        m.sort()                     # contiguous-looking, deterministic
    lanes = max(1, max(len(m) for m in members))
    if lanes_pow2:
        lanes = _next_pow2(lanes)
    return ShardPlan(n_shards=W,
                     shards=tuple(tuple(m) for m in members),
                     work=tuple(float(x) for x in load),
                     lanes=lanes, n_rows=n)


def shard_layout(plan: ShardPlan):
    """Materialise a plan as gather/scatter index maps.

    Returns ``(gather_idx, positions)``:

      * ``gather_idx`` — int array of length ``plan.padded_rows``; row
        ``j`` of the device-laid-out batch is original row
        ``gather_idx[j]``.  Each device's window of ``lanes`` rows holds
        its assigned rows followed by pad repeats of its last row (row 0
        for an empty shard) — pads are duplicates of *real* rows, so
        max-reductions (``max_pieces``!) and OverflowError behaviour are
        untouched by construction.
      * ``positions`` — int array of length ``plan.n_rows``;
        ``positions[i]`` is where original row ``i`` landed, so results
        come back as ``out[i] = y[positions[i]]``.
    """
    gather = np.zeros(plan.padded_rows, np.int64)
    positions = np.full(plan.n_rows, -1, np.int64)
    for d, rows in enumerate(plan.shards):
        base = d * plan.lanes
        fill = rows[-1] if rows else 0
        for slot in range(plan.lanes):
            src = rows[slot] if slot < len(rows) else fill
            gather[base + slot] = src
            if slot < len(rows):
                positions[rows[slot]] = base + slot
    if np.any(positions < 0):
        raise ValueError("plan does not cover every row exactly once")
    return gather, positions


def _speed_from_seconds(work, per_shard_seconds) -> np.ndarray:
    """Relative device speeds implied by measured per-shard seconds.

    A shard that did ``work`` units in ``seconds`` ran at ``work/seconds``
    units/s; normalising by the mean gives dimensionless speed factors
    for the next LPT pass.  Shards with no work (or no measured time)
    get speed 1.0 — no evidence, no steering.
    """
    w = np.asarray(work, np.float64)
    s = np.asarray(per_shard_seconds, np.float64)
    if w.shape != s.shape:
        raise ValueError(f"work {w.shape} vs seconds {s.shape}")
    ok = (w > 0) & (s > 0)
    speed = np.ones_like(w)
    if np.any(ok):
        raw = np.where(ok, w / np.where(ok, s, 1.0), np.nan)
        speed = np.where(ok, raw / np.nanmean(raw), 1.0)
    return speed


def replan_shards(costs: Sequence[float], prev: ShardPlan,
                  per_shard_seconds: Sequence[float], *,
                  n_shards: Optional[int] = None,
                  lanes_pow2: bool = False) -> ShardPlan:
    """Re-plan ``costs`` using the previous flush's measured seconds.

    The rebalance hook: measured per-shard wall seconds against the
    previous plan's predicted work yield per-device speed factors, and
    the next plan's LPT pass equalises *finish time* instead of raw
    work.  ``costs`` may describe a different batch than ``prev`` — the
    calibration is per-device, not per-row, exactly like the paper
    re-deriving thread bounds each round from the current live width.
    """
    speed = _speed_from_seconds(prev.work, per_shard_seconds)
    return plan_shards(costs, n_shards or prev.n_shards,
                       device_speed=speed, lanes_pow2=lanes_pow2)


class ShardRebalancer:
    """Keeps per-stream device-speed estimates and plans each flush.

    One instance serves many independent streams (the serving layer keys
    by bucket): :meth:`plan` makes the next plan with the stream's
    current speed estimates, :meth:`observe` folds a flush's measured
    per-shard seconds in with an EMA so one noisy measurement cannot
    flip the assignment (``ema=1.0`` trusts only the last flush).
    """

    def __init__(self, *, ema: float = 0.5):
        if not 0.0 < ema <= 1.0:
            raise ValueError("ema must be in (0, 1]")
        self.ema = float(ema)
        self._speed: Dict[object, np.ndarray] = {}

    def speed(self, key, n_shards: int) -> np.ndarray:
        got = self._speed.get(key)
        if got is None or got.shape[0] != n_shards:
            return np.ones(n_shards)
        return got.copy()            # callers cannot corrupt the estimate

    def plan(self, key, costs, n_shards: int, *,
             lanes_pow2: bool = False) -> ShardPlan:
        return plan_shards(costs, n_shards,
                           device_speed=self.speed(key, n_shards),
                           lanes_pow2=lanes_pow2)

    def observe(self, key, plan: ShardPlan, per_shard_seconds) -> np.ndarray:
        """Fold one flush's measurement in; returns the updated speeds."""
        obs = _speed_from_seconds(plan.work, per_shard_seconds)
        cur = self.speed(key, plan.n_shards)
        new = (1.0 - self.ema) * cur + self.ema * obs
        new = np.maximum(new, 1e-6)
        self._speed[key] = new / np.mean(new)
        return self._speed[key].copy()


def table1_reference() -> dict:
    """Paper Table I: actual node counts of thread p_0, L = 5."""
    return {
        (2, 1200): 362_999, (2, 1350): 458_999, (2, 1500): 566_249,
        (4, 1200): 181_198, (4, 1350): 229_161, (4, 1500): 282_748,
        (8, 1200): 90_311, (8, 1350): 114_255, (8, 1500): 141_008,
    }
