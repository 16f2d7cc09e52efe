"""Static round schedule of the blocked kernels (paper Algorithm 1).

A copy of the round planner of the JAX package: the base level B starts
at N+1 and each round advances ``D = pick_round_depth(B)`` levels, with
the lane extent re-balanced to the live tree before every round (§4.2).
"""
from __future__ import annotations

import dataclasses
from typing import List

__all__ = ["KernelRound", "DEFAULT_KERNEL_L", "pick_round_depth",
           "kernel_round_plan"]

DEFAULT_KERNEL_L = 64


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
