"""The tile schedule of the ``rz_round`` kernel, run on the CPU.

``csrc/rz_step.cu`` steps tiles of lanes with a recomputed halo: a tile
reads the positions of the virtual row that its owned lanes depend on
(``kernels/rz_step.py::tile_plan`` and ``virtual_row``: the row wraps for
a single-block round, the last block repeats past the end for a
multi-block one), ends its extent at the first lane that the round never
steps, steps at level c only the first ``extent - c`` lanes, and keeps a
lane it does not step as it was.  The mirror below runs that schedule
with the plain level step (``core/rz.py::rz_level_step_lanes``) and
stitches the owned lanes; it must equal ``rz_round_plain`` bit for bit,
knot counts and raw piece counts included.  Small rows take a small
``tile_lanes`` so that a round spans several tiles.
"""
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.core.rz import leaf_level, rz_level_step_lanes, rz_params
from repro_torch.kernels import rz_step as TR

PUT = (1.0, 0.0, -1.0, 0.0, 100.0, 100.0)
CALL = (-1.0, 1.0, 0.0, 0.0, 100.0, 110.0)
BULL = (0.0, 0.0, 1.0, -1.0, 95.0, 105.0)


def _state(n_steps, capacity, lanes, walk, pay):
    """Two contracts' fused (2, 2, lanes) seller/buyer state ``walk``
    levels below the leaf, made by the plain level walk, and their round
    scalars."""
    t = lambda *x: torch.tensor(x, dtype=torch.float64)
    params = rz_params(t(100.0, 96.0), t(0.2, 0.25), t(0.1, 0.1),
                       t(0.25, 0.25), t(0.01, 0.005), n_steps=n_steps)
    z = leaf_level(n_steps, params, capacity, lanes).map(
        lambda a: a[:, None].expand((2, 2) + a.shape[1:]).contiguous())
    col = {k: v[:, None, None] for k, v in params.items()}
    payc = tuple(t(p) for p in pay)
    sides = torch.tensor([[True], [False]])
    for j in range(walk):
        z, _ = rz_level_step_lanes(z, float(n_steps - j), col, payc,
                                   capacity=capacity, seller=sides)
    lvl0 = n_steps + 1.0 - walk
    sc = torch.stack([t(lvl0, lvl0), params["s0"], params["sig_sqrt_dt"],
                      params["r"], params["k"], *(t(p, p) for p in pay)],
                     dim=1)
    return z, sc


def _tiled_round(z, sc, *, levels, block, tile_lanes):
    """rz_round's result computed tile by tile over the kernel's plan."""
    R, S, lanes, K = z.xs.shape
    out = z.map(torch.empty_like)
    pieces = torch.zeros(R, dtype=torch.int32)
    sides = torch.tensor([[True], [False]])
    for r in range(R):               # the extent's clip follows each row's lvl0
        c_ = lambda j: sc[r:r + 1, j, None, None]
        params = dict(s0=c_(1), sig_sqrt_dt=c_(2), r=c_(3), k=c_(4))
        pay = tuple(c_(5 + j) for j in range(6))
        lvl0 = float(sc[r, 0])
        for tile in TR.tile_plan(lanes, block, levels, lvl0=lvl0,
                                 tile_lanes=tile_lanes):
            # owned lanes past a clipped extent are never stepped
            src, idx = TR.virtual_row(tile.start, max(tile.extent, tile.owned),
                                      lanes, block)
            cur = z.map(lambda a: a[r:r + 1, :, src].clone())
            for c in range(1, levels + 1):
                n = tile.extent - c          # lanes the owned ones still need
                if n <= 0:
                    break
                # lane n reads a wrapped neighbour and is dropped
                part = cur.map(lambda a: a[:, :, :n + 1])
                offset = idx[:n + 1] - torch.arange(n + 1, dtype=torch.float64)
                new, pc = rz_level_step_lanes(part, lvl0 - c, params, pay,
                                              capacity=K, seller=sides,
                                              idx_offset=offset)
                for a, b in zip(cur, new):
                    a[:, :, :n] = b[:, :, :n]
                lane = tile.start + torch.arange(n)
                owned = (lane < tile.start + tile.owned) & (lane < lanes)
                pieces[r] = max(int(pieces[r]),
                                int(torch.where(owned, pc[..., :n], 0).max()))
            for a, b in zip(out, cur):
                a[r, :, tile.start:tile.start + tile.owned] = b[0, :, :tile.owned]
    return out, pieces


# (n_steps, capacity, lanes, block, levels, walk, payoff, tile_lanes)
CASES = {
    # 41 lanes in tiles of 14, 14 and 13
    "lanes-not-a-multiple-of-tile": (40, 16, 41, 41, 6, 1, BULL, 24),
    # one tile at the kernel's own size holds the whole row
    "lanes-below-tile": (40, 16, 42, 42, 8, 0, PUT, TR.TILE_LANES),
    # a single-block round that ends at the root
    "levels-eq-lvl0": (20, 16, 22, 22, 21, 0, BULL, 48),
    "levels-1": (30, 16, 32, 32, 1, 2, PUT, 8),
    # fewer lanes than the base level: the wrapping roll reaches lanes
    # that the round steps
    "single-block-wrap": (40, 16, 24, 24, 10, 0, BULL, 20),
    # four blocks of 12: the last block's halo is the clamped virtual row
    "halo-nblk4": (40, 16, 48, 12, 8, 2, BULL, 20),
    "halo-levels-eq-block": (40, 16, 48, 12, 12, 0, PUT, 40),
    # a call walked to lanes of more knots than the kernel holds inline
    "call-wide-lanes": (40, 48, 42, 42, 12, 24, CALL, 30),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tile_schedule_equals_plain_round(case):
    n, K, lanes, block, levels, walk, pay, tile_lanes = CASES[case]
    z, sc = _state(n, K, lanes, walk, pay)
    want, wpieces = TR.rz_round_plain(z, sc, levels=levels, block=block)
    got, pieces = _tiled_round(z, sc, levels=levels, block=block,
                               tile_lanes=tile_lanes)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(pieces, wpieces)
    if case == "call-wide-lanes":
        assert int(z.m.max()) > TR.INLINE_KNOTS
        assert int(want.m.max()) > TR.INLINE_KNOTS


def test_tile_plan_covers_the_row():
    for lanes, block, levels, tile_lanes in ((1502, 1502, 64, 256),
                                             (41, 41, 6, 24),
                                             (384, 128, 64, 256)):
        plan = TR.tile_plan(lanes, block, levels, tile_lanes=tile_lanes)
        starts = [t.start for t in plan]
        assert starts == sorted(starts) and starts[0] == 0
        assert sum(t.owned for t in plan) == lanes
        assert all(t.start + t.owned == u.start for t, u in zip(plan, plan[1:]))
        assert all(t.extent == t.owned + levels <= tile_lanes for t in plan)
        assert all(t.owned == plan[0].owned for t in plan[:-1])
        assert len(plan) == -(-lanes // (tile_lanes - levels))
    # the widest put round of N=1500: 8 tiles, the last clipped at lvl0
    plan = TR.tile_plan(1502, 1502, 64, lvl0=1501.0)
    assert len(plan) == 8 and plan[-1] == TR.Tile(1316, 186, 186)
    with pytest.raises(ValueError, match="levels"):
        TR.tile_plan(1502, 1502, TR.LEVELS_PER_LAUNCH + 1)


def test_virtual_row_wraps_or_clamps():
    src, idx = TR.virtual_row(20, 8, 24, 24)          # one block: wraps
    assert src.tolist() == [20, 21, 22, 23, 0, 1, 2, 3]
    assert idx.tolist() == [20.0, 21.0, 22.0, 23.0, 0.0, 1.0, 2.0, 3.0]
    src, idx = TR.virtual_row(44, 8, 48, 12)          # clamped last block
    assert src.tolist() == [44, 45, 46, 47, 36, 37, 38, 39]
    assert idx.tolist() == [44.0 + i for i in range(8)]
