"""Blocked Roux–Zastawniak PWL rounds (transaction costs) on the card.

Port of the JAX package's ``kernels/rz_step.py`` (Pallas kernel
``_rz_round_kernel``).  One round advances every block of PWL lanes
``levels`` levels toward the root; per level and lane the fused
seller/buyer step of ``core/rz.py::rz_level_step_lanes``:

    w = envelope2(z[i+1], z[i], max);  w = w / r
    v = cone_infconv(w, (1+k)s, (1-k)s)          (no costs at level 0)
    z = envelope2(expense(±xi, ±zeta), v, max for the seller, min for the buyer)

A multi-block round reads the right-neighbour block (clamped at the last
block) as halo, so it needs ``levels <= block``; a single-block round has
no halo.  The second output is each row's max raw (pre-truncation) knot
count over owned live lanes: the overflow signal.

On a CUDA tensor the wrapper launches ``csrc/rz_step.cu``; on a CPU
tensor it runs the plain version below, which repeats the block/halo
structure with the torch PWL algebra.  The kernel steps tiles of lanes
with a recomputed halo (:func:`tile_plan`): an owned lane after
``levels`` steps depends only on the ``levels`` lanes to its right in a
virtual row (:func:`virtual_row`) that wraps for a single-block round
and repeats the last block past the end (the clamped halo) otherwise.
One launch runs up to ``LEVELS_PER_LAUNCH`` levels, so a round is one
launch at the engines' depths (64 levels at most).

The values and scalars share one dtype, float64 or float32 (the TPU
kernel's two dtypes; the CUDA source has an instance of each, with
separate entry points), and the plain version computes in it.  In
float32 the knot counts are not stable against the kernel's: a tie of
the envelopes that rounds the other way adds or drops a knot, so the
float32 kernel is held to its plain version in values only (1e-4, the
TPU kernel's float32 tolerance).
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple

import torch

from ..core import pwl as P
from ..core.rz import rz_level_step_lanes
from . import _build

__all__ = ["rz_round", "rz_round_plain", "RZ_SCALARS", "LAUNCHES",
           "MAX_CAPACITY", "Tile", "tile_plan", "virtual_row",
           "TILE_LANES", "LEVELS_PER_LAUNCH", "INLINE_KNOTS",
           "wide_pool_bytes"]

# [lvl0, s0, sig_sqrt_dt, r, k, alpha, zeta, w1, w2, k1, k2]
RZ_SCALARS = 11
MAX_CAPACITY = 128
# lanes a CTA of the kernel holds (owned lanes and halo: EMAX in
# csrc/rz_step.cu) and the fewest lanes a tile owns, which bound the
# levels of one launch
TILE_LANES = 256
MIN_OWNED = 64
# knots a lane record keeps in shared memory (KS in csrc/rz_step.cu); a
# lane with more keeps them in a device-memory slot
INLINE_KNOTS = 2
LEVELS_PER_LAUNCH = TILE_LANES - MIN_OWNED
# lane records a CTA keeps (2 buffers x 2 sides x TILE_LANES), each with a
# full-capacity slot for knots past the inline ones: the wide-record pool
_RECORDS_PER_CTA = 4 * TILE_LANES

# kernel launches per dtype, the float32 instance's under "rz_round.float32"
# (never bumped by the plain version)
LAUNCHES = {"rz_round": 0, "rz_round.float32": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LAUNCH_ARGS = [_P] * 14 + [_I] * 13 + [_P]
_SLOTS_ARGS = [_I, ctypes.POINTER(_I)]
_SIGNATURES = {"rz_round_launch": _LAUNCH_ARGS,
               "rz_round_slots": _SLOTS_ARGS,
               "rz_round_launch_f32": _LAUNCH_ARGS,
               "rz_round_slots_f32": _SLOTS_ARGS}
# the C entry points (launch, slots) of each dtype's instance
_ENTRY = {torch.float64: ("rz_round_launch", "rz_round_slots"),
          torch.float32: ("rz_round_launch_f32", "rz_round_slots_f32")}
_SLOTS: dict = {}


class Tile(NamedTuple):
    """One CTA's share of a row: owned lanes ``[start, start + owned)``
    and the ``extent`` positions of the virtual row from ``start`` that
    they depend on."""
    start: int
    owned: int
    extent: int


def tile_plan(lanes: int, block: int, levels: int, *, lanes_out=None,
              lvl0=None, lane0: int = 0,
              tile_lanes: int = TILE_LANES) -> List[Tile]:
    """The kernel's tiles for a round of ``levels`` levels over ``lanes``
    lanes in blocks of ``block``: equal tiles of at most ``tile_lanes -
    levels`` owned lanes over ``lanes_out`` (default ``lanes``) output
    lanes, each reading its owned lanes and ``levels`` more of the virtual
    row.  With ``lvl0`` the extent ends at the first lane that no level of
    the round steps (its value never changes, so nothing to its right
    reaches an owned lane), as the kernel clips it for each row; ``lane0``
    is the tree column of lane 0.  The kernel holds ``TILE_LANES``; a
    smaller ``tile_lanes`` gives the same schedule over more tiles (the
    CPU tests' small rows)."""
    if not 1 <= levels < tile_lanes or levels > LEVELS_PER_LAUNCH:
        raise ValueError(f"one launch takes 1..{LEVELS_PER_LAUNCH} levels "
                         f"and fewer than its {tile_lanes} lanes, got {levels}")
    lanes_out = lanes if lanes_out is None else lanes_out
    ntiles = -(-lanes_out // (tile_lanes - levels))
    tile = -(-lanes_out // ntiles)
    plan = []
    for start in range(0, lanes_out, tile):
        owned = min(tile, lanes_out - start)
        extent = owned + levels
        if lvl0 is not None:
            _, idx = virtual_row(start, extent, lanes, block, lane0)
            dead = (~(idx <= lvl0 - 1.0)).nonzero()
            if len(dead):
                extent = int(dead[0]) + 1
        plan.append(Tile(start, owned, extent))
    return plan


def virtual_row(start: int, extent: int, lanes: int, block: int,
                lane0: int = 0):
    """Input lanes and level indices of virtual positions ``[start, start
    + extent)``: a single-block round wraps (the TPU kernel's roll), lane
    p mod lanes at index lane0 + p mod lanes; a multi-block round repeats
    the last block past the end (its clamped right halo), lane p - block
    at index lane0 + p.  Returns ``(src int64, idx float64)`` tensors."""
    p = torch.arange(start, start + extent)
    if lanes // block == 1:
        src = p % lanes
        return src, (lane0 + src).to(torch.float64)
    return torch.where(p < lanes, p, p - block), (lane0 + p).to(torch.float64)


def rz_round_plain(z: P.PWL, scalars, *, levels: int, block: int,
                   sellers=(True, False), lane0: int = 0,
                   owned: int | None = None):
    """Plain PyTorch round: ``z`` over ``(R, S, lanes)`` lanes, ``scalars
    (R, 11)``, lane 0 at tree column ``lane0``, pieces over lanes below
    ``owned`` (default all); returns ``(z_new, pieces (R,))``."""
    R, S, lanes, K = z.xs.shape
    nblk = lanes // block
    dev, dtype = z.xs.device, z.xs.dtype
    # (R, nblk, S, W[, K]) buffers: each block plus its clamped right halo
    blocks = z.map(lambda a: a.reshape((R, S, nblk, block) + a.shape[3:])
                   .transpose(1, 2))
    if nblk > 1:
        nxt = torch.clamp(torch.arange(nblk, device=dev) + 1, max=nblk - 1)
        buf = blocks.map(lambda a: torch.cat([a, a[:, nxt]], dim=3))
    else:
        buf = blocks
    W = buf.sl.shape[-1]
    base = torch.arange(nblk, device=dev) * block
    offset = (lane0 + base).to(dtype)[:, None, None]
    c = lambda j: scalars[:, j, None, None, None]
    lvl0 = c(0)
    params = dict(s0=c(1), sig_sqrt_dt=c(2), r=c(3), k=c(4))
    pay = tuple(c(5 + j) for j in range(6))
    seller = torch.tensor(list(sellers), device=dev)[:, None]
    w = torch.arange(W, device=dev)
    counted = ((w < block) & (base[:, None] + w
                              < (lanes if owned is None else owned)))[:, None]
    pieces = torch.zeros(R, dtype=torch.int32, device=dev)
    for j in range(levels):
        buf, pc = rz_level_step_lanes(buf, lvl0 - (j + 1), params, pay,
                                      capacity=K, seller=seller,
                                      idx_offset=offset)
        pieces = torch.maximum(pieces, torch.where(counted, pc, 0).amax(dim=(1, 2, 3)))
    out = buf.map(lambda a: a[:, :, :, :block].transpose(1, 2)
                  .reshape((R, S, lanes) + a.shape[4:]).contiguous())
    return out, pieces


def _check(z: P.PWL, scalars, levels: int, block: int, sellers, lane0: int,
           owned: int):
    R, S, lanes, K = z.xs.shape
    if lane0 < 0 or not 1 <= owned <= lanes:
        raise ValueError(f"need lane0 >= 0 and 1 <= owned <= lanes {lanes}, "
                         f"got lane0={lane0}, owned={owned}")
    if S != len(sellers):
        raise ValueError(f"side axis {S} != len(sellers) {len(sellers)}")
    if block < 1 or lanes % block != 0:
        raise ValueError(f"lanes {lanes} not a multiple of block {block}")
    if tuple(scalars.shape) != (R, RZ_SCALARS):
        raise ValueError(f"scalars must have shape ({RZ_SCALARS},) per row, "
                         f"got {tuple(scalars.shape)}")
    if lanes // block > 1 and levels > block:
        raise ValueError(f"multi-block round needs levels <= block "
                         f"(halo staleness bound), got levels={levels} "
                         f"> block={block}")
    if levels < 1:
        raise ValueError(f"need levels >= 1, got {levels}")
    vt = z.xs.dtype
    if vt not in _ENTRY:
        raise TypeError(f"rz_round takes float64 or float32 values, got {vt}")
    for name, a, dt, shape in (("xs", z.xs, vt, (R, S, lanes, K)),
                               ("ys", z.ys, vt, (R, S, lanes, K)),
                               ("sl", z.sl, vt, (R, S, lanes)),
                               ("sr", z.sr, vt, (R, S, lanes)),
                               ("m", z.m, torch.int32, (R, S, lanes)),
                               ("scalars", scalars, vt, None)):
        if a.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {a.dtype}")
        if shape is not None and tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                             f"expected {shape}")
        if a.device != z.xs.device:
            raise ValueError(f"{name} is on {a.device}, xs on {z.xs.device}")


def _slots(lib, K: int, device, dtype=torch.float64) -> int:
    """Wide-record slots the kernel of ``dtype`` at capacity K needs on
    ``device``: one per CTA the card holds at once (a float32 CTA takes
    half the shared memory, so the card may hold more)."""
    key = (device.index, K, dtype)
    if key not in _SLOTS:
        n = ctypes.c_int(0)
        entry = _ENTRY[dtype][1]
        _build.check(getattr(lib, entry)(K, ctypes.byref(n)), entry)
        _SLOTS[key] = n.value
    return _SLOTS[key]


def wide_pool_bytes(K: int, device="cuda", dtype=torch.float64) -> int:
    """Bytes of the wide-record pool a launch of ``dtype`` at capacity K
    allocates on ``device``: a full-capacity knot slot for each lane
    record of each CTA the card holds at once."""
    lib = _build.load("rz_step", _SIGNATURES)
    size = torch.empty((), dtype=dtype).element_size()
    return size * _pool_len(_slots(lib, K, torch.device(device), dtype), K)


def _pool_len(nslots: int, K: int) -> int:
    """Values of the wide-record pool: xs and ys of K knots for every
    record of every slot."""
    return nslots * _RECORDS_PER_CTA * 2 * K


def _launch(z: P.PWL, scalars, levels: int, block: int, sellers,
            lane0: int, owned: int):
    """Launch the round kernel, ``LEVELS_PER_LAUNCH`` levels at a time;
    returns ``(z_new, pieces (R,), launches)``."""
    if not all(a.is_contiguous() for a in (*z, scalars)):
        raise ValueError("rz_round's kernel takes contiguous tensors")
    R, S, lanes, K = z.xs.shape
    if K > MAX_CAPACITY:
        raise ValueError(f"capacity {K} > {MAX_CAPACITY} is not built")
    if S > 2:      # a CTA holds two sides; the sides never mix
        parts = [_launch(z.map(lambda a: a[:, s:s + 2].contiguous()),
                         scalars, levels, block, sellers[s:s + 2], lane0,
                         owned)
                 for s in range(0, S, 2)]
        return (P.PWL(*(torch.cat(c, dim=1)
                        for c in zip(*(p[0] for p in parts)))),
                torch.stack([p[1] for p in parts]).amax(dim=0),
                sum(p[2] for p in parts))
    dev = z.xs.device
    lib = _build.load("rz_step", _SIGNATURES)
    dt = z.xs.dtype
    nslots = _slots(lib, K, dev, dt)
    wide = torch.empty(_pool_len(nslots, K), dtype=dt, device=dev)
    masks = torch.empty(-(-nslots // 32), dtype=torch.int32, device=dev)
    # a multi-block round's later launches continue on the virtual row:
    # the first writes lanes + (levels still to go) of it
    halo = block if lanes // block > 1 else 0
    mask = sum(1 << s for s, flag in enumerate(sellers) if flag)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sc = scalars.clone()
    pieces, done, n = None, 0, 0
    while done < levels:
        lv = min(LEVELS_PER_LAUNCH, levels - done)
        lanes_in = z.xs.shape[2]
        lanes_out = lanes + (levels - done - lv if halo else 0)
        plan = tile_plan(lanes_in, block if halo else lanes_in, lv,
                         lanes_out=lanes_out)
        out = P.PWL(*(torch.empty((R, S, lanes_out) + a.shape[3:],
                                  dtype=a.dtype, device=dev) for a in z))
        pc = torch.empty((R, len(plan)), dtype=torch.int32, device=dev)
        ptrs = [a.data_ptr() for a in (*z, sc, *out, pc, wide, masks)]
        entry = _ENTRY[dt][0]
        err = getattr(lib, entry)(*ptrs, nslots, R, S, lanes_in, lanes_out,
                                  owned, lane0, K, halo, lv, plan[0].owned,
                                  len(plan), mask, stream)
        _build.check(err, entry)
        pc = pc.amax(dim=1)
        pieces = pc if pieces is None else torch.maximum(pieces, pc)
        z, done, n = out, done + lv, n + 1
        sc[:, 0] -= lv
    return z, pieces, n


def rz_round(z: P.PWL, scalars, *, levels: int, block: int,
             sellers: tuple = (True, False), lane0: int = 0,
             owned: int | None = None):
    """One round of ``levels`` fused TC level steps over all node blocks.

    ``z``: PWL over ``(S, lanes)`` or ``(R, S, lanes)`` lanes (S sides,
    ``len(sellers)``), lanes a multiple of ``block``; ``scalars``:
    ``(11,)`` or ``(R, 11)`` in ``RZ_SCALARS`` order.  Returns ``(z_new,
    pieces)`` with ``pieces`` the max raw knot count over owned live lanes
    (a scalar, or ``(R,)`` for a row batch).

    ``lane0`` is the tree column of lane 0 (a shard of the node axis sets
    it; its spots and its "no costs at level 0" rule follow the column),
    and ``pieces`` counts lanes ``[0, owned)`` only (default all: a
    shard's buffer ends in halo lanes that a single-block round's wrap
    pollutes).
    """
    squeeze = z.sl.dim() == 2
    if squeeze:
        z, scalars = z.map(lambda a: a[None]), scalars[None]
    if z.sl.dim() != 3 or scalars.dim() != 2:
        raise ValueError("need z over (S, lanes) or (R, S, lanes) and "
                         "scalars (11,) or (R, 11)")
    sellers = tuple(bool(s) for s in sellers)
    lane0 = int(lane0)
    owned = z.xs.shape[2] if owned is None else int(owned)
    _check(z, scalars, levels, block, sellers, lane0, owned)
    _build.refuse_grad("rz_round", z.xs, z.ys, z.sl, z.sr, scalars)
    if z.xs.device.type == "cuda":
        out, pieces, launches = _launch(z, scalars, levels, block, sellers,
                                        lane0, owned)
        key = ("rz_round" if z.xs.dtype == torch.float64
               else "rz_round.float32")
        LAUNCHES[key] += launches
    elif z.xs.device.type == "cpu":
        out, pieces = rz_round_plain(z, scalars, levels=levels, block=block,
                                     sellers=sellers, lane0=lane0, owned=owned)
    else:
        raise ValueError(f"unsupported device {z.xs.device}")
    if squeeze:
        return out.map(lambda a: a[0]), pieces[0]
    return out, pieces
