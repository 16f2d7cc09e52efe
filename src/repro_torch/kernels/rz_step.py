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

On a CUDA tensor the wrapper launches ``csrc/rz_step.cu`` (one launch per
round, all levels inside); on a CPU tensor it runs the plain version
below, which repeats the block/halo structure with the torch PWL algebra.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import pwl as P
from ..core.rz import rz_level_step_lanes
from . import _build

__all__ = ["rz_round", "rz_round_plain", "RZ_SCALARS", "LAUNCHES",
           "MAX_CAPACITY"]

# [lvl0, s0, sig_sqrt_dt, r, k, alpha, zeta, w1, w2, k1, k2]
RZ_SCALARS = 11
MAX_CAPACITY = 128

# kernel launches (never bumped by the plain version)
LAUNCHES = {"rz_round": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"rz_round_launch": [_P] * 6 + [_P] * 6 + [_P] * 5
               + [_I] * 8 + [_P]}


def rz_round_plain(z: P.PWL, scalars, *, levels: int, block: int,
                   sellers=(True, False)):
    """Plain PyTorch round: ``z`` over ``(R, S, lanes)`` lanes, ``scalars
    (R, 11)``; returns ``(z_new, pieces (R,))``."""
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
    offset = (torch.arange(nblk, device=dev) * block).to(dtype)[:, None, None]
    c = lambda j: scalars[:, j, None, None, None]
    lvl0 = c(0)
    params = dict(s0=c(1), sig_sqrt_dt=c(2), r=c(3), k=c(4))
    pay = tuple(c(5 + j) for j in range(6))
    seller = torch.tensor(list(sellers), device=dev)[:, None]
    owned = torch.arange(W, device=dev) < block
    pieces = torch.zeros(R, dtype=torch.int32, device=dev)
    for j in range(levels):
        buf, pc = rz_level_step_lanes(buf, lvl0 - (j + 1), params, pay,
                                      capacity=K, seller=seller,
                                      idx_offset=offset)
        pieces = torch.maximum(pieces, torch.where(owned, pc, 0).amax(dim=(1, 2, 3)))
    out = buf.map(lambda a: a[:, :, :, :block].transpose(1, 2)
                  .reshape((R, S, lanes) + a.shape[4:]).contiguous())
    return out, pieces


def _check(z: P.PWL, scalars, levels: int, block: int, sellers):
    R, S, lanes, K = z.xs.shape
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
    for name, a, dt, shape in (("xs", z.xs, torch.float64, (R, S, lanes, K)),
                               ("ys", z.ys, torch.float64, (R, S, lanes, K)),
                               ("sl", z.sl, torch.float64, (R, S, lanes)),
                               ("sr", z.sr, torch.float64, (R, S, lanes)),
                               ("m", z.m, torch.int32, (R, S, lanes)),
                               ("scalars", scalars, torch.float64, None)):
        if a.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {a.dtype}")
        if shape is not None and tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                             f"expected {shape}")
        if a.device != z.xs.device:
            raise ValueError(f"{name} is on {a.device}, xs on {z.xs.device}")


def _launch(z: P.PWL, scalars, levels: int, block: int, sellers):
    if not all(a.is_contiguous() for a in (*z, scalars)):
        raise ValueError("rz_round's kernel takes contiguous tensors")
    R, S, lanes, K = z.xs.shape
    if K > MAX_CAPACITY:
        raise ValueError(f"capacity {K} > {MAX_CAPACITY} is not built")
    lib = _build.load("rz_step", _SIGNATURES)
    nblk = lanes // block
    W = 2 * block if nblk > 1 else block
    out = P.PWL(*(torch.empty_like(a) for a in z))
    pieces = torch.empty((R, nblk), dtype=torch.int32, device=z.xs.device)
    # per-CTA ping-pong level buffers: (R, nblk, 2, S, W[, K])
    sshape = (R, nblk, 2, S, W)
    f64 = dict(dtype=torch.float64, device=z.xs.device)
    scratch = (torch.empty(sshape + (K,), **f64), torch.empty(sshape + (K,), **f64),
               torch.empty(sshape, **f64), torch.empty(sshape, **f64),
               torch.empty(sshape, dtype=torch.int32, device=z.xs.device))
    mask = sum(1 << s for s, flag in enumerate(sellers) if flag)
    stream = torch.cuda.current_stream(z.xs.device).cuda_stream
    ptrs = [a.data_ptr() for a in (*z, scalars, *out, pieces, *scratch)]
    err = lib.rz_round_launch(*ptrs, R, S, lanes, K, block, nblk, levels,
                              mask, stream)
    _build.check(err, "rz_round_launch")
    return out, pieces.amax(dim=1)


def rz_round(z: P.PWL, scalars, *, levels: int, block: int,
             sellers: tuple = (True, False)):
    """One round of ``levels`` fused TC level steps over all node blocks.

    ``z``: PWL over ``(S, lanes)`` or ``(R, S, lanes)`` lanes (S sides,
    ``len(sellers)``), lanes a multiple of ``block``; ``scalars``:
    ``(11,)`` or ``(R, 11)`` in ``RZ_SCALARS`` order.  Returns ``(z_new,
    pieces)`` with ``pieces`` the max raw knot count over owned live lanes
    (a scalar, or ``(R,)`` for a row batch).
    """
    squeeze = z.sl.dim() == 2
    if squeeze:
        z, scalars = z.map(lambda a: a[None]), scalars[None]
    if z.sl.dim() != 3 or scalars.dim() != 2:
        raise ValueError("need z over (S, lanes) or (R, S, lanes) and "
                         "scalars (11,) or (R, 11)")
    sellers = tuple(bool(s) for s in sellers)
    _check(z, scalars, levels, block, sellers)
    if z.xs.device.type == "cuda":
        out, pieces = _launch(z, scalars, levels, block, sellers)
        LAUNCHES["rz_round"] += 1
    elif z.xs.device.type == "cpu":
        out, pieces = rz_round_plain(z, scalars, levels=levels, block=block,
                                     sellers=sellers)
    else:
        raise ValueError(f"unsupported device {z.xs.device}")
    if squeeze:
        return out.map(lambda a: a[0]), pieces[0]
    return out, pieces
