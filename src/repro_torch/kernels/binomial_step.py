"""Blocked binomial backward induction (no-TC lattice) on the card.

Port of the JAX package's ``kernels/binomial_step.py`` (Pallas kernels
``_round_kernel`` and ``_round_kernel_param``): one round advances every
``block``-lane tile of node values ``levels`` backward steps,

    cont = (p * v[i+1] + (1-p) * v[i]) / r,   v[i] = max(intrinsic, cont),

reading the right-neighbour block as a halo (clamped at the last block)
so that ``levels <= block`` steps never let the stale tail reach the
owned lanes.  Steps whose level is below 0 are no-ops.

``lattice_round_param`` carries the payoff as data (the 11-slot
``PARAM_SCALARS`` layout); ``lattice_round`` bakes put/call in as
``kind`` with 6 scalars.  Both take a row dimension: ``v (R, P)`` and
``scalars (R, n)``, where JAX vmapped over contracts.  ``v`` and
``scalars`` share one dtype, float64 or float32 (the TPU kernel's two
dtypes; the CUDA source has an instance of each), and the plain version
computes in it.

On a CUDA tensor the wrapper launches ``csrc/binomial_step.cu``; on a
CPU tensor it runs the plain version below, which repeats the TPU
kernel's block/halo structure step for step.  The CUDA kernel tiles the
row its own way (warp windows with a ``levels``-lane halo, the intrinsic
tabulated once per round) and gives the plain version's owned lanes bit
for bit, for ``lvl0`` a whole number (see the entry points).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["lattice_round", "lattice_round_param", "lattice_round_plain",
           "DEFAULT_BLOCK", "PARAM_SCALARS", "KIND_SCALARS", "LAUNCHES",
           "MAX_BLOCK"]

DEFAULT_BLOCK = 256
MAX_BLOCK = 1024
# [lvl0, p_up, inv_r, s0, sig_sqrt_dt, alpha, zeta, w1, w2, k1, k2]
PARAM_SCALARS = 11
# [lvl0, p_up, inv_r, strike, s0, sig_sqrt_dt]
KIND_SCALARS = 6
_KINDS = {"param": 0, "put": 1, "call": 2}

# kernel launches per entry point and dtype, the float32 instance's under
# "<name>.float32" (never bumped by the plain version)
LAUNCHES = {"lattice_round_param": 0, "lattice_round": 0,
            "lattice_round_param.float32": 0, "lattice_round.float32": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_SIGNATURES = {"lattice_round_launch": _ARGS,
               "lattice_round_launch_f32": _ARGS}
# the C entry point of each dtype's instance
_ENTRY = {torch.float64: "lattice_round_launch",
          torch.float32: "lattice_round_launch_f32"}


def _intrinsic(s, sc, kind: str):
    if kind == "put":
        return torch.clamp_min(sc[3] - s, 0.0)
    if kind == "call":
        return torch.clamp_min(s - sc[3], 0.0)
    alpha, zeta, w1, w2, k1, k2 = (sc[5 + j] for j in range(6))
    pay = (alpha * k1 + w1 * torch.clamp_min(s - k1, 0.0)
           + w2 * torch.clamp_min(s - k2, 0.0) + zeta * s)
    return torch.clamp_min(pay, 0.0)


def lattice_round_plain(v, scalars, *, levels: int, block: int,
                        kind: str = "param", lane0: int = 0):
    """Plain PyTorch version of one round: ``v (R, P)``, ``scalars (R, n)``,
    lane 0 at tree column ``lane0``.

    Builds each block's ``2*block``-lane buffer (block + clamped right
    halo), runs ``levels`` steps with a wrapping shift like the TPU
    kernel's ``roll``, and keeps the owned ``block`` lanes.
    """
    R, P = v.shape
    nblk = P // block
    blocks = v.reshape(R, nblk, block)
    nxt = torch.clamp(torch.arange(nblk, device=v.device) + 1, max=nblk - 1)
    buf = torch.cat([blocks, blocks[:, nxt]], dim=2)        # (R, nblk, 2B)
    idx = (lane0 + torch.arange(nblk, device=v.device)[:, None] * block
           + torch.arange(2 * block, device=v.device)).to(v.dtype)
    sc = [scalars[:, j, None, None] for j in range(scalars.shape[1])]
    if kind == "param":
        lvl0, p_up, inv_r, s0, sig = sc[:5]
    else:
        lvl0, p_up, inv_r, _, s0, sig = sc[:6]
    for j in range(levels):
        lvl = lvl0 - (j + 1)
        cont = (p_up * torch.roll(buf, -1, dims=2) + (1.0 - p_up) * buf) * inv_r
        s = s0 * torch.exp((2.0 * idx - lvl) * sig)
        new = torch.maximum(_intrinsic(s, sc, kind), cont)
        buf = torch.where(lvl >= 0, new, buf)
    return buf[:, :, :block].reshape(R, P).contiguous()


def _check(v, scalars, levels: int, block: int, n_scalars: int, lane0: int):
    if lane0 < 0:
        raise ValueError(f"need lane0 >= 0, got {lane0}")
    if v.dim() != 2 or scalars.dim() != 2:
        raise ValueError("need v (R, P) and scalars (R, n)")
    R, P = v.shape
    if scalars.shape != (R, n_scalars):
        raise ValueError(f"scalars must have shape ({R}, {n_scalars}), "
                         f"got {tuple(scalars.shape)}")
    if v.dtype not in _ENTRY or scalars.dtype != v.dtype:
        raise TypeError(f"the lattice kernel takes v and scalars of one "
                        f"dtype, float64 or float32, got {v.dtype} and "
                        f"{scalars.dtype}")
    if v.device != scalars.device:
        raise ValueError("v and scalars must be on one device")
    if not (1 <= block <= MAX_BLOCK) or P % block != 0:
        raise ValueError(f"P={P} must be a multiple of block={block} "
                         f"(1 <= block <= {MAX_BLOCK})")
    if not (1 <= levels <= block):
        raise ValueError(f"need 1 <= levels <= block, got levels={levels}")


def _launch(v, scalars, levels: int, block: int, kind: str, lane0: int):
    if not (v.is_contiguous() and scalars.is_contiguous()):
        raise ValueError("the lattice kernel takes contiguous tensors")
    lib = _build.load("binomial_step", _SIGNATURES)
    R, P = v.shape
    out = torch.empty_like(v)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    entry = _ENTRY[v.dtype]
    err = getattr(lib, entry)(v.data_ptr(), scalars.data_ptr(),
                              out.data_ptr(), R, P, block, levels,
                              _KINDS[kind], lane0, stream)
    _build.check(err, entry)
    return out


def _round(v, scalars, levels, block, kind, name, n_scalars, lane0):
    squeeze = v.dim() == 1
    if squeeze:
        v, scalars = v[None], scalars[None]
    lane0 = int(lane0)
    _check(v, scalars, levels, block, n_scalars, lane0)
    _build.refuse_grad(name, v, scalars)
    if v.device.type == "cuda":
        out = _launch(v, scalars, levels, block, kind, lane0)
        LAUNCHES[name if v.dtype == torch.float64 else f"{name}.float32"] += 1
    elif v.device.type == "cpu":
        out = lattice_round_plain(v, scalars, levels=levels, block=block,
                                  kind=kind, lane0=lane0)
    else:
        raise ValueError(f"unsupported device {v.device}")
    return out[0] if squeeze else out


def lattice_round_param(v, scalars, *, levels: int, block: int = DEFAULT_BLOCK,
                        lane0: int = 0):
    """One round with the payoff as data: ``v (P,)`` or ``(R, P)``,
    ``scalars (11,)`` or ``(R, 11)`` in ``PARAM_SCALARS`` order; ``lane0``
    is the tree column of lane 0 (a shard of the node axis sets it).

    ``lvl0`` (slot 0) must be a whole number, a level of the lattice, as
    the host round loops pass it: the CUDA kernel takes it as an integer
    and is not checked, so a fractional ``lvl0`` gives another round than
    the plain version's there."""
    return _round(v, scalars, levels, block, "param", "lattice_round_param",
                  PARAM_SCALARS, lane0)


def lattice_round(v, scalars, *, levels: int, block: int = DEFAULT_BLOCK,
                  kind: str = "put", lane0: int = 0):
    """One round with put/call baked in: ``scalars (6,)`` or ``(R, 6)``
    = ``[lvl0, p_up, inv_r, strike, s0, sig_sqrt_dt]``; ``lvl0`` must be a
    whole number, and ``lane0`` is taken, as for
    ``lattice_round_param``."""
    if kind not in ("put", "call"):
        raise ValueError(f"kind must be 'put' or 'call', got {kind!r}")
    return _round(v, scalars, levels, block, kind, "lattice_round",
                  KIND_SCALARS, lane0)
