"""Ring attention: sequence (context) parallel exact attention.

The port of the JAX package's ``models/context_parallel.py``.  The
sequence is split over an axis of a rank mesh (``models/sharding.py``);
each rank keeps its query block and the key/value blocks travel round
the ring, one ``ppermute`` a step (K and V move left one rank), each
step's partial result merged by the online-softmax rule: the paper's
rotate-and-accumulate structure, with a block that visits every shard
instead of only its neighbour.

The merge is JAX's, in float32 and plain PyTorch, as JAX computes it
outside any Pallas kernel: scores ``q k^T / sqrt(hd)`` in float32, the
causal and window masks from global positions, running max ``m``, sum
``l`` and accumulator ``acc``.

Layout (one rank): q ``(B, S_local, KVH, G, hd)``, k, v ``(B, S_local,
KVH, hd)``; the global sequence is the concatenation over the axis's
ranks in coordinate order.

The ring has no backward: point-to-point sends carry no autograd, and
one would need the reverse ring for dK and dV.  In grad mode on inputs
that require grad it raises rather than return an output without a
gradient.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .sharding import all_gather, mesh_sizes, ppermute

__all__ = ["ring_attention_local", "make_ring_attention"]

_NEG = -1e30


def ring_attention_local(q, k, v, mesh, axis_name: str, *,
                         causal: bool = True, window: Optional[int] = None):
    """A rank's share (JAX's per-shard body): exact global attention of
    its query block over the ring of ``axis_name`` on ``mesh``.  Returns
    ``(B, S_local, KVH, G, hd)`` in ``v``'s dtype."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "ring attention has no backward: the point-to-point ring "
            "carries no gradient")
    W = mesh_sizes(mesh)[axis_name]
    me = mesh.get_local_rank(axis_name)
    B, Sl, KVH, G, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    ar = torch.arange(Sl, device=q.device)
    pos_q = (me * Sl + ar)[:, None]                       # (Sl, 1)
    qf = q.float()
    m = torch.full((B, KVH, G, Sl), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KVH, G, Sl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sl, KVH, G, hd), dtype=torch.float32,
                      device=q.device)
    kj, vj = k, v
    for j in range(W):
        src = (me + j) % W                                # the block's origin
        pos_k = (src * Sl + ar)[None, :]                  # (1, Sl)
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kj.float()) * scale
        mask = torch.ones((Sl, Sl), dtype=torch.bool, device=q.device)
        if causal:
            mask &= pos_q >= pos_k
        if window is not None:
            mask &= pos_q - pos_k < window
        s = torch.where(mask, s, torch.tensor(_NEG, device=q.device))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bkgqs,bskh->bqkgh", p.to(vj.dtype).float(),
                          vj.float())
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
        if j + 1 < W:
            kj = ppermute(kj, mesh, axis_name, -1)
            vj = ppermute(vj, mesh, axis_name, -1)
    out = acc / torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2)[..., None]
    return out.to(v.dtype)


def make_ring_attention(mesh, axis_name: str = "model", *,
                        causal: bool = True, window: Optional[int] = None):
    """The wrapper over whole tensors (JAX's ``shard_map`` of the body):
    ``fn(q (B, S, KVH, G, hd), k, v (B, S, KVH, hd))``, called alike on
    every rank of ``axis_name``, takes this rank's block of the
    sequence, runs the ring and gathers the blocks, so that every rank
    returns the single-device attention of the whole sequence."""
    W = mesh_sizes(mesh)[axis_name]

    def fn(q, k, v):
        S = q.shape[1]
        if S % W:
            raise ValueError(f"sequence {S} must divide the {W} ranks of "
                             f"{axis_name!r}")
        me = mesh.get_local_rank(axis_name)
        blk = slice(me * (S // W), (me + 1) * (S // W))
        out = ring_attention_local(q[:, blk], k[:, blk], v[:, blk], mesh,
                                   axis_name, causal=causal, window=window)
        return all_gather(out, mesh, axis_name, dim=1)

    return fn
