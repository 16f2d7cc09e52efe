"""Fixed-capacity piecewise-linear function algebra in PyTorch.

The port of the JAX package's ``core/pwl.py``, same layout and numerics.
Every function is a structure-of-arrays record over leading batch dims:

    xs : (..., K)  sorted knot abscissae, padding +BIG after the first m
    ys : (..., K)  knot values, padding 0
    sl : (...,)    slope left of the first knot
    sr : (...,)    slope right of the last knot
    m  : (...,)    int32 number of valid knots (>= 1)

Each operation runs on the whole batch at once (JAX vmapped a
single-function body; here the batch dims ride along), is sort-free —
merges are rank computations by binary search, compaction is a prefix
sum — and each envelope or cone returns the **raw** knot count before
truncation to the capacity, which the engines carry to detect overflow.
Tolerances: relative ``_REL = 1e-9`` on slopes and crossings, widths
guarded by ``_tiny(dtype)``.  Every operation runs in the records' dtype,
float64 or float32, as JAX's does; in float32 ``_REL`` lies below the
float's resolution, so float noise reads as kinks and the knot counts
grow level by level, in both packages alike.  :func:`from_ref` and
:func:`to_ref` convert one function to and from the numpy oracle
(``core/pwl_ref.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["PWL", "BIG", "make_affine", "expense", "eval_at", "scale",
           "envelope2", "cone_infconv", "merge_sorted", "from_ref", "to_ref"]

BIG = 1e30
_REL = 1e-9
_TINY = 1e-300


def _tiny(dtype) -> float:
    """Positive-width guard: 1e-300 in float64, ``finfo.tiny`` otherwise."""
    if dtype == torch.float64:
        return _TINY
    return float(torch.finfo(dtype).tiny)


class PWL(NamedTuple):
    xs: torch.Tensor   # (..., K)
    ys: torch.Tensor   # (..., K)
    sl: torch.Tensor   # (...,)
    sr: torch.Tensor   # (...,)
    m: torch.Tensor    # (...,) int32

    def map(self, fn) -> "PWL":
        return PWL(*(fn(a) for a in self))


def _as(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------- #
# constructors
# --------------------------------------------------------------------- #
def _one_knot(x0, y0, sl, sr, capacity: int) -> PWL:
    shape = torch.broadcast_shapes(x0.shape, y0.shape, sl.shape, sr.shape)
    x0, y0, sl, sr = (a.expand(shape) for a in (x0, y0, sl, sr))
    xs = torch.full(shape + (capacity,), BIG, dtype=x0.dtype, device=x0.device)
    xs[..., 0] = x0
    ys = torch.zeros(shape + (capacity,), dtype=x0.dtype, device=x0.device)
    ys[..., 0] = y0
    m = torch.ones(shape, dtype=torch.int32, device=x0.device)
    return PWL(xs, ys, sl.clone(), sr.clone(), m)


def make_affine(slope, value_at_0, capacity: int, *, dtype=torch.float64,
                device="cpu") -> PWL:
    slope = torch.as_tensor(slope, dtype=dtype, device=device)
    v0 = torch.as_tensor(value_at_0, dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    return _one_knot(zero, v0, slope, slope, capacity)


def expense(xi, zeta, s_ask, s_bid, capacity: int) -> PWL:
    """u(y) = xi + (y - zeta)^- s_ask - (y - zeta)^+ s_bid (knot at zeta).

    Arguments are tensors of one dtype and device (broadcast together).
    """
    return _one_knot(zeta, xi, -s_ask, -s_bid, capacity)


# --------------------------------------------------------------------- #
# sort-free merge and compaction
# --------------------------------------------------------------------- #
def _searchsorted(a: torch.Tensor, v: torch.Tensor, side: str) -> torch.Tensor:
    """Ranks of ``v`` in ascending ``a`` along the last dim (int64):
    ``side="right"`` counts ``a <= v``, ``"left"`` counts ``a < v``."""
    shape = torch.broadcast_shapes(a.shape[:-1], v.shape[:-1])
    a = a.expand(shape + a.shape[-1:]).contiguous()
    v = v.expand(shape + v.shape[-1:]).contiguous()
    return torch.searchsorted(a, v, right=(side == "right"))


def _merge_take(a: torch.Tensor, b: torch.Tensor, *payloads):
    """Stable merge of ascending ``a`` and ``b`` (``a`` first on ties),
    routing ``(pa, pb)`` payloads along; returns ``(merged, *payloads)``.

    ``a[i]`` lands at rank ``i + |{b < a[i]}|`` and ``b[j]`` at
    ``j + |{a <= b[j]}|``; the two rank sets partition the output.
    """
    na, nb = a.shape[-1], b.shape[-1]
    ia = torch.arange(na, device=a.device)
    ib = torch.arange(nb, device=a.device)
    ra = ia + _searchsorted(b, a, "left")
    rb = ib + _searchsorted(a, b, "right")
    shape = a.shape[:-1] + (na + nb,)
    out = []
    for pa, pb in ((a, b), *payloads):
        o = torch.empty(shape, dtype=pa.dtype, device=pa.device)
        o.scatter_(-1, ra, pa)
        o.scatter_(-1, rb, pb)
        out.append(o)
    return tuple(out)


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sort-free merge of two ascending knot vectors along the last dim
    (:func:`_merge_take` without payloads)."""
    return _merge_take(a, b)[0]


def _compact(xs, ys, keep):
    """Stable-compact kept knots to the front; (xs BIG-padded, ys
    0-padded, m int32)."""
    n = xs.shape[-1]
    m2 = keep.sum(-1, dtype=torch.int32)
    pos = torch.cumsum(keep.to(torch.int64), -1) - 1
    pos = torch.where(keep, pos, n)               # dropped -> dump slot n
    shape = xs.shape[:-1] + (n + 1,)
    xs2 = torch.full(shape, BIG, dtype=xs.dtype, device=xs.device)
    ys2 = torch.zeros(shape, dtype=ys.dtype, device=ys.device)
    xs2.scatter_(-1, pos, xs)
    ys2.scatter_(-1, pos, ys)
    live = torch.arange(n, device=xs.device) < m2[..., None]
    xs2 = torch.where(live, xs2[..., :n], BIG)
    ys2 = torch.where(live, ys2[..., :n], 0.0)
    return xs2, ys2, m2


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[a0, b0, a1, b1, ..., a_{n-1}] along the last dim (b one shorter)."""
    n = a.shape[-1]
    pad = torch.cat([b, torch.zeros_like(b[..., :1])], -1)
    return torch.stack([a, pad], -1).reshape(a.shape[:-1] + (2 * n,))[..., :2 * n - 1]


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, -1, i)


# --------------------------------------------------------------------- #
# evaluation
# --------------------------------------------------------------------- #
def _interval_slope(f: PWL, c: torch.Tensor):
    """(cnt, il, slope_in) at query points ``c (..., C)``; zero-width
    intervals get slope 0 and are never the selected branch."""
    K = f.xs.shape[-1]
    cnt = _searchsorted(f.xs, c, "right")
    il = torch.clamp(cnt - 1, 0, K - 1)
    ir = torch.clamp(cnt, 0, K - 1)
    xl, xr = _take(f.xs, il), _take(f.xs, ir)
    yl, yr = _take(f.ys, il), _take(f.ys, ir)
    w = xr - xl
    ok_w = w > _tiny(f.xs.dtype)
    slope_in = torch.where(ok_w, yr - yl, 0.0) / torch.where(ok_w, w, 1.0)
    return cnt, il, xl, yl, slope_in


def _eval1(f: PWL, c: torch.Tensor) -> torch.Tensor:
    """f at query points ``c (..., C)`` (batch dims broadcast)."""
    K = f.xs.shape[-1]
    cnt, il, xl, yl, slope_in = _interval_slope(f, c)
    v_in = yl + slope_in * (c - xl)
    m = f.m[..., None].to(torch.int64)
    ilast = torch.clamp(m - 1, 0, K - 1)
    x0, y0 = f.xs[..., :1], f.ys[..., :1]
    v_l = y0 + f.sl[..., None] * (c - x0)
    v_r = _take(f.ys, ilast) + f.sr[..., None] * (c - _take(f.xs, ilast))
    return torch.where(cnt == 0, v_l, torch.where(cnt >= m, v_r, v_in))


def eval_at(f: PWL, c) -> torch.Tensor:
    """Evaluate at one point per function (``c`` broadcasts over batch)."""
    c = _as(c, f.xs).expand(f.sl.shape)
    return _eval1(f, c[..., None])[..., 0]


def scale(f: PWL, alpha) -> PWL:
    """alpha * f with alpha > 0 (broadcast over batch)."""
    alpha = _as(alpha, f.ys)
    return PWL(f.xs, f.ys * alpha[..., None], f.sl * alpha, f.sr * alpha, f.m)


# --------------------------------------------------------------------- #
# compression: dedupe + drop collinear knots + compact to capacity
# --------------------------------------------------------------------- #
def _compress1(xs, ys, sl, sr, valid, out_cap: int):
    """xs sorted with invalid entries BIG; returns (PWL, m_raw)."""
    n = xs.shape[-1]
    dev = xs.device
    idx = torch.arange(n, device=dev)
    prev_x = torch.cat([torch.full_like(xs[..., :1], -BIG), xs[..., :-1]], -1)
    prev_valid = torch.cat([torch.zeros_like(valid[..., :1]), valid[..., :-1]], -1)
    dup = valid & prev_valid & (xs - prev_x <= _REL * (1.0 + prev_x.abs()))
    keep1 = valid & ~dup
    m1 = keep1.sum(-1, keepdim=True)
    rank = torch.cumsum(keep1.to(torch.int64), -1) - 1
    # neighbours among survivors: next = exclusive suffix-min of kept
    # indices, prev = exclusive prefix-max
    kept_i = torch.where(keep1, idx, n)
    smin = torch.flip(torch.cummin(torch.flip(kept_i, [-1]), -1).values, [-1])
    ni = torch.cat([smin[..., 1:], torch.full_like(smin[..., :1], n)], -1)
    kept_p = torch.where(keep1, idx, -1)
    pmax = torch.cummax(kept_p, -1).values
    pi = torch.cat([torch.full_like(pmax[..., :1], -1), pmax[..., :-1]], -1)
    nig = torch.clamp(ni, 0, n - 1)
    pig = torch.clamp(pi, 0, n - 1)
    tiny = _tiny(xs.dtype)
    xn, yn = _take(xs, nig), _take(ys, nig)
    xp, yp = _take(xs, pig), _take(ys, pig)
    s_right = torch.where(keep1 & (rank < m1 - 1),
                          (yn - ys) / torch.clamp_min(xn - xs, tiny),
                          sr[..., None])
    s_left = torch.where(keep1 & (rank > 0),
                         (ys - yp) / torch.clamp_min(xs - xp, tiny),
                         sl[..., None])
    tol = _REL * (1.0 + torch.maximum(s_left.abs(), s_right.abs()))
    kink = (s_right - s_left).abs() > tol
    keep2 = keep1 & kink
    # always retain at least one (anchor) knot: the first survivor
    keep2 = torch.where(keep2.any(-1, keepdim=True), keep2, keep1 & (rank == 0))
    xs2, ys2, m2 = _compact(xs, ys, keep2)
    out = PWL(xs2[..., :out_cap].contiguous(), ys2[..., :out_cap].contiguous(),
              sl, sr, torch.clamp_max(m2, out_cap))
    return out, m2


# --------------------------------------------------------------------- #
# pointwise max / min of two functions (exact, incl. crossing knots)
# --------------------------------------------------------------------- #
def _envelope_core(f: PWL, g: PWL, merged, vf, vg, mv, out_cap: int,
                   take_max):
    """Envelope given the merged grid ``merged (..., M)`` holding every
    valid knot of both functions, their values ``vf``/``vg`` on it and its
    valid count ``mv``.  ``take_max`` is a bool or a bool tensor that
    broadcasts over the batch dims (per-lane max/min)."""
    M = merged.shape[-1]
    dev = merged.device
    tiny = _tiny(merged.dtype)
    mv = mv[..., None].to(torch.int64)
    i_idx = torch.arange(M + 1, device=dev)
    lo = torch.cat([torch.full_like(merged[..., :1], -BIG), merged], -1)
    hi_src = torch.cat([merged, merged[..., -1:]], -1)
    hi = torch.where(i_idx >= mv, BIG, hi_src)
    dx = merged[..., 1:] - merged[..., :-1]
    ok_dx = dx > tiny
    inv_dx = 1.0 / torch.where(ok_dx, dx, 1.0)
    sf_mid = torch.where(ok_dx, vf[..., 1:] - vf[..., :-1], 0.0) * inv_dx
    sg_mid = torch.where(ok_dx, vg[..., 1:] - vg[..., :-1], 0.0) * inv_dx
    fsl, fsr = f.sl[..., None], f.sr[..., None]
    gsl, gsr = g.sl[..., None], g.sr[..., None]
    sf = torch.cat([fsl.expand(sf_mid.shape[:-1] + (1,)), sf_mid,
                    fsr.expand(sf_mid.shape[:-1] + (1,))], -1)
    sg = torch.cat([gsl.expand(sg_mid.shape[:-1] + (1,)), sg_mid,
                    gsr.expand(sg_mid.shape[:-1] + (1,))], -1)
    sf = torch.where(i_idx >= mv, fsr, sf)
    sg = torch.where(i_idx >= mv, gsr, sg)
    denom = sf - sg
    parallel = denom.abs() <= _REL * (1.0 + torch.maximum(sf.abs(), sg.abs()))
    # crossing anchored at the interval's left knot (right knot for the
    # unbounded-left interval 0)
    ai = torch.clamp(i_idx - 1, 0, M - 1).expand(merged.shape[:-1] + (M + 1,))
    ax, avf, avg = _take(merged, ai), _take(vf, ai), _take(vg, ai)
    x_cross = ax + (avg - avf) / torch.where(parallel, 1.0, denom)
    margin = _REL * (1.0 + x_cross.abs())
    inside = (x_cross > lo + margin) & (x_cross < hi - margin)
    ok = (~parallel) & inside & (i_idx <= mv)
    cross = torch.where(ok, x_cross, BIG)
    cross_v = torch.where(ok, avf + sf * (x_cross - ax), 0.0)
    if isinstance(take_max, bool):
        hk = torch.maximum(vf, vg) if take_max else torch.minimum(vf, vg)
    else:
        tm = take_max[..., None]
        hk = torch.where(tm, torch.maximum(vf, vg), torch.minimum(vf, vg))
    raw = _interleave(cross, merged)
    raw_v = _interleave(cross_v, hk)
    raw_keep = _interleave(ok, (i_idx[:-1] < mv).expand(merged.shape))
    cands, hv, _ = _compact(raw, raw_v, raw_keep)
    valid = cands < BIG / 2
    # end slopes from probes beyond the outermost candidates
    nvc = valid.sum(-1, keepdim=True).to(torch.int64)
    pl = cands[..., :1] - 1.0
    pr = _take(cands, torch.clamp(nvc - 1, 0, cands.shape[-1] - 1)) + 1.0
    probes = torch.cat([pl, pr], -1)
    fv, gv = _eval1(f, probes), _eval1(g, probes)
    fl, fr, gl, gr = fv[..., 0], fv[..., 1], gv[..., 0], gv[..., 1]
    tie_l = (fl - gl).abs() <= _REL * (1.0 + torch.maximum(fl.abs(), gl.abs()))
    tie_r = (fr - gr).abs() <= _REL * (1.0 + torch.maximum(fr.abs(), gr.abs()))
    sl_max = torch.where(tie_l, torch.minimum(f.sl, g.sl),
                         torch.where(fl > gl, f.sl, g.sl))
    sr_max = torch.where(tie_r, torch.maximum(f.sr, g.sr),
                         torch.where(fr > gr, f.sr, g.sr))
    sl_min = torch.where(tie_l, torch.maximum(f.sl, g.sl),
                         torch.where(fl < gl, f.sl, g.sl))
    sr_min = torch.where(tie_r, torch.minimum(f.sr, g.sr),
                         torch.where(fr < gr, f.sr, g.sr))
    if isinstance(take_max, bool):
        sl, sr = (sl_max, sr_max) if take_max else (sl_min, sr_min)
    else:
        sl = torch.where(take_max, sl_max, sl_min)
        sr = torch.where(take_max, sr_max, sr_min)
    hv = torch.where(valid, hv, 0.0)
    return _compress1(cands, hv, sl, sr, valid, out_cap)


def _bcast(f: PWL, g: PWL):
    shape = torch.broadcast_shapes(f.sl.shape, g.sl.shape)
    ex = lambda p: PWL(p.xs.expand(shape + (p.xs.shape[-1],)),
                       p.ys.expand(shape + (p.ys.shape[-1],)),
                       p.sl.expand(shape), p.sr.expand(shape),
                       p.m.expand(shape))
    return ex(f), ex(g)


def envelope2(f: PWL, g: PWL, out_cap: int, take_max):
    """Pointwise max/min over the batch; returns (PWL, m_raw).

    ``take_max`` is a bool, or a bool tensor broadcasting over the batch
    dims (the fused seller/buyer walk selects max or min per lane).
    """
    f, g = _bcast(f, g)
    if not isinstance(take_max, bool):
        take_max = torch.as_tensor(take_max, device=f.xs.device).expand(f.sl.shape)
    vfg = _eval1(f, g.xs)                  # f at g's knots
    vgf = _eval1(g, f.xs)                  # g at f's knots
    merged, vf, vg = _merge_take(f.xs, g.xs, (f.ys, vfg), (vgf, g.ys))
    return _envelope_core(f, g, merged, vf, vg, f.m + g.m, out_cap, take_max)


# --------------------------------------------------------------------- #
# transaction-cost slope restriction (inf-convolution with the cost cone)
# --------------------------------------------------------------------- #
def cone_infconv(f: PWL, a, b, out_cap: int):
    """v(y) = min_{y'} [f(y') + max(a(y'-y), b(y'-y))]; a, b broadcast
    over the batch.  Returns (PWL, m_raw)."""
    batch = f.sl.shape
    a = _as(a, f.xs).expand(batch)
    b = _as(b, f.xs).expand(batch)
    K = f.xs.shape[-1]
    dev = f.xs.device
    idx = torch.arange(K, device=dev)
    m = f.m[..., None].to(torch.int64)
    valid = idx < m
    ac, bc = a[..., None], b[..., None]
    A = torch.where(valid, f.ys + ac * f.xs, BIG)
    Bv = torch.where(valid, f.ys + bc * f.xs, BIG)
    SA = torch.flip(torch.cummin(torch.flip(A, [-1]), -1).values, [-1])
    PB = torch.cummin(Bv, -1).values
    big1 = torch.full_like(f.xs[..., :1], BIG)
    nxt_x = torch.cat([f.xs[..., 1:], big1], -1)
    nxt_SA = torch.cat([SA[..., 1:], big1], -1)
    denom = ac - bc
    par = denom.abs() <= _REL * (1.0 + ac.abs())
    ystar = (nxt_SA - PB) / torch.where(par, 1.0, denom)
    margin = _REL * (1.0 + ystar.abs())
    ok = ((~par) & (idx + 1 < m) & (nxt_SA < BIG / 2) & (PB < BIG / 2)
          & (ystar > f.xs + margin) & (ystar < nxt_x - margin))
    cross = torch.where(ok, ystar, BIG)
    cands, _, menv = _compact(_interleave(f.xs, cross[..., :-1]),
                              torch.zeros(batch + (2 * K - 1,),
                                          dtype=f.xs.dtype, device=dev),
                              _interleave(valid.expand(ok.shape), ok[..., :-1]))
    cvalid = cands < BIG / 2
    # env(c) = min(-a c + SA(c), -b c + PB(c))
    ge = _searchsorted(f.xs, cands, "left")
    le = _searchsorted(f.xs, cands, "right")
    SA_at = torch.where(ge < m, _take(SA, torch.clamp(ge, 0, K - 1)), BIG)
    PB_at = torch.where(le > 0, _take(PB, torch.clamp(le - 1, 0, K - 1)), BIG)
    env_v = torch.minimum(torch.where(SA_at < BIG / 2, -ac * cands + SA_at, BIG),
                          torch.where(PB_at < BIG / 2, -bc * cands + PB_at, BIG))
    env_v = torch.where(cvalid, env_v, 0.0)
    env = PWL(cands, env_v, -a, -b, menv)
    vf = _eval1(f, cands)
    return _envelope_core(f, env, cands, vf, env_v, menv, out_cap,
                          take_max=False)


# --------------------------------------------------------------------- #
# conversions to and from the exact oracle (testing)
# --------------------------------------------------------------------- #
def from_ref(ref, capacity: int, dtype=torch.float64) -> PWL:
    """One oracle function (``pwl_ref.PWLRef``) as a record: ``xs``, ``ys``
    of shape ``(capacity,)``, 0-dim ``sl``, ``sr`` and int32 ``m``."""
    m = ref.m
    if m > capacity:
        raise ValueError(f"oracle function has {m} knots > capacity {capacity}")
    xs = torch.full((capacity,), BIG, dtype=torch.float64)
    ys = torch.zeros((capacity,), dtype=torch.float64)
    xs[:m] = torch.as_tensor(ref.xs, dtype=torch.float64)
    ys[:m] = torch.as_tensor(ref.ys, dtype=torch.float64)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64).to(dtype)
    return PWL(t(xs), t(ys), t(ref.s_left), t(ref.s_right),
               torch.tensor(m, dtype=torch.int32))


def to_ref(f: PWL):
    """One record (0-dim ``sl``) as an oracle function: its first ``m``
    knots, in float64."""
    from .pwl_ref import PWLRef
    m = int(f.m)
    host = lambda a: a.detach().cpu().to(torch.float64).numpy()
    return PWLRef(host(f.xs[:m]), host(f.ys[:m]), float(f.sl), float(f.sr))
