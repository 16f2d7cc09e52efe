"""Exact piecewise-linear (PWL) function algebra — NumPy reference oracle.

The port's own copy of the JAX package's ``core/pwl_ref.py`` (numpy
only, the same code), so that the port holds its PWL algebra to the
paper's exact algorithm without importing the JAX package.

This is the ground-truth implementation of the function algebra that the
Roux–Zastawniak (2009) pricing algorithms operate on.  Every function is a
continuous piecewise-linear map ``f: R -> R`` represented by

  * ``xs``  — sorted knot abscissae, shape (m,), m >= 1
  * ``ys``  — knot values f(xs), shape (m,)
  * ``s_left``  — slope on (-inf, xs[0]]
  * ``s_right`` — slope on [xs[-1], +inf)

Interior slopes are implied by the knots.  Knot *values* (not an anchored
integral) are stored so repeated operations do not accumulate drift.

The operations required by the pricing recursion are

  * pointwise ``maximum`` / ``minimum`` of two PWL functions,
  * positive affine rescaling (discounting),
  * ``cone_infconv`` — the transaction-cost slope restriction
    ``v(y) = min_{y'} [ f(y') + c(y' - y) ]`` with the rebalancing cost
    ``c(d) = max(a*d, b*d)``, ``a >= b > 0`` (ask/bid prices of the stock).

All of these return exact results (up to float64 rounding); the fixed
capacity PyTorch algebra in :mod:`repro_torch.core.pwl` is validated
against this oracle by the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

__all__ = ["PWLRef", "expense_function", "pwl_max", "pwl_min", "cone_infconv"]

# Relative tolerances.  Slopes here are stock prices (~1e2); absolute 1e-12
# comparisons would treat float-noise slope differences as genuine kinks and
# the knot count then cascades multiplicatively through the recursion (seen
# experimentally: >1000 knots at N=25 vs the true handful).  All slope
# equality checks are therefore relative.
_REL = 1e-9


def _slope_close(sa: float, sb: float) -> bool:
    return abs(sa - sb) <= _REL * (1.0 + max(abs(sa), abs(sb)))


@dataclasses.dataclass
class PWLRef:
    xs: np.ndarray      # (m,) sorted knots
    ys: np.ndarray      # (m,) values at knots
    s_left: float       # slope left of xs[0]
    s_right: float      # slope right of xs[-1]

    # ------------------------------------------------------------------ #
    # construction helpers
    # ------------------------------------------------------------------ #
    def __post_init__(self) -> None:
        self.xs = np.asarray(self.xs, dtype=np.float64)
        self.ys = np.asarray(self.ys, dtype=np.float64)
        if self.xs.ndim != 1 or self.xs.shape != self.ys.shape or self.xs.size < 1:
            raise ValueError("xs/ys must be 1-D, same shape, size >= 1")
        if np.any(np.diff(self.xs) < 0):
            raise ValueError("xs must be sorted")
        self.s_left = float(self.s_left)
        self.s_right = float(self.s_right)

    @staticmethod
    def affine(slope: float, value_at_0: float) -> "PWLRef":
        return PWLRef(np.array([0.0]), np.array([float(value_at_0)]), slope, slope)

    @staticmethod
    def from_slopes(breaks: Iterable[float], slopes: Iterable[float],
                    value_at_0: float) -> "PWLRef":
        """Build from breakpoints (len m) and slopes (len m+1) and f(0)."""
        breaks = np.asarray(list(breaks), dtype=np.float64)
        slopes = np.asarray(list(slopes), dtype=np.float64)
        if breaks.size == 0:
            return PWLRef.affine(float(slopes[0]), value_at_0)
        if slopes.size != breaks.size + 1:
            raise ValueError("need len(slopes) == len(breaks) + 1")
        # integrate the slope step function from 0 to each knot to get values;
        # if y < 0 the sum of slope*(bb-aa) over [y, 0] equals f(0) - f(y).
        ys = np.empty_like(breaks)

        def _eval2(y: float) -> float:
            lo, hi = (0.0, y) if y >= 0 else (y, 0.0)
            cuts = np.unique(np.clip(breaks, lo, hi))
            cuts = np.concatenate([[lo], cuts, [hi]])
            total = 0.0
            for aa, bb in zip(cuts[:-1], cuts[1:]):
                if bb <= aa:
                    continue
                mid = 0.5 * (aa + bb)
                k = int(np.searchsorted(breaks, mid, side="right"))
                total += slopes[k] * (bb - aa)
            return value_at_0 + total if y >= 0 else value_at_0 - total
        for i, x in enumerate(breaks):
            ys[i] = _eval2(float(x))
        return PWLRef(breaks, ys, float(slopes[0]), float(slopes[-1])).compress()

    # ------------------------------------------------------------------ #
    # basic queries
    # ------------------------------------------------------------------ #
    @property
    def m(self) -> int:
        return int(self.xs.size)

    def slopes(self) -> np.ndarray:
        """All m+1 slopes, left to right."""
        if self.m == 1:
            return np.array([self.s_left, self.s_right])
        interior = np.diff(self.ys) / np.diff(self.xs)
        return np.concatenate([[self.s_left], interior, [self.s_right]])

    def __call__(self, y):
        y = np.asarray(y, dtype=np.float64)
        out = np.interp(y, self.xs, self.ys)
        left = y < self.xs[0]
        right = y > self.xs[-1]
        out = np.where(left, self.ys[0] + self.s_left * (y - self.xs[0]), out)
        out = np.where(right, self.ys[-1] + self.s_right * (y - self.xs[-1]), out)
        return out if out.ndim else float(out)

    def is_convex(self, tol: float = 1e-9) -> bool:
        s = self.slopes()
        return bool(np.all(np.diff(s) >= -tol))

    # ------------------------------------------------------------------ #
    # transforms
    # ------------------------------------------------------------------ #
    def scale(self, alpha: float) -> "PWLRef":
        """alpha * f, alpha > 0."""
        if alpha <= 0:
            raise ValueError("alpha must be > 0")
        return PWLRef(self.xs, alpha * self.ys, alpha * self.s_left,
                      alpha * self.s_right)

    def add_const(self, c: float) -> "PWLRef":
        return PWLRef(self.xs, self.ys + c, self.s_left, self.s_right)

    def neg(self) -> "PWLRef":
        return PWLRef(self.xs, -self.ys, -self.s_left, -self.s_right)

    def compress(self, tol: float | None = None) -> "PWLRef":
        """Drop knots whose removal leaves the function (numerically) unchanged.

        Uses a *relative* slope tolerance by default; also merges knots that
        coincide up to relative spacing (crossing-insertion float noise).
        """
        xs, ys = self.xs, self.ys
        # 1) merge (near-)duplicate knots, keeping the first
        if xs.size > 1:
            span = 1.0 + np.abs(xs[:-1])
            dup = np.diff(xs) <= _REL * span
            keep = np.concatenate([[True], ~dup])
            xs, ys = xs[keep], ys[keep]
        if xs.size <= 1:
            return PWLRef(xs, ys, self.s_left, self.s_right)
        # 2) drop knots with no genuine slope change
        tmp = PWLRef(xs, ys, self.s_left, self.s_right)
        s = tmp.slopes()
        if tol is None:
            scale = 1.0 + np.maximum(np.abs(s[:-1]), np.abs(s[1:]))
            keep = np.abs(np.diff(s)) > _REL * scale
        else:
            keep = np.abs(np.diff(s)) > tol
        if not np.any(keep):
            # fully affine: keep a single anchor knot
            return PWLRef(xs[:1], ys[:1], self.s_left, self.s_right)
        return PWLRef(xs[keep], ys[keep], self.s_left, self.s_right)

    # ------------------------------------------------------------------ #
    # sanity
    # ------------------------------------------------------------------ #
    def assert_finite(self) -> None:
        assert np.all(np.isfinite(self.xs)) and np.all(np.isfinite(self.ys))
        assert np.isfinite(self.s_left) and np.isfinite(self.s_right)


# ---------------------------------------------------------------------- #
# pointwise max / min
# ---------------------------------------------------------------------- #
def _envelope(f: PWLRef, g: PWLRef, take_max: bool) -> PWLRef:
    """Pointwise max (or min) of two PWL functions — exact."""
    knots = np.unique(np.concatenate([f.xs, g.xs]))
    # candidate crossing in every interval (including the two unbounded ends)
    pts = list(knots)
    edges = np.concatenate([[-np.inf], knots, [np.inf]])
    for lo, hi in zip(edges[:-1], edges[1:]):
        # slopes and values of both functions on (lo, hi)
        if np.isinf(lo) and np.isinf(hi):
            ref = 0.0
        elif np.isinf(lo):
            ref = hi - 1.0
        elif np.isinf(hi):
            ref = lo + 1.0
        else:
            if hi - lo <= _REL * (1.0 + abs(lo)):
                continue
            ref = 0.5 * (lo + hi)
        sf = _slope_at(f, ref)
        sg = _slope_at(g, ref)
        if _slope_close(sf, sg):
            continue  # (near-)parallel: crossing position is pure noise
        vf = f(ref)
        vg = g(ref)
        x_cross = ref + (vg - vf) / (sf - sg)
        margin = _REL * (1.0 + abs(x_cross))
        if lo + margin < x_cross < hi - margin:
            pts.append(x_cross)
    xs = np.unique(np.asarray(pts, dtype=np.float64))
    vf = f(xs)
    vg = g(xs)
    ys = np.maximum(vf, vg) if take_max else np.minimum(vf, vg)
    # end slopes: evaluate beyond the outermost knots
    probe_l = xs[0] - 1.0
    probe_r = xs[-1] + 1.0
    fl, gl = f(probe_l), g(probe_l)
    fr, gr = f(probe_r), g(probe_r)
    if take_max:
        s_left = f.s_left if fl >= gl else g.s_left
        s_right = f.s_right if fr >= gr else g.s_right
    else:
        s_left = f.s_left if fl <= gl else g.s_left
        s_right = f.s_right if fr <= gr else g.s_right
    return PWLRef(xs, ys, s_left, s_right).compress()


def _slope_at(f: PWLRef, y: float) -> float:
    """Slope of f at a non-knot point y."""
    if y < f.xs[0]:
        return f.s_left
    if y > f.xs[-1]:
        return f.s_right
    i = int(np.searchsorted(f.xs, y, side="right"))
    if i >= f.m:
        return f.s_right
    if i == 0:
        return f.s_left
    return float((f.ys[i] - f.ys[i - 1]) / (f.xs[i] - f.xs[i - 1]))


def pwl_max(f: PWLRef, g: PWLRef) -> PWLRef:
    return _envelope(f, g, take_max=True)


def pwl_min(f: PWLRef, g: PWLRef) -> PWLRef:
    return _envelope(f, g, take_max=False)


# ---------------------------------------------------------------------- #
# transaction-cost slope restriction (inf-convolution with the cost cone)
# ---------------------------------------------------------------------- #
def cone_infconv(f: PWLRef, a: float, b: float) -> PWLRef:
    """v(y) = min_{y'} [ f(y') + c(y' - y) ],  c(d) = max(a d, b d), a >= b.

    Financially: the least cash needed at stock holding ``y`` so that after a
    single rebalancing trade (buy at ask ``a``, sell at bid ``b``) the
    portfolio lands in the epigraph of ``f``.  For convex ``f`` this equals
    clipping the slopes of ``f`` to ``[-a, -b]``; this implementation is the
    general (also non-convex) exact form:

      the inner objective is PWL in y', so the minimiser is a knot of f or
      y' = y itself; hence
      v = min( f,  min_j V_j ),   V_j(y) = f(x_j) + c(x_j - y)

    where V_j is the convex 2-piece "V" with slopes (-a, -b) and apex at
    (x_j, f(x_j)).  Boundedness requires s_left(f) <= -b and s_right(f) >= -a.
    """
    if not (a >= b > 0 or (a == b and a > 0)):
        raise ValueError(f"need a >= b > 0, got a={a}, b={b}")
    if f.s_left > -b + 1e-9 or f.s_right < -a - 1e-9:
        raise ValueError(
            "inf-convolution unbounded below: end slopes outside [-a,-b] cone "
            f"(s_left={f.s_left}, s_right={f.s_right}, a={a}, b={b})")
    out = f
    for xj, yj in zip(f.xs, f.ys):
        if a == b:
            vj = PWLRef.affine(-a, yj + a * xj)
        else:
            vj = PWLRef(np.array([xj]), np.array([yj]), -a, -b)
        out = pwl_min(out, vj)
    return out.compress()


# ---------------------------------------------------------------------- #
# expense functions (eq. (1) and (6) of the paper)
# ---------------------------------------------------------------------- #
def expense_function(xi: float, zeta: float, s_ask: float, s_bid: float) -> PWLRef:
    """u(y) = xi + (y - zeta)^- * s_ask - (y - zeta)^+ * s_bid.

    2-piece convex PWL with slopes (-s_ask, -s_bid) and knot at zeta.
    The buyer's expense function (eq. 6) is obtained by calling this with
    (-xi, -zeta).
    """
    # value at the knot y = zeta is exactly xi
    if s_ask == s_bid:
        return PWLRef.affine(-s_ask, xi + zeta * s_ask)
    return PWLRef(np.array([zeta]), np.array([xi]), -s_ask, -s_bid)
