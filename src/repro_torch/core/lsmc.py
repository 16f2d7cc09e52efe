"""Least-squares Monte Carlo (Longstaff–Schwartz) Bermudan engine.

The port of the JAX package's ``core/lsmc.py``: the engine for what the
lattice cannot shape, ``d > 1`` underlyings (an arithmetic basket) and
Bermudan exercise schedules.  ``d = n_assets`` independent GBMs share the
row's ``(s0, sigma, rate)``; the 4-parameter payoff family applies to the
basket mean.  The continuation value is fit at each exercise date by
ridge-regularised normal equations over the in-the-money paths only,
in a polynomial or Laguerre basis of the moneyness ``b / K1``.  Step 0,
where the basket is ``s0`` exactly, is exercised deterministically.  The
output of a row is its price and the Monte Carlo standard error
(antithetic pairs, ``ddof=1``); under ``cost_rate = λ > 0`` the engine
quotes the premium convention ``ask = (1+λ)·P``, ``bid = (1−λ)·P``.

No TPU kernel stands behind this engine (the JAX package runs it as
plain ``jax.numpy``), so its port is plain PyTorch, batched over rows
where JAX vmapped.

Random numbers
--------------
PyTorch cannot reproduce JAX's threefry draws.  What the port keeps is
the property that makes results independent of the layout: row ``i``'s
normals depend only on ``(seed, i)`` and the static shape.
:func:`path_seeds` (the counterpart of JAX's ``path_keys``) mixes
``seed`` and the row index with SplitMix64 on the host into one integer
a row; that integer seeds a ``torch.Generator`` on the row's device and
travels as row data through the shard layout, so a padded or sharded
row draws exactly what it draws alone.  CPU and CUDA generators give
different normals for one seed, so the CPU tests hold the estimator on
JAX's own normals (``z=``) and the sampler statistically, and the card
holds the layout bit-equality.

Rows run in chunks of a fixed size that depends only on the static shape
(:func:`chunk_rows`), the last chunk padded: every row meets the same
tensor shapes whatever the batch, so batched products, solves and
reductions take the same path for it in every layout.  The chunk also
bounds memory.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from .device import DEFAULT_DTYPE

__all__ = ["LSMC_BASES", "exercise_schedule", "path_seeds", "chunk_rows",
           "basis_matrix", "simulate_basket", "lsmc_rows"]

LSMC_BASES = ("poly", "laguerre")

# ridge added to the (moneyness-normalised) Gram matrix so an all-OTM
# date — a singular regression — degrades to beta = 0 instead of NaN
_RIDGE = 1e-10

# a chunk's (rows, paths, dates, assets) float64 array stays within this
_CHUNK_BYTES = 1 << 28
_MAX_CHUNK = 8

_MASK64 = (1 << 64) - 1


def exercise_schedule(n_steps: int, exercise_steps: Optional[Sequence[int]]
                      ) -> Tuple[int, ...]:
    """Normalise a Bermudan schedule to an ascending tuple of step indices.

    ``None`` means American-on-the-lattice-clock: every step ``0..N``.
    An explicit schedule must stay within ``0..N`` and **include the
    terminal step** ``N``.
    """
    if exercise_steps is None:
        return tuple(range(n_steps + 1))
    steps = tuple(sorted({int(s) for s in exercise_steps}))
    if not steps:
        raise ValueError("exercise_steps must not be empty")
    if steps[0] < 0 or steps[-1] > n_steps:
        raise ValueError(f"exercise_steps {steps} outside 0..{n_steps}")
    if steps[-1] != n_steps:
        raise ValueError(
            f"exercise_steps must include the terminal step {n_steps} "
            f"(got {steps})")
    return steps


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def path_seeds(seed: int, n_rows: int) -> torch.Tensor:
    """Per-row generator seeds, derived from ``seed`` by **row index**.

    An ``(n_rows,)`` int64 tensor on the CPU: row ``i`` gets
    ``SplitMix64(SplitMix64(seed) ^ i)`` (63 bits), whatever the batch.
    The seeds travel as row data through the gather/pad shard layout,
    which is why sharded and padded results are bit-equal to the
    single-device call.
    """
    base = _splitmix64(int(seed) & _MASK64)
    return torch.tensor([_splitmix64(base ^ i) >> 1 for i in range(n_rows)],
                        dtype=torch.int64)


def chunk_rows(n_paths: int, n_sim: int, n_assets: int) -> int:
    """Rows priced together: as many as keep one ``(rows, n_paths, n_sim,
    n_assets)`` float64 array within 256 MiB, at most 8.  A function of
    the static shape only, never of the batch."""
    row = 8 * int(n_paths) * max(int(n_sim), 1) * max(int(n_assets), 1)
    return max(1, min(_MAX_CHUNK, _CHUNK_BYTES // row))


def basis_matrix(x: torch.Tensor, degree: int, kind: str) -> torch.Tensor:
    """Regression design matrix over the moneyness ``x``: ``(..., degree+1)``.

    ``kind="poly"``: monomials ``1, x, ..., x^degree``;
    ``kind="laguerre"``: Laguerre polynomials ``L_0..L_degree`` by the
    three-term recurrence.
    """
    if degree < 0:
        raise ValueError("need degree >= 0")
    if kind == "poly":
        cols = [torch.ones_like(x)]
        for _ in range(1, degree + 1):
            cols.append(cols[-1] * x)
    elif kind == "laguerre":
        cols = [torch.ones_like(x)]
        if degree >= 1:
            cols.append(1.0 - x)
        for k in range(1, degree):
            cols.append(((2 * k + 1 - x) * cols[-1] - k * cols[-2])
                        / (k + 1))
    else:
        raise ValueError(f"unknown basis {kind!r}; use one of {LSMC_BASES}")
    return torch.stack(cols, dim=-1)


def _normals(seeds: torch.Tensor, shape, device) -> torch.Tensor:
    """``(rows,) + shape`` standard normals, row ``i`` drawn by a
    generator on ``device`` seeded with ``seeds[i]``."""
    out = []
    for s in seeds.tolist():
        g = torch.Generator(device=device)
        g.manual_seed(int(s))
        out.append(torch.randn(shape, generator=g, dtype=DEFAULT_DTYPE,
                               device=device))
    return torch.stack(out)


def simulate_basket(s0, sigma, rate, maturity, *, n_steps: int,
                    steps: Tuple[int, ...], n_paths: int, n_assets: int,
                    antithetic: bool, seeds: Optional[torch.Tensor] = None,
                    z: Optional[torch.Tensor] = None):
    """Antithetic GBM basket paths of ``(rows,)`` contracts at the
    schedule's positive steps.

    Returns ``(b, t)``: ``b`` the arithmetic basket mean ``(rows,
    n_paths, n_sim)``, ``t`` the year fractions ``(rows, n_sim)``.  The
    normals are ``z`` ``(rows, m, n_sim, n_assets)`` when given (``m =
    n_paths // 2`` with ``antithetic``, else ``n_paths``), else drawn from
    ``seeds``.  With ``antithetic`` the first ``m`` paths use ``+Z`` and
    the second ``m`` use ``-Z``.
    """
    sim = tuple(s for s in steps if s > 0)
    if not sim:
        raise ValueError("schedule has no positive step to simulate")
    if antithetic and n_paths % 2:
        raise ValueError("antithetic sampling needs an even n_paths")
    m = n_paths // 2 if antithetic else n_paths
    shape = (m, len(sim), n_assets)
    if z is None:
        z = _normals(seeds, shape, s0.device)
    elif tuple(z.shape[1:]) != shape:
        raise ValueError(f"z has shape {tuple(z.shape)}, need (rows,) + "
                         f"{shape}")
    frac = torch.tensor(sim, dtype=DEFAULT_DTYPE, device=s0.device) / n_steps
    t = maturity[:, None] * frac                              # (R, n_sim)
    dts = torch.diff(t, dim=1, prepend=torch.zeros_like(t[:, :1]))
    if antithetic:
        z = torch.cat([z, -z], dim=1)
    drift = (rate - 0.5 * sigma * sigma)[:, None] * dts
    shock = sigma[:, None] * torch.sqrt(dts)
    logs = torch.cumsum(drift[:, None, :, None]
                        + shock[:, None, :, None] * z, dim=2)
    b = torch.mean(s0[:, None, None, None] * torch.exp(logs), dim=3)
    return b, t


def _payoff_pos(b, alpha, zeta, w1, w2, k1, k2):
    """Intrinsic value of the 4-parameter payoff family, floored at 0."""
    pay = (alpha * k1 + w1 * torch.clamp_min(b - k1, 0.0)
           + w2 * torch.clamp_min(b - k2, 0.0) + zeta * b)
    return torch.clamp_min(pay, 0.0)


def _lsmc_chunk(s0, sigma, rate, maturity, k, alpha, zeta, w1, w2, k1, k2,
                *, seeds, z, n_steps: int, steps: Tuple[int, ...],
                n_paths: int, n_assets: int, degree: int, basis: str,
                antithetic: bool):
    """One chunk of rows -> (ask, bid, stderr), each ``(rows,)``: the
    backward regression of JAX's ``_lsmc_row``, batched over rows."""
    b, t = simulate_basket(s0, sigma, rate, maturity, n_steps=n_steps,
                           steps=steps, n_paths=n_paths, n_assets=n_assets,
                           antithetic=antithetic, seeds=seeds, z=z)
    P = b.shape[1]
    c = lambda a: a[:, None, None]
    h = _payoff_pos(b, c(alpha), c(zeta), c(w1), c(w2), c(k1), c(k2))
    v = h[:, :, -1]
    # moneyness scale: strike-normalised so the Gram matrix is O(1)
    scale = torch.where(k1 > 0.0, k1, torch.where(s0 > 0.0, s0, 1.0))
    n_sim = b.shape[2]
    if n_sim > 1:
        df_step = torch.exp(-rate[:, None] * torch.diff(t, dim=1))
        eye = _RIDGE * torch.eye(degree + 1, dtype=b.dtype, device=b.device)
        for j in range(n_sim - 2, -1, -1):
            hj = h[:, :, j]
            v = v * df_step[:, j, None]
            phi = basis_matrix(b[:, :, j] / scale[:, None], degree, basis)
            itm = hj > 0.0
            a = phi * itm[..., None]
            at = a.transpose(1, 2)
            gram = at @ a / P + eye
            rhs = at @ (v * itm)[..., None] / P
            # the ridge keeps the Gram matrix positive definite; no error
            # check, as JAX's jnp.linalg.solve makes none, so no date
            # waits for the card
            beta = torch.linalg.solve_ex(gram, rhs)[0]
            cont = (phi @ beta)[..., 0]
            v = torch.where(itm & (hj > cont), hj, v)
    v = v * torch.exp(-rate * t[:, 0])[:, None]               # first date -> 0
    if antithetic:
        m = P // 2
        pair = 0.5 * (v[:, :m] + v[:, m:])
        price = torch.mean(pair, dim=1)
        se = torch.std(pair, dim=1, correction=1) / math.sqrt(1.0 * m)
    else:
        price = torch.mean(v, dim=1)
        se = torch.std(v, dim=1, correction=1) / math.sqrt(1.0 * P)
    if steps[0] == 0:
        # exercise at t=0 is deterministic: the basket is s0 exactly
        price = torch.maximum(_payoff_pos(s0, alpha, zeta, w1, w2, k1, k2),
                              price)
    # premium convention for cost_rate > 0; the stderr is the
    # frictionless estimate's
    return (1.0 + k) * price, (1.0 - k) * price, se


def lsmc_rows(s0, sigma, rate, maturity, k, alpha, zeta, w1, w2, k1, k2,
              seeds, *, n_steps: int, steps: Tuple[int, ...], n_paths: int,
              n_assets: int, degree: int, basis: str, antithetic: bool,
              z: Optional[torch.Tensor] = None):
    """Flat-batch LSMC: equal-length row tensors in, ``(ask, bid,
    stderr)`` rows out.

    The shardable unit, like ``scenarios._rz_rows``.  ``seeds`` is the
    per-row seed column (:func:`path_seeds`); ``z`` (``(rows, m, n_sim,
    n_assets)``) replaces the draws, as the tests feed in JAX's normals.
    Rows run in chunks of :func:`chunk_rows`, the last padded by
    repeating its last row.
    """
    cols = (s0, sigma, rate, maturity, k, alpha, zeta, w1, w2, k1, k2)
    R = s0.shape[0]
    n_sim = sum(1 for s in steps if s > 0)
    C = chunk_rows(n_paths, n_sim, n_assets)
    static = dict(n_steps=n_steps, steps=steps, n_paths=n_paths,
                  n_assets=n_assets, degree=degree, basis=basis,
                  antithetic=antithetic)
    outs = []
    # the padded row order, built once on each device it indexes (no
    # host-to-device copy a chunk)
    n_pad = -(-R // C) * C
    order = {}

    def take(a, lo):
        if a is None:
            return None
        if a.device not in order:
            order[a.device] = torch.arange(n_pad, device=a.device
                                           ).clamp_max(R - 1)
        return a[order[a.device][lo:lo + C]]

    for lo in range(0, R, C):
        outs.append(_lsmc_chunk(*(take(a, lo) for a in cols),
                                seeds=take(seeds, lo), z=take(z, lo),
                                **static))
    return tuple(torch.cat([o[i] for o in outs])[:R] for i in range(3))
