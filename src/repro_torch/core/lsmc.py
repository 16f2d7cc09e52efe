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
The port draws the JAX package's own normals.  :func:`path_keys` gives
row ``i`` the key ``fold_in(PRNGKey(seed), i)``, as JAX's ``path_keys``
does, and :func:`normals` computes ``jax.random.normal(key, (m, n_sim,
n_assets), float64)`` for every row of a chunk at once, in plain
PyTorch on the rows' device: threefry2x32 (20 rounds) over the flat
element index (JAX's default ``jax_threefry_partitionable``
counters), the 64 bits' top 52 as a float64 mantissa in ``[1, 2)``,
shifted to a uniform in ``(-1, 1)``, then ``sqrt(2) * erfinv``.  The
32-bit words live in int64 tensors, masked after every add and shift.
The keys, ``uint32`` bits bit-equal to JAX's, and the uniforms are
exact; ``torch.erfinv`` differs from XLA's ``erf_inv`` by up to 2.4e-13
of the value (1.1e-12 at ``|z|`` of about 4.7), so the prices agree
with JAX's within the tests' 1e-9.  A key is row data: it travels with its row through the
gather/pad shard layout, so a padded or sharded row draws exactly what
it draws alone, on the host and on the card alike.

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

__all__ = ["LSMC_BASES", "exercise_schedule", "path_keys", "threefry2x32",
           "uniforms", "normals", "chunk_rows", "basis_matrix",
           "simulate_basket", "lsmc_rows"]

LSMC_BASES = ("poly", "laguerre")

# ridge added to the (moneyness-normalised) Gram matrix so an all-OTM
# date — a singular regression — degrades to beta = 0 instead of NaN
_RIDGE = 1e-10

# a chunk's (rows, paths, dates, assets) float64 array stays within this
_CHUNK_BYTES = 1 << 28
_MAX_CHUNK = 8

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
# threefry2x32's rotations, alternating by group of four rounds, and its
# key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# float64: 52 mantissa bits; the bits of 1.0; the uniform's lower end,
# nextafter(-1, 0), as JAX's normal takes it
_MANT_SHIFT = 12
_ONE_BITS = 0x3FF0000000000000
_U_LO = math.nextafter(-1.0, 0.0)


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


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    the key ``(k0, k1)``: int64 tensors (or ints) holding values in
    ``[0, 2^32)``, broadcast together.  Returns the two output words."""
    k0, k1, x0, x1 = (torch.as_tensor(a, dtype=torch.int64)
                      for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    # fresh tensors of the broadcast shape, updated in place from here
    x0, x1 = (a & _M32 for a in torch.broadcast_tensors(x0 + k0, x1 + k1))
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            high = x1 << r
            x1.bitwise_right_shift_(32 - r).bitwise_or_(high)
            x1.bitwise_and_(_M32).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_M32)
    return x0, x1


def path_keys(seed: int, n_rows: int) -> torch.Tensor:
    """Per-row PRNG keys, derived from ``seed`` by **row index**: JAX's
    ``vmap(fold_in)(PRNGKey(seed), arange(n_rows))``.

    An ``(n_rows, 2)`` int64 tensor on the CPU holding the keys' uint32
    words.  ``PRNGKey(s)`` is ``(s >> 32, s & 0xFFFFFFFF)`` (of ``s``
    taken modulo 2^64) and ``fold_in(k, i)`` is ``threefry2x32(k, (0,
    i))``.  Row ``i`` gets the same key whatever the batch; the keys
    travel as row data through the gather/pad shard layout, which is why
    sharded and padded results are bit-equal to the single-device call.
    """
    s = int(seed) & _M64
    rows = torch.arange(int(n_rows), dtype=torch.int64)
    return torch.stack(threefry2x32(s >> 32, s & _M32, 0, rows), dim=1)


def uniforms(keys: torch.Tensor, shape) -> torch.Tensor:
    """``(rows,) + shape`` float64 uniforms in ``[nextafter(-1, 0), 1)``,
    row ``r`` those of ``jax.random.uniform(keys[r], shape, float64,
    nextafter(-1, 0), 1)`` bit for bit, all rows in one pass on the
    device of ``keys``: element ``c`` (its row-major index) takes the 64
    bits ``threefry2x32(key, (c >> 32, c & 0xFFFFFFFF))``."""
    n = math.prod(shape)
    c = torch.arange(n, dtype=torch.int64, device=keys.device)
    hi, lo = threefry2x32(keys[:, :1], keys[:, 1:], c >> 32, c & _M32)
    mant = (hi << (32 - _MANT_SHIFT)) | (lo >> _MANT_SHIFT)
    del hi, lo
    f = (mant | _ONE_BITS).view(torch.float64) - 1.0
    lo_t = torch.tensor(_U_LO, dtype=torch.float64, device=keys.device)
    f = torch.maximum(lo_t, f * (1.0 - lo_t) + lo_t)
    return f.reshape((keys.shape[0],) + tuple(shape))


def normals(keys: torch.Tensor, shape) -> torch.Tensor:
    """``(rows,) + shape`` standard normals, row ``r`` those of
    ``jax.random.normal(keys[r], shape, float64)``: ``sqrt(2) *
    erfinv(u)`` of :func:`uniforms` (``torch.erfinv`` against XLA's
    ``erf_inv``: within 2.4e-13 of the value)."""
    return math.sqrt(2.0) * torch.erfinv(uniforms(keys, shape))


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


def simulate_basket(s0, sigma, rate, maturity, *, n_steps: int,
                    steps: Tuple[int, ...], n_paths: int, n_assets: int,
                    antithetic: bool, keys: Optional[torch.Tensor] = None,
                    z: Optional[torch.Tensor] = None):
    """Antithetic GBM basket paths of ``(rows,)`` contracts at the
    schedule's positive steps.

    Returns ``(b, t)``: ``b`` the arithmetic basket mean ``(rows,
    n_paths, n_sim)``, ``t`` the year fractions ``(rows, n_sim)``.  The
    normals are ``z`` ``(rows, m, n_sim, n_assets)`` when given (``m =
    n_paths // 2`` with ``antithetic``, else ``n_paths``), else drawn from
    ``keys`` (:func:`normals`).  With ``antithetic`` the first ``m`` paths use ``+Z`` and
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
        z = normals(keys.to(s0.device), shape)
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
                *, keys, z, n_steps: int, steps: Tuple[int, ...],
                n_paths: int, n_assets: int, degree: int, basis: str,
                antithetic: bool):
    """One chunk of rows -> (ask, bid, stderr), each ``(rows,)``: the
    backward regression of JAX's ``_lsmc_row``, batched over rows."""
    b, t = simulate_basket(s0, sigma, rate, maturity, n_steps=n_steps,
                           steps=steps, n_paths=n_paths, n_assets=n_assets,
                           antithetic=antithetic, keys=keys, z=z)
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
              keys, *, n_steps: int, steps: Tuple[int, ...], n_paths: int,
              n_assets: int, degree: int, basis: str, antithetic: bool,
              z: Optional[torch.Tensor] = None):
    """Flat-batch LSMC: equal-length row tensors in, ``(ask, bid,
    stderr)`` rows out.

    The shardable unit, like ``scenarios._rz_rows``.  ``keys`` is the
    ``(rows, 2)`` per-row key column (:func:`path_keys`); ``z`` (``(rows, m, n_sim,
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
                                keys=take(keys, lo), z=take(z, lo),
                                **static))
    return tuple(torch.cat([o[i] for o in outs])[:R] for i in range(3))
