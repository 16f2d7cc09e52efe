"""Tick-feed streaming repricing over a live scenario book.

The port of the JAX package's ``serve/streaming.py``.  A
:class:`StreamingBook` is a flat batch of quoted contracts ("rows") kept
live against a market-data feed: each row references an underlying id,
and a :class:`Tick` moves one underlying's spot or vol.  The grid
engines price rows as independent lanes, so a tick only invalidates the
rows of *its* underlying — the book requotes exactly those rows (grouped
into the scheduler's ``(n_steps, tc)`` buckets, padded to a power of
two) and leaves every other quote untouched.

The correctness claim is **differential equivalence**: after any tick
sequence, the incrementally maintained book equals a full reprice of
the post-tick book — prices, per-row ``max_pieces`` and OverflowError
behaviour.  The book prices through ``repro_torch.api.price_flat`` on
its ``device`` (``"cuda"`` by default; ``"cpu"`` runs the kernels' plain
versions).

:func:`synth_ticks` generates a reproducible synthetic feed; the
gateway's :meth:`~repro_torch.serve.gateway.PricingGateway.run_stream`
consumes any iterable of ticks against a book.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..core.partition import _next_pow2

__all__ = ["Tick", "synth_ticks", "StreamingBook"]

_TICK_FIELDS = ("s0", "sigma")


@dataclasses.dataclass(frozen=True)
class Tick:
    """One market-data update: ``underlying``'s ``field`` is now
    ``value`` (an absolute level, not an increment — feeds publish
    levels, and levels keep replays idempotent)."""
    underlying: int
    field: str            # "s0" | "sigma"
    value: float


def synth_ticks(n: int, *, n_underlyings: int, seed: int = 0,
                s0_range=(90.0, 112.0), sigma_range=(0.15, 0.35),
                p_sigma: float = 0.3) -> List[Tick]:
    """A reproducible synthetic tick feed: ``n`` ticks over
    ``n_underlyings`` ids, spot levels uniform in ``s0_range`` and (with
    probability ``p_sigma``) vol levels uniform in ``sigma_range``."""
    rng = np.random.default_rng(seed)
    ticks = []
    for _ in range(n):
        u = int(rng.integers(n_underlyings))
        if rng.random() < p_sigma:
            ticks.append(Tick(u, "sigma",
                              float(rng.uniform(*sigma_range))))
        else:
            ticks.append(Tick(u, "s0", float(rng.uniform(*s0_range))))
    return ticks


class StreamingBook:
    """A flat batch of live-quoted contracts over shared underlyings.

    Row ``i``'s inputs live in parallel arrays (``s0``, ``sigma``,
    ``rate``, ``maturity``, ``cost_rate``, ``payoff``, ``strike``,
    ``strike2``, ``n_steps``, ``underlying``); its current quote in
    ``ask``/``bid``/``row_pieces`` (NaN / -1 until first priced).
    ``moneyness`` and ``vol_scale`` map an underlying's ticked level to
    the row (``s0 = level * moneyness`` — rows quoting the same
    underlying at offsets stay consistent under one tick).
    """

    def __init__(self, *, underlying, s0, sigma, rate, maturity, cost_rate,
                 payoff, strike, strike2, n_steps, moneyness=None,
                 vol_scale=None, capacity: int = 48, backend: str = "kernel",
                 device: str = "cuda"):
        self.underlying = np.asarray(underlying, dtype=int)
        n = self.underlying.shape[0]
        as_f = lambda a: np.broadcast_to(
            np.asarray(a, dtype=np.float64), (n,)).copy()
        self.s0 = as_f(s0)
        self.sigma = as_f(sigma)
        self.rate = as_f(rate)
        self.maturity = as_f(maturity)
        self.cost_rate = as_f(cost_rate)
        self.strike = as_f(strike)
        # None mirrors the service default: second strike 10 above the first
        self.strike2 = (self.strike + 10.0 if strike2 is None
                        else as_f(strike2))
        self.payoff = np.broadcast_to(np.asarray(payoff, dtype=object),
                                      (n,)).copy()
        self.n_steps = np.broadcast_to(np.asarray(n_steps, dtype=int),
                                       (n,)).copy()
        self.moneyness = as_f(1.0 if moneyness is None else moneyness)
        self.vol_scale = as_f(1.0 if vol_scale is None else vol_scale)
        self.capacity = int(capacity)
        self.backend = backend
        self.device = str(device)
        self.ask = np.full(n, np.nan)
        self.bid = np.full(n, np.nan)
        self.row_pieces = np.full(n, -1, dtype=int)

    # a book is driven by exactly one stream consumer (run_stream on the
    # gateway's event loop) — owner-confined
    GUARDED_BY = {
        "s0": "owner", "sigma": "owner", "ask": "owner", "bid": "owner",
        "row_pieces": "owner",
    }

    # ------------------------------------------------------------------ #
    # construction helpers
    # ------------------------------------------------------------------ #
    @classmethod
    def mixed(cls, *, n_underlyings: int = 2, per_underlying: int = 6,
              n_steps: Sequence[int] = (6, 8),
              cost_rates: Sequence[float] = (0.0, 0.01),
              sigma0: float = 0.2, capacity: int = 48,
              backend: str = "kernel",
              device: str = "cuda") -> "StreamingBook":
        """A mixed book: every underlying quotes a cycle of payoff
        families x strikes x cost rates x tree depths — the
        heterogeneity of the paper's 108-scenario grid, as a flat
        streaming batch."""
        families = ("put", "call", "bull_spread")
        strikes = (90.0, 95.0, 100.0, 105.0, 110.0)
        rows: dict = {k: [] for k in ("underlying", "s0", "sigma",
                                      "cost_rate", "payoff", "strike",
                                      "n_steps")}
        for u in range(n_underlyings):
            for j in range(per_underlying):
                rows["underlying"].append(u)
                rows["s0"].append(100.0 + u)
                rows["sigma"].append(sigma0 + 0.02 * u)
                rows["cost_rate"].append(cost_rates[j % len(cost_rates)])
                rows["payoff"].append(families[j % len(families)])
                rows["strike"].append(strikes[j % len(strikes)])
                rows["n_steps"].append(int(n_steps[j % len(n_steps)]))
        return cls(rate=0.05, maturity=0.5, strike2=None,
                   capacity=capacity, backend=backend, device=device, **rows)

    @property
    def n_rows(self) -> int:
        return self.underlying.shape[0]

    @property
    def max_pieces(self) -> int:
        """Book-wide peak PWL knot count over priced rows — exactly what
        a full reprice of the current book would report."""
        priced = self.row_pieces[self.row_pieces >= 0]
        return int(priced.max()) if priced.size else 0

    def copy(self) -> "StreamingBook":
        """Independent snapshot (inputs and quotes) — the differential
        tests full-reprice a copy and diff it against the original."""
        out = StreamingBook(
            underlying=self.underlying, s0=self.s0, sigma=self.sigma,
            rate=self.rate, maturity=self.maturity,
            cost_rate=self.cost_rate, payoff=self.payoff,
            strike=self.strike, strike2=self.strike2, n_steps=self.n_steps,
            moneyness=self.moneyness, vol_scale=self.vol_scale,
            capacity=self.capacity, backend=self.backend, device=self.device)
        out.ask, out.bid = self.ask.copy(), self.bid.copy()
        out.row_pieces = self.row_pieces.copy()
        return out

    # ------------------------------------------------------------------ #
    # the feed side
    # ------------------------------------------------------------------ #
    def apply(self, tick: Tick) -> np.ndarray:
        """Fold one tick into the inputs; returns the indices of the rows
        it touched (the rows whose quotes are now stale)."""
        if tick.field not in _TICK_FIELDS:
            raise ValueError(f"unknown tick field {tick.field!r}; "
                             f"supported: {_TICK_FIELDS}")
        idx = np.nonzero(self.underlying == tick.underlying)[0]
        if tick.field == "s0":
            self.s0[idx] = tick.value * self.moneyness[idx]
        else:
            self.sigma[idx] = tick.value * self.vol_scale[idx]
        return idx

    # ------------------------------------------------------------------ #
    # the pricing side
    # ------------------------------------------------------------------ #
    def to_requests(self, idx) -> list:
        """The touched rows as PriceRequests (the gateway's streaming
        path submits these through the ordinary intake)."""
        from .engine import PriceRequest
        return [PriceRequest(
            s0=float(self.s0[i]), sigma=float(self.sigma[i]),
            rate=float(self.rate[i]), maturity=float(self.maturity[i]),
            cost_rate=float(self.cost_rate[i]),
            payoff=str(self.payoff[i]), strike=float(self.strike[i]),
            strike2=float(self.strike2[i]), n_steps=int(self.n_steps[i]))
            for i in np.asarray(idx, dtype=int)]

    def apply_quotes(self, idx, quotes) -> None:
        """Write delivered quotes back onto the touched rows."""
        for i, q in zip(np.asarray(idx, dtype=int), quotes):
            self.ask[i] = q.ask
            self.bid[i] = q.bid
            self.row_pieces[i] = q.max_pieces

    def requote(self, idx, pricer: Optional[Callable] = None) -> None:
        """Reprice exactly the rows in ``idx``, in place.

        Rows group into the serving buckets ``(n_steps, cost_rate>0)``
        and each group prices as one padded flat batch through
        ``pricer`` (default :func:`repro_torch.api.price_flat`) with the
        book's backend and device.  Raises
        ``OverflowError`` if any touched row needs more than
        ``capacity`` PWL knots — identical to a full reprice, because
        untouched rows already priced within budget.
        """
        if pricer is None:
            from ..api import price_flat
            pricer = price_flat
        from ..configs.pricing import ExecutionConfig
        from .core import port_backend
        idx = np.asarray(idx, dtype=int)
        buckets: dict = {}
        for i in idx:
            buckets.setdefault(
                (int(self.n_steps[i]), self.cost_rate[i] > 0.0),
                []).append(int(i))
        for (n_steps, _), rows in sorted(buckets.items()):
            rows = np.asarray(rows, dtype=int)
            res = pricer(
                s0=self.s0[rows], sigma=self.sigma[rows],
                rate=self.rate[rows], maturity=self.maturity[rows],
                cost_rate=self.cost_rate[rows],
                payoff=tuple(self.payoff[rows]),
                strike=self.strike[rows], strike2=self.strike2[rows],
                n_steps=n_steps, capacity=self.capacity,
                execution=ExecutionConfig(
                    backend=port_backend(self.backend), device=self.device),
                pad_to=_next_pow2(len(rows)))
            n = len(rows)
            self.ask[rows] = np.asarray(res.ask).ravel()[:n]
            self.bid[rows] = np.asarray(res.bid).ravel()[:n]
            rp = res.row_pieces
            self.row_pieces[rows] = (
                np.zeros(n, dtype=int) if rp is None
                else np.asarray(rp).ravel()[:n].astype(int))

    def full_reprice(self, pricer: Optional[Callable] = None) -> None:
        """Reprice every row (the reference the differential tests
        compare the incremental path against)."""
        self.requote(np.arange(self.n_rows), pricer)
