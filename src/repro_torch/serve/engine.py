"""Serving engines.

Two services, as in the JAX package's ``serve/engine.py``:

1. ``PricingEngine`` — the paper's workload as a service: a batched
   option-pricing desk.  Single-contract requests (``submit`` /
   ``flush``) and whole scenario grids (``price_grid`` with a
   :class:`GridRequest`) go through the continuous-batching scheduler
   (:class:`repro_torch.serve.scheduler.PricingService`) on the card:
   requests coalesce across payoff family and strike, batches pad to
   power-of-two buckets, and ``engine="auto"`` sends frictionless
   batches to the no-TC lattice kernel instead of the Roux–Zastawniak
   one.  This class is the synchronous adapter (submit-then-flush);
   drive ``PricingService`` directly for deadline-triggered batching,
   or ``serve/gateway.py::PricingGateway`` for replicas.

2. ``LMEngine`` — LM prefill, then greedy decode over a fixed request
   batch, on the device that holds the model's weights.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.transformer import LM, RunCfg, decode_step, prefill
from .scheduler import PricingService

__all__ = ["PriceRequest", "GridRequest", "PricingEngine", "LMEngine"]


@dataclasses.dataclass
class PriceRequest:
    """One contract.  ``payoff``/``strike``/``n_steps`` left at ``None``
    take the service defaults; set per request they are *honoured* — the
    scheduler batches them as payoff-family data, so a heterogeneous
    stream still coalesces into one engine call per bucket.

    ``n_assets > 1`` (a basket) or an explicit ``exercise_steps``
    Bermudan schedule routes the request to the ``lsmc`` Monte Carlo
    engine, in buckets of their own keyed by the MC contract shape."""
    s0: float
    sigma: float
    rate: float
    maturity: float
    cost_rate: float
    payoff: Optional[str] = None
    strike: Optional[float] = None
    strike2: Optional[float] = None
    n_steps: Optional[int] = None
    n_assets: Optional[int] = None
    exercise_steps: Optional[tuple] = None


@dataclasses.dataclass
class GridRequest:
    """A scenario-grid pricing request (cartesian axes; scalars allowed).

    Each axis may be a scalar or a sequence; the engine prices the full
    cartesian product in one call (see ``repro_torch.scenarios``).
    ``backend`` takes the port's names or the JAX package's (``None`` =
    the service's); ``interpret=True`` asks for the kernels' plain
    versions on the CPU.  Fields set on ``execution``
    (:class:`repro_torch.configs.pricing.ExecutionConfig`) win over both.
    """
    s0: Any = 100.0
    sigma: Any = 0.2
    rate: Any = 0.1
    maturity: Any = 0.25
    cost_rate: Any = 0.0
    payoff: Any = "put"
    strike: Any = 100.0
    strike2: Any = None
    n_steps: int = 100
    greeks: bool = False
    backend: Optional[str] = None
    interpret: Any = None
    n_assets: int = 1            # > 1 routes the grid to the lsmc engine
    exercise_steps: Any = None   # Bermudan schedule -> lsmc engine
    execution: Any = None


class PricingEngine:
    """Synchronous batched pricing desk (adapter over ``PricingService``).

    All batching, bucketing and engine routing live in the scheduler;
    every request is priced afresh (no result cache).  ``mesh``/
    ``round_depth``/``data_axes`` are accepted for signature
    compatibility with the JAX package and dropped, as it drops them.
    ``device`` is the service's: ``"cuda"`` by default, ``"cpu"`` for
    the kernels' plain versions.
    """

    def __init__(self, mesh=None, *, n_steps: int, batch: int,
                 capacity: int = 48, round_depth: int = 8,
                 payoff: str = "put", strike: float = 100.0,
                 data_axes=("data",), device: str = "cuda"):
        del mesh, round_depth, data_axes    # scheduler path: one process
        self.batch = batch
        self.n_steps = n_steps
        self.capacity = capacity
        self.service = PricingService(
            max_batch=batch, default_n_steps=n_steps, capacity=capacity,
            default_payoff=payoff, default_strike=strike,
            result_cache_size=0,    # engine semantics: always re-price
            min_grid_bucket=batch, device=device)
        self.grid_stats: Dict[str, int] = {"grids": 0, "scenarios": 0}
        self._open: set = set()

    def submit(self, req: PriceRequest) -> int:
        rid = self.service.submit(req)
        self._open.add(rid)
        return rid

    def flush(self) -> Dict[int, Tuple[float, float]]:
        """Price all pending requests (padding each partial batch).

        Returns ``{request id: (ask, bid)}`` for every request not yet
        returned by a previous ``flush`` (full buckets may already have
        been priced inline by ``submit``'s size trigger).
        """
        self.service.flush()
        out: Dict[int, Tuple[float, float]] = {}
        for rid in sorted(self._open):
            q = self.service.result(rid)
            if q is not None:
                out[rid] = (q.ask, q.bid)
        self._open.difference_update(out)
        return out

    def price_grid(self, req: GridRequest):
        """Price a :class:`GridRequest` through the scenario batch engine
        (``engine="auto"``), padded to a power-of-two bucket; results
        are unpadded and take the grid's cartesian shape."""
        res = self.service.price_grid(req)
        self.grid_stats["grids"] += 1
        self.grid_stats["scenarios"] += res.grid.n_scenarios
        return res


class LMEngine:
    """Prefill-then-decode engine over a fixed request batch, on the
    device that holds the model's weights.

    ``timings`` holds the host-clock times of the last ``generate``:
    ``prefill_s`` up to the first token on the host (time to first
    token) and ``decode_s`` over the decode steps that follow, each of
    which ends with its token copied to the host.

    ``rules`` (JAX's): a rank mesh's ``MeshRules``.  Every rank of the
    mesh calls ``generate`` with the whole request batch; each serves
    its ``dp`` slice (``moe_dispatch`` over ``tp`` where
    ``run.moe_impl == "dispatch"``, the model holding the rank's experts)
    and the tokens are gathered over ``dp``, so every rank returns the
    whole batch's.
    """

    def __init__(self, model: LM, cfg: ModelConfig, run: RunCfg, *,
                 batch: int, max_len: int, rules=None):
        self.model = model
        self.cfg = cfg
        self.run = run
        self.batch = batch
        self.max_len = max_len
        self.rules = rules
        self.device = model.embed.device
        self.timings = {}

    def generate(self, tokens: np.ndarray, n_new: int,
                 enc_embeds: Optional[np.ndarray] = None) -> np.ndarray:
        """Greedy generation.  tokens: (B, S0) prompt; ``enc_embeds`` (B,
        S_enc, D): an encoder-decoder model's encoder input (the
        ``audio_stub`` frontend's frames), a numpy array or a tensor,
        taken in ``run.dtype``; returns (B, n_new)."""
        B, S0 = tokens.shape
        if B != self.batch or n_new < 1 or S0 + n_new > self.max_len:
            raise ValueError(f"prompt {tokens.shape} + {n_new} new tokens do "
                             f"not fit batch {self.batch}, max_len "
                             f"{self.max_len}")
        t0 = time.perf_counter()
        rows = (slice(None) if self.rules is None
                else self.rules.dp_slice(B))
        toks = torch.as_tensor(np.asarray(tokens, np.int64)[rows],
                               device=self.device)
        batch = {"tokens": toks}
        if enc_embeds is not None:
            batch["enc_embeds"] = torch.as_tensor(
                enc_embeds, device=self.device)[rows].to(self.run.dtype)
        logits, cache = prefill(self.model, batch, self.cfg, self.run,
                                max_len=self.max_len, rules=self.rules)
        tok = torch.argmax(logits, dim=-1)[:, None]
        outs = [self._gather(tok)]
        t1 = time.perf_counter()
        for i in range(n_new):
            logits, cache = decode_step(self.model, cache, tok, S0 + i,
                                        self.cfg, self.run, self.rules)
            tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
            outs.append(self._gather(tok))
        t2 = time.perf_counter()
        self.timings = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                        "decode_steps": n_new}
        # the last step's token is computed, as in the JAX engine, and dropped
        return np.stack(outs[:n_new], axis=1)

    def _gather(self, tok):
        """The step's tokens of the whole batch, on the host."""
        if self.rules is not None:
            from ..models.sharding import all_gather
            tok = all_gather(tok, self.rules.mesh, self.rules.dp)
        return tok[:, 0].cpu().numpy()
