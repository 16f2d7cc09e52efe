"""LM serving: prefill, then greedy decode over a fixed request batch.

The port of the JAX package's ``serve/engine.py::LMEngine``.  The
pricing service (``PricingEngine``) is not ported yet (ROADMAP
Queue A #8).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.transformer import LM, RunCfg, decode_step, prefill

__all__ = ["LMEngine"]


class LMEngine:
    """Prefill-then-decode engine over a fixed request batch, on the
    device that holds the model's weights.

    ``timings`` holds the host-clock times of the last ``generate``:
    ``prefill_s`` up to the first token on the host (time to first
    token) and ``decode_s`` over the decode steps that follow, each of
    which ends with its token copied to the host.
    """

    def __init__(self, model: LM, cfg: ModelConfig, run: RunCfg, *,
                 batch: int, max_len: int):
        self.model = model
        self.cfg = cfg
        self.run = run
        self.batch = batch
        self.max_len = max_len
        self.device = model.embed.device
        self.timings = {}

    def generate(self, tokens: np.ndarray, n_new: int) -> np.ndarray:
        """Greedy generation.  tokens: (B, S0) prompt; returns (B, n_new)."""
        B, S0 = tokens.shape
        if B != self.batch or n_new < 1 or S0 + n_new > self.max_len:
            raise ValueError(f"prompt {tokens.shape} + {n_new} new tokens do "
                             f"not fit batch {self.batch}, max_len "
                             f"{self.max_len}")
        t0 = time.perf_counter()
        toks = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
        logits, cache = prefill(self.model, {"tokens": toks}, self.cfg,
                                self.run, max_len=self.max_len)
        tok = torch.argmax(logits, dim=-1)[:, None]
        outs = [tok[:, 0].cpu().numpy()]
        t1 = time.perf_counter()
        for i in range(n_new):
            logits, cache = decode_step(self.model, cache, tok, S0 + i,
                                        self.cfg, self.run)
            tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
            outs.append(tok[:, 0].cpu().numpy())
        t2 = time.perf_counter()
        self.timings = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                        "decode_steps": n_new}
        # the last step's token is computed, as in the JAX engine, and dropped
        return np.stack(outs[:n_new], axis=1)
