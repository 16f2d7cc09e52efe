"""JAX's own bfloat16 gap between prefill(T) + decode(T) and prefill(T + 1).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_bf16_consistency_gap.py

For each architecture that ``chip_smoke.py`` serves in bfloat16, the JAX
package's reduced config (``init_lm`` at ``PRNGKey(0)``), batch 2, prompts
from a numpy seed, in two sweeps: depth (``DEPTHS`` layers at the reduced
width, prompts of ``PROMPTS`` tokens) and width (``WIDTHS``: d_model, 64
dims a head, d_ff 4 d_model, at ``WIDTH_LAYERS`` layers and the shorter
prompt).  Each run compares the last logits of ``prefill`` of T tokens followed by
``decode_step`` of token T, against ``prefill`` of T + 1 tokens, with
``RunCfg(dtype=bfloat16)`` as JAX runs it by default (compiled; flash
prefill, naive decode), and at the shallowest depth also with float32.
Prints one JSON object a line: the largest difference, the largest
|logit| and their ratio (the relative gap).

Then, for each architecture, one ``fit`` line: the power law
``relative_gap = a * layers ** alpha * (d_model / 64) ** beta``, ``a``
and ``alpha`` fitted by least squares to the log of the largest relative
gap over the prompts at each depth, ``beta`` to the log of the gap at
each width, and its value at the published depth and width.  ``chip_smoke.py``'s ``[check] <arch>
bfloat16`` bound is that value times ``BF16_GAP_MARGIN``, times the
card's own largest |logit| (PERF.md gives the readings and the margin).
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np

import repro.core  # noqa: F401  (x64: explicit dtypes below)
from repro.configs import get_config, reduced_config
from repro.models.transformer import (RunCfg, decode_step, init_lm,
                                      prefill)

ARCHS = ("chameleon-34b", "qwen2.5-14b", "qwen3-4b")
DEPTHS = (2, 4, 8, 16)
PROMPTS = (64, 256)
WIDTHS = (64, 256, 1024)
WIDTH_LAYERS = 4
B = 2


def gap(arch: str, dtype, n_layers: int, T: int, width=None) -> dict:
    cfg = reduced_config(get_config(arch), n_layers=n_layers)
    if width is not None:
        cfg = dataclasses.replace(
            reduced_config(get_config(arch), n_layers=n_layers,
                           d_model=width, n_heads=max(4, width // 64)),
            d_ff=4 * width)
    params, _ = init_lm(jax.random.PRNGKey(0), cfg)
    run = RunCfg(dtype=dtype, impl="flash")
    toks = jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, T + 1)), jnp.int32)

    @jax.jit
    def both(p, toks):
        _, cache = prefill(p, {"tokens": toks[:, :T]}, cfg, run,
                           max_len=T + 1)
        dec, _ = decode_step(p, cache, toks[:, T:], jnp.int32(T), cfg, run)
        full, _ = prefill(p, {"tokens": toks}, cfg, run)
        return dec[:, 0], full
    dec, full = (np.asarray(x, np.float64) for x in both(params, toks))
    d, top = float(np.abs(dec - full).max()), float(np.abs(full).max())
    return {"arch": arch, "dtype": jnp.dtype(dtype).name,
            "layers": n_layers, "prompt": T, "d_model": cfg.d_model,
            "d_ff": cfg.d_ff, "max_abs_gap": d,
            "max_abs_logit": top, "relative_gap": d / top}


def fit(arch: str, rows: list, wide: list) -> dict:
    """``a * layers ** alpha`` through the largest relative gap at each
    depth and ``(d_model / 64) ** beta`` through the gap at each width,
    least squares in log-log, and its value at the published size."""
    worst = {n: max(r["relative_gap"] for r in rows if r["layers"] == n)
             for n in DEPTHS}
    alpha, log_a = np.polyfit(np.log(np.array(list(worst), float)),
                              np.log(np.array(list(worst.values()))), 1)
    by_width = {r["d_model"]: r["relative_gap"] for r in wide}
    beta, _ = np.polyfit(np.log(np.array(list(by_width), float) / 64),
                         np.log(np.array(list(by_width.values()))), 1)
    full = get_config(arch)
    return {"arch": arch, "fit": "relative_gap = a * layers ** alpha * "
            "(d_model / 64) ** beta", "a": math.exp(log_a),
            "alpha": float(alpha), "beta": float(beta),
            "worst_by_layers": worst, "by_width": by_width,
            "published_layers": full.n_layers,
            "published_d_model": full.d_model,
            "at_published_size": math.exp(log_a) * full.n_layers ** alpha
            * (full.d_model / 64) ** beta}


if __name__ == "__main__":
    for arch in ARCHS:
        rows = []
        for n in DEPTHS:
            for T in PROMPTS:
                rows.append(gap(arch, jnp.bfloat16, n, T))
                print(json.dumps(rows[-1]), flush=True)
        for T in PROMPTS:
            print(json.dumps(gap(arch, jnp.float32, DEPTHS[0], T)),
                  flush=True)
        wide = []
        for w in WIDTHS:
            wide.append(gap(arch, jnp.bfloat16, WIDTH_LAYERS, PROMPTS[0],
                            width=w))
            print(json.dumps(wide[-1]), flush=True)
        print(json.dumps(fit(arch, rows, wide)), flush=True)
