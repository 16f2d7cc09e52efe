"""Language-model configurations: the port's copy of the JAX package's
``configs/base.py``.

``ModelConfig`` describes one architecture; ``reduced_config`` shrinks
one for the CPU tests while keeping its family (block pattern, kinds,
flags).  The registry maps ``--arch`` ids to config factories: the
JAX package's ten architectures, every one of which the port serves.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

__all__ = [
    "MoEConfig", "SSMConfig", "RecurrentConfig", "ModelConfig",
    "register", "get_config", "list_archs", "reduced_config",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective SSM block parameters."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    """RG-LRU (recurrentgemma) block parameters."""
    lru_width: Optional[int] = None   # default d_model
    d_conv: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None            # default d_model // n_heads
    # block kinds cycled over layers: "attn", "local", "rglru", "mamba"
    block_pattern: Tuple[str, ...] = ("attn",)
    mlp_kind: str = "swiglu"                  # "swiglu" | "gelu" (gated)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    local_window: int = 2048
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    n_encoder_layers: int = 0
    frontend: str = "text"
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def lru_width(self) -> int:
        rec = self.recurrent
        return rec.lru_width if rec and rec.lru_width else self.d_model

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    def param_count(self) -> int:
        """Parameter count (embeddings + blocks), as the JAX package
        counts it."""
        d, v = self.d_model, self.vocab
        hd = self.resolved_head_dim
        total = v * d
        if not self.tie_embeddings:
            total += v * d
        if self.n_encoder_layers:
            total += v * d
        for layer in range(self.n_layers + self.n_encoder_layers):
            kind = self.block_kind(layer % self.n_layers)
            if kind in ("attn", "local"):
                total += (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                          + self.n_heads * hd * d)
            elif kind == "rglru":
                w = self.lru_width
                total += 2 * d * w + w * d + 3 * w
            elif kind == "mamba":
                di = self.ssm.expand * d
                ds = self.ssm.d_state
                dtr = self.ssm.dt_rank or -(-d // 16)
                total += d * 2 * di + di * self.ssm.d_conv
                total += di * (dtr + 2 * ds) + dtr * di + di * ds + di
                total += di * d
            if kind != "mamba":
                if self.moe is not None:
                    e = self.moe
                    total += d * e.num_experts + e.num_experts * 3 * d * e.d_ff_expert
                    if e.shared_expert:
                        total += 3 * d * self.d_ff
                elif self.d_ff:
                    total += (3 if self.mlp_kind == "swiglu" else 2) * d * self.d_ff
            total += 2 * d
        return total


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}

def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def _load_all() -> None:
    from . import (  # noqa: F401
        chameleon_34b, dbrx_132b, falcon_mamba_7b, internlm2_1_8b,
        llama4_scout_17b_a16e, qwen2_5_14b, qwen3_0_6b, qwen3_4b,
        recurrentgemma_2b, seamless_m4t_medium)


def get_config(arch_id: str) -> ModelConfig:
    _load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs() -> Tuple[str, ...]:
    """The architectures ``get_config`` builds, sorted."""
    _load_all()
    return tuple(sorted(_REGISTRY))


def reduced_config(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 64,
                   n_heads: int = 4, vocab: int = 512) -> ModelConfig:
    """Shrink a config for small runs, keeping its family, exactly as the
    JAX package's ``reduced_config`` does (window 32).  The default
    ``n_layers=2`` of a ``(rglru, rglru, local)`` pattern holds no
    local-attention layer; ``n_layers=8`` gives 2 pattern repetitions
    plus 2 remainder layers, the shape of 26 = 8 * 3 + 2."""
    kv = max(1, min(cfg.n_kv_heads, n_heads // 2)) if cfg.n_kv_heads > 1 else 1
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, num_experts=4,
                                  top_k=min(cfg.moe.top_k, 2), d_ff_expert=96)
    ssm = dataclasses.replace(cfg.ssm, d_state=8) if cfg.ssm else None
    rec = (dataclasses.replace(cfg.recurrent, lru_width=d_model)
           if cfg.recurrent else None)
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=kv, head_dim=d_model // n_heads,
        d_ff=128 if cfg.d_ff else 0, vocab=vocab, moe=moe, ssm=ssm,
        recurrent=rec, n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        local_window=32)
