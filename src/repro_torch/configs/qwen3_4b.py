"""qwen3-4b — dense GQA transformer with qk_norm [hf:Qwen/Qwen3-8B; hf]."""
from .base import ModelConfig, register


@register("qwen3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32,
        n_kv_heads=8, d_ff=9728, vocab=151936, head_dim=128,
        block_pattern=("attn",), mlp_kind="swiglu", qk_norm=True,
        rope_theta=1_000_000.0,
        notes="qk_norm per head; GQA kv=8.")
