"""qwen3-0.6b — dense GQA transformer with qk_norm [hf:Qwen/Qwen3-8B; hf]."""
from .base import ModelConfig, register


@register("qwen3-0.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16,
        n_kv_heads=8, d_ff=3072, vocab=151936, head_dim=128,
        block_pattern=("attn",), mlp_kind="swiglu", qk_norm=True,
        rope_theta=1_000_000.0,
        notes="qk_norm per head; GQA kv=8.")
