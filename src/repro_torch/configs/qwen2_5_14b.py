"""qwen2.5-14b — dense GQA transformer, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""
from .base import ModelConfig, register


@register("qwen2.5-14b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=13824, vocab=152064, head_dim=128,
        block_pattern=("attn",), mlp_kind="swiglu", qkv_bias=True,
        rope_theta=1_000_000.0,
        notes="GQA kv=8 with QKV bias.")
