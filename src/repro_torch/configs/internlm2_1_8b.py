"""internlm2-1.8b — dense GQA transformer [arXiv:2403.17297; hf]."""
from .base import ModelConfig, register


@register("internlm2-1.8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=8, d_ff=8192, vocab=92544, head_dim=128,
        block_pattern=("attn",), mlp_kind="swiglu", rope_theta=1_000_000.0,
        notes="GQA kv=8; SwiGLU; llama-style dense decoder.")
