"""recurrentgemma-2b: RG-LRU + local attention, 2:1 hybrid
[arXiv:2402.19427; hf]."""
from .base import ModelConfig, RecurrentConfig, register


@register("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", n_layers=26, d_model=2560, n_heads=10,
        n_kv_heads=1, d_ff=7680, vocab=256000, head_dim=256,
        # Griffin pattern: two RG-LRU blocks then one local-attention block
        block_pattern=("rglru", "rglru", "local"),
        mlp_kind="gelu",  # GeGLU in the paper; gated gelu here
        recurrent=RecurrentConfig(lru_width=2560, d_conv=4),
        local_window=2048,
        notes="sub-quadratic: linear recurrence + windowed attention")
