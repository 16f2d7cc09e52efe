"""llama4-scout-17b-16e — MoE 16 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from .base import ModelConfig, MoEConfig, register


@register("llama4-scout-17b-a16e")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=8192, vocab=202048, head_dim=128,
        block_pattern=("attn",), mlp_kind="swiglu",
        moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192,
                      shared_expert=True),
        rope_theta=500_000.0,
        notes="MoE top-1 of 16 routed + shared expert (llama4 style); "
              "early-fusion multimodal — text backbone per assignment.")
