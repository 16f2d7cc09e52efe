"""dbrx-132b — fine-grained MoE 16 experts top-4 [hf:databricks/dbrx-base;
unverified]."""
from .base import ModelConfig, MoEConfig, register


@register("dbrx-132b")
def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=10752, vocab=100352, head_dim=128,
        block_pattern=("attn",), mlp_kind="swiglu",
        moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
        rope_theta=500_000.0,
        notes="16 experts top-4, fine-grained MoE; GQA kv=8.")
