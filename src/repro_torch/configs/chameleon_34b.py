"""chameleon-34b — early-fusion VQ-token VLM backbone [arXiv:2405.09818;
unverified].  VQ image tokeniser is a STUB: tokens arrive pre-quantised in
the shared vocabulary."""
from .base import ModelConfig, register


@register("chameleon-34b")
def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", n_layers=48, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=22016, vocab=65536, head_dim=128,
        block_pattern=("attn",), mlp_kind="swiglu", qk_norm=True,
        frontend="vq_stub",
        notes="early fusion: image VQ tokens share the text vocab; qk-norm "
              "(chameleon uses it for training stability).")
