"""seamless-m4t-medium — encoder-decoder multimodal backbone
[arXiv:2308.11596; hf].  The audio frontend is a STUB per assignment:
input_specs() provides precomputed frame embeddings."""
from .base import ModelConfig, register


@register("seamless-m4t-medium")
def config() -> ModelConfig:
    # vocab: published 256206, padded to 256224 (a multiple of 16) as the
    # JAX package pads it for its tensor-parallel axis, so that the two
    # packages' configurations are equal field for field; the 18 pad ids
    # are never emitted as targets
    return ModelConfig(
        name="seamless-m4t-medium", n_layers=12, d_model=1024, n_heads=16,
        n_kv_heads=16, d_ff=4096, vocab=256224, head_dim=64,
        block_pattern=("attn",), mlp_kind="gelu", n_encoder_layers=12,
        frontend="audio_stub",
        notes="enc-dec; MHA (kv=16); audio frontend stubbed to frame "
              "embeddings; vocab padded 256206->256224 for 16-way TP.")
