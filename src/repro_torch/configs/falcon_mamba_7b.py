"""falcon-mamba-7b — attention-free mamba-1 SSM [arXiv:2410.05355;
unverified]."""
from .base import ModelConfig, SSMConfig, register


@register("falcon-mamba-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", n_layers=64, d_model=4096, n_heads=1,
        n_kv_heads=1, d_ff=0, vocab=65024,
        block_pattern=("mamba",),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        notes="pure SSM; attention-free; long_500k runs.")
